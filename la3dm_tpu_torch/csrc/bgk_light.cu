// K2 — the BGK light pass with the prune, hand-written for Hopper (sm_90a).
//
// Replaces the light half of la3dm_tpu/models/bgk.py::_bgk_seq_step
// (lines 140-177: kernels/predict.py::beta_update, the node_idx_tab
// selection, the pool scatter and models/pruning.py::prune_blocks with
// posterior.BetaStateFn), for ONE scan.  The wrapper launches it once per
// scan, in scan order, on the current stream: scans are sequential because
// each scan's prune changes the eff levels the next scan reads.
//
// One thread per voxel v:
// * eff = eff[slot, v]; node = node_idx_tab[eff, v];
// * for g = 0..G-1 in slot order: if kbar_g > gate, dA += ybar_g and
//   dB += kbar_g - ybar_g, touched |= 1 (the plain version sums the same
//   way, so the two agree bit for bit on identical inputs);
// * A += dA, B += dB, touched |= any;
// * the bottom-up prune (csrc/raster_prune.cuh) with the
//   Beta state.  States use the f32 rules of
//   la3dm_tpu/models/posterior.py:29-51, built without FMA contraction.
// Blocks of n <= 8 (V <= 512) take one CTA each and prune in shared memory;
// blocks of n = 16..64 take one CTA per 8^3 tile, prune the levels inside
// a tile in shared memory and the levels across tiles in the block's last
// CTA, over per-tile summaries (raster_prune.cuh).
//
// What bounds it: memory.  Per block it reads V * 2G floats of the
// accumulator (only each voxel's eff-level node) and reads and writes the
// pool row (A, B: 4 bytes each; touched, eff: 1 byte each).  The design
// touches each byte once and keeps the prune in shared memory; the tiled
// shape adds 11 bytes of summary a tile.  A slot equal to the pool capacity
// is padding: every CTA of that block returns.

#include <cuda_runtime.h>
#include <stdint.h>

#include "raster_prune.cuh"

namespace {

using la3dm::kFree;
using la3dm::kOccupied;
using la3dm::kTileEdge;
using la3dm::kTileLevels;
using la3dm::kTileV;
using la3dm::kUnknown;

__device__ __forceinline__ int8_t beta_state(float A, float B, bool touched,
                                             float var_thresh, float free_thresh,
                                             float occupied_thresh) {
  const float prob = A / (A + B);
  const float s = A + B;
  const float var = (A * B) / (s * s * (s + 1.0f));
  int8_t st = prob > occupied_thresh ? kOccupied
              : (prob < free_thresh ? kFree : kUnknown);
  if (var > var_thresh) st = kUnknown;
  return touched ? st : kUnknown;
}

// The Beta update of pool voxel p (raster voxel v of block t's row).
__device__ __forceinline__ void beta_voxel(const float* __restrict__ acc,
                                           const int32_t* __restrict__ node_idx_tab,
                                           const float* A, const float* B,
                                           const uint8_t* touched, const int8_t* eff,
                                           int t, size_t p, int v, int V, int Vall,
                                           int G, float gate, float& An, float& Bn,
                                           uint8_t& Tn, int8_t& En) {
  const int e = eff[p];
  const int node = node_idx_tab[e * V + v];
  const float* a = acc + ((size_t)t * Vall + node) * (2 * G);
  float dA = 0.0f, dB = 0.0f;
  bool any = false;
  for (int g = 0; g < G; ++g) {
    const float yb = a[g];
    const float kb = a[G + g];
    if (kb > gate) {
      dA = dA + yb;
      dB = dB + (kb - yb);
      any = true;
    }
  }
  An = A[p] + dA;
  Bn = B[p] + dB;
  Tn = (touched[p] != 0 || any) ? 1 : 0;
  En = (int8_t)e;
}

// n <= 8: one CTA per block, one thread per voxel.
__global__ void bgk_light_kernel(const float* __restrict__ acc,   // [Tp,Vall,2G]
                                 const int32_t* __restrict__ slots,  // [Tp]
                                 const int32_t* __restrict__ node_idx_tab,  // [depth,V]
                                 float* __restrict__ A,            // [cap,V]
                                 float* __restrict__ B,            // [cap,V]
                                 uint8_t* __restrict__ touched,    // [cap,V]
                                 int8_t* __restrict__ eff,         // [cap,V]
                                 int start, int cap, int n, int Vall, int G,
                                 float gate, int max_level,
                                 float var_thresh, float free_thresh,
                                 float occupied_thresh) {
  __shared__ float sA[kTileV], sB[kTileV];
  __shared__ uint8_t sT[kTileV];
  __shared__ int8_t sE[kTileV], sS[kTileV];

  const int V = n * n * n;
  const int t = start + blockIdx.x;
  const int slot = slots[t];
  if (slot < 0 || slot >= cap) return;  // padding: uniform over the CTA
  const int v = threadIdx.x;
  const size_t p = (size_t)slot * V + v;

  float An, Bn;
  uint8_t Tn;
  int8_t En;
  beta_voxel(acc, node_idx_tab, A, B, touched, eff, t, p, v, V, Vall, G, gate, An, Bn,
             Tn, En);
  if (max_level > 0) {
    sA[v] = An;
    sB[v] = Bn;
    sT[v] = Tn;
    sE[v] = En;
    sS[v] = beta_state(An, Bn, Tn != 0, var_thresh, free_thresh, occupied_thresh);
    la3dm::raster_prune(sA, sB, sT, sE, sS, v, n, max_level);
    An = sA[v];
    Bn = sB[v];
    Tn = sT[v];
    En = sE[v];
  }
  A[p] = An;
  B[p] = Bn;
  touched[p] = Tn;
  eff[p] = En;
}

// n = 16..64: one CTA per (block, 8^3 tile), one thread per tile voxel.
__global__ void bgk_light_tiled_kernel(const float* __restrict__ acc,
                                       const int32_t* __restrict__ slots,
                                       const int32_t* __restrict__ node_idx_tab,
                                       float* __restrict__ A, float* __restrict__ B,
                                       uint8_t* __restrict__ touched,
                                       int8_t* __restrict__ eff, int start, int cap,
                                       int n, int Vall, int G, float gate,
                                       int max_level, float var_thresh,
                                       float free_thresh, float occupied_thresh,
                                       int8_t* __restrict__ sum_es,   // [count*tpb,2]
                                       float* __restrict__ sum_f,     // [count*tpb,2]
                                       uint8_t* __restrict__ sum_t,   // [count*tpb]
                                       int32_t* __restrict__ counters) {  // [count], 0
  __shared__ float sA[kTileV], sB[kTileV];
  __shared__ uint8_t sT[kTileV];
  __shared__ int8_t sE[kTileV], sS[kTileV];

  const int tpa = n / kTileEdge;
  const int tpb = tpa * tpa * tpa;
  const int b = blockIdx.x / tpb;
  const int pos = blockIdx.x % tpb;
  const int V = n * n * n;
  const int t = start + b;
  const int slot = slots[t];
  if (slot < 0 || slot >= cap) return;  // padding: every tile of the block
  const int vt = threadIdx.x;
  const int v = la3dm::tile_voxel(pos, vt, n);
  const size_t base = (size_t)slot * V;
  const size_t p = base + v;

  float An, Bn;
  uint8_t Tn;
  int8_t En;
  beta_voxel(acc, node_idx_tab, A, B, touched, eff, t, p, v, V, Vall, G, gate, An, Bn,
             Tn, En);
  if (max_level > 0) {
    sA[vt] = An;
    sB[vt] = Bn;
    sT[vt] = Tn;
    sE[vt] = En;
    sS[vt] = beta_state(An, Bn, Tn != 0, var_thresh, free_thresh, occupied_thresh);
    la3dm::raster_prune(sA, sB, sT, sE, sS, vt, kTileEdge,
                        max_level < kTileLevels ? max_level : kTileLevels);
    An = sA[vt];
    Bn = sB[vt];
    Tn = sT[vt];
    En = sE[vt];
  }
  A[p] = An;
  B[p] = Bn;
  touched[p] = Tn;
  eff[p] = En;
  if (max_level <= kTileLevels) return;  // no level spans tiles
  la3dm::cross_tile_prune(A, B, touched, eff, base, n, max_level, sA, sB, sT, sE, sS,
                          vt, pos, (size_t)b * tpb, sum_es, sum_f, sum_t, &counters[b]);
}

}  // namespace

// Launch K2 for one scan on ``stream`` over the scan's blocks
// [start, start + count): ``count`` CTAs of V = n^3 threads for n <= 8, else
// count * (n/8)^3 CTAs of 512 threads.  For n >= 16 the scratch holds
// count * (n/8)^3 tile summaries and ``count`` counters, zero at the launch
// (the wrapper zeroes them on the same stream).  Returns cudaGetLastError().
extern "C" int la3dm_bgk_light(const float* acc, const int32_t* slots,
                               const int32_t* node_idx_tab, float* A, float* B,
                               uint8_t* touched, int8_t* eff, int start, int count,
                               int cap, int n, int Vall, int G, float gate,
                               int max_level, float var_thresh, float free_thresh,
                               float occupied_thresh, int8_t* sum_es, float* sum_f,
                               uint8_t* sum_t, int32_t* counters, void* stream) {
  if (count <= 0 || n <= 0 || n > 64 || (n & (n - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= kTileEdge) {
    bgk_light_kernel<<<count, n * n * n, 0, s>>>(acc, slots, node_idx_tab, A, B, touched,
                                                 eff, start, cap, n, Vall, G, gate,
                                                 max_level, var_thresh, free_thresh,
                                                 occupied_thresh);
  } else {
    if (sum_es == nullptr || sum_f == nullptr || sum_t == nullptr || counters == nullptr)
      return (int)cudaErrorInvalidValue;
    const int tpa = n / kTileEdge;
    bgk_light_tiled_kernel<<<count * tpa * tpa * tpa, kTileV, 0, s>>>(
        acc, slots, node_idx_tab, A, B, touched, eff, start, cap, n, Vall, G, gate,
        max_level, var_thresh, free_thresh, occupied_thresh, sum_es, sum_f, sum_t,
        counters);
  }
  return (int)cudaGetLastError();
}
