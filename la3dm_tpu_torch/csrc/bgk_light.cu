// K2 — the BGK light pass with the prune, hand-written for Hopper (sm_90a).
//
// Replaces the light half of la3dm_tpu/models/bgk.py::_bgk_seq_step
// (lines 140-177: kernels/predict.py::beta_update, the node_idx_tab
// selection, the pool scatter and models/pruning.py::prune_blocks with
// posterior.BetaStateFn), for ONE scan.  The wrapper launches it once per
// scan, in scan order, on the current stream: scans are sequential because
// each scan's prune changes the eff levels the next scan reads.
//
// One CTA per test block of the scan, one thread per voxel v (V <= 1024):
// * eff = eff[slot, v]; node = node_idx_tab[eff, v];
// * for g = 0..G-1 in slot order: if kbar_g > gate, dA += ybar_g and
//   dB += kbar_g - ybar_g, touched |= 1 (the plain version sums the same
//   way, so the two agree bit for bit on identical inputs);
// * A += dA, B += dB, touched |= any;
// * the bottom-up prune in shared memory (csrc/raster_prune.cuh, shared with
//   K5) with the Beta state.  States use the f32 rules of
//   la3dm_tpu/models/posterior.py:29-51, built without FMA contraction.
//
// What bounds it: memory.  Per block it reads V * 2G floats of the
// accumulator (only each voxel's eff-level node) and reads and writes the
// pool row (A, B: 4 bytes each; touched, eff: 1 byte each).  The design
// touches each byte once and keeps the prune in shared memory.  A slot
// equal to the pool capacity is padding: the whole CTA returns.

#include <cuda_runtime.h>
#include <stdint.h>

#include "raster_prune.cuh"

namespace {

using la3dm::kFree;
using la3dm::kMaxV;
using la3dm::kOccupied;
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
  __shared__ float sA[kMaxV], sB[kMaxV];
  __shared__ uint8_t sT[kMaxV];
  __shared__ int8_t sE[kMaxV], sS[kMaxV];

  const int V = n * n * n;
  const int t = start + blockIdx.x;
  const int slot = slots[t];
  if (slot < 0 || slot >= cap) return;  // padding: uniform over the CTA
  const int v = threadIdx.x;
  const size_t p = (size_t)slot * V + v;

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
  float An = A[p] + dA;
  float Bn = B[p] + dB;
  uint8_t Tn = (touched[p] != 0 || any) ? 1 : 0;
  int8_t En = (int8_t)e;

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

}  // namespace

// Launch K2 for one scan on ``stream``: ``count`` CTAs of V = n^3 threads
// over the scan's blocks [start, start + count).  Returns cudaGetLastError().
extern "C" int la3dm_bgk_light(const float* acc, const int32_t* slots,
                               const int32_t* node_idx_tab, float* A, float* B,
                               uint8_t* touched, int8_t* eff, int start, int count,
                               int cap, int n, int Vall, int G, float gate,
                               int max_level, float var_thresh, float free_thresh,
                               float occupied_thresh, void* stream) {
  const int V = n * n * n;
  if (count <= 0 || V <= 0 || V > kMaxV) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bgk_light_kernel<<<count, V, 0, s>>>(acc, slots, node_idx_tab, A, B, touched,
                                       eff, start, cap, n, Vall, G, gate, max_level,
                                       var_thresh, free_thresh, occupied_thresh);
  return (int)cudaGetLastError();
}
