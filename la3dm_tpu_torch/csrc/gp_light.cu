// K5 — the GP light pass (BCM fusion) with the prune, hand-written for
// Hopper (sm_90a).
//
// Replaces la3dm_tpu/models/gp.py::_gp_light (lines 119-186:
// kernels/gp.py::bcm_update_sequential, the node_idx_tab selection, the pool
// scatter and models/pruning.py::prune_blocks with posterior.GPStateFn) for
// ONE scan.  The wrapper launches it once per scan, in scan order, on the
// current stream: each scan's prune changes the eff levels the next reads.
//
// One thread per voxel v, in K2's shapes (csrc/bgk_light.cu: one CTA per
// block for n <= 8, one CTA per 8^3 tile for n = 16..64):
// * eff = eff[slot, v]; node = node_idx_tab[eff, v];
// * for g = 0..G-1 in slot (ExtendedBlock) order, where the slot holds a
//   trained model (present[t*G+g]): (m, var) = the model's prediction at the
//   node, var == 0 -> 1 (the JAX package's padded-row guard), then
//   ivar = (ivar + 1/var) - sf2, m_ivar = m_ivar + m/var, and the persistent
//   chop ivar >= min_known_ivar => ivar = min(ivar, max_ivar);
// * touched |= any slot present;
// * the bottom-up prune (csrc/raster_prune.cuh, shared with K2) with the GP
//   state p = 1/(1 + expf((-l*m_ivar)/max_ivar)), the p-thresholds, UNKNOWN
//   below min_known_ivar and where untouched — the f32 rules of
//   la3dm_tpu/models/posterior.py:77-88.  Only the prune crosses tiles.
//
// What bounds it: memory.  Per block it reads the G slots' (mean, var) at
// each voxel's eff-level node (V * G * 8 bytes) and reads and writes the pool
// row (m_ivar, ivar: 4 bytes each; touched, eff: 1 byte each), each byte
// once; the prune stays in shared memory (and 11 bytes of summary a tile).
// Built with --fmad=false and full-precision division and expf: every
// expression rounds as the plain version's separate ops.  A slot equal to
// the pool capacity is padding: every CTA of that block returns.

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

struct GPParams {
  float sf2, min_known_ivar, max_ivar, l, free_thresh, occupied_thresh;
};

__device__ __forceinline__ int8_t gp_state(float mi, float iv, bool touched,
                                           const GPParams& q) {
  const float p = 1.0f / (1.0f + expf((-q.l * mi) / q.max_ivar));
  int8_t st = p > q.occupied_thresh ? kOccupied : (p < q.free_thresh ? kFree : kUnknown);
  if (iv < q.min_known_ivar) st = kUnknown;
  return touched ? st : kUnknown;
}

// The sequential BCM of pool voxel p (raster voxel v of block t's row).
__device__ __forceinline__ void bcm_voxel(const float* __restrict__ acc_mean,
                                          const float* __restrict__ acc_var,
                                          const uint8_t* __restrict__ present,
                                          const int32_t* __restrict__ node_idx_tab,
                                          const float* m_ivar, const float* ivar,
                                          const uint8_t* touched, const int8_t* eff,
                                          int t, size_t p, int v, int V, int Vall, int G,
                                          const GPParams& q, float& mi, float& iv,
                                          uint8_t& Tn, int8_t& En) {
  const int e = eff[p];
  const int node = node_idx_tab[e * V + v];
  mi = m_ivar[p];
  iv = ivar[p];
  bool any = false;
  for (int g = 0; g < G; ++g) {
    const size_t row = (size_t)t * G + g;
    if (!present[row]) continue;
    any = true;
    const float m = acc_mean[row * Vall + node];
    float var = acc_var[row * Vall + node];
    if (var == 0.0f) var = 1.0f;
    float iv_new = iv + 1.0f / var;
    iv_new = iv_new - q.sf2;
    const float mi_new = mi + m / var;
    if (iv_new >= q.min_known_ivar) iv_new = iv_new > q.max_ivar ? q.max_ivar : iv_new;
    mi = mi_new;
    iv = iv_new;
  }
  Tn = (touched[p] != 0 || any) ? 1 : 0;
  En = (int8_t)e;
}

// n <= 8: one CTA per block, one thread per voxel.
__global__ void gp_light_kernel(const float* __restrict__ acc_mean,  // [Tp*G,Vall]
                                const float* __restrict__ acc_var,   // [Tp*G,Vall]
                                const uint8_t* __restrict__ present, // [Tp*G]
                                const int32_t* __restrict__ slots,   // [Tp]
                                const int32_t* __restrict__ node_idx_tab,  // [depth,V]
                                float* __restrict__ m_ivar,          // [cap,V]
                                float* __restrict__ ivar,            // [cap,V]
                                uint8_t* __restrict__ touched,       // [cap,V]
                                int8_t* __restrict__ eff,            // [cap,V]
                                int start, int cap, int n, int Vall, int G,
                                int max_level, GPParams q) {
  __shared__ float sM[kTileV], sI[kTileV];
  __shared__ uint8_t sT[kTileV];
  __shared__ int8_t sE[kTileV], sS[kTileV];

  const int V = n * n * n;
  const int t = start + blockIdx.x;
  const int slot = slots[t];
  if (slot < 0 || slot >= cap) return;  // padding: uniform over the CTA
  const int v = threadIdx.x;
  const size_t p = (size_t)slot * V + v;

  float mi, iv;
  uint8_t Tn;
  int8_t En;
  bcm_voxel(acc_mean, acc_var, present, node_idx_tab, m_ivar, ivar, touched, eff, t, p,
            v, V, Vall, G, q, mi, iv, Tn, En);
  if (max_level > 0) {
    sM[v] = mi;
    sI[v] = iv;
    sT[v] = Tn;
    sE[v] = En;
    sS[v] = gp_state(mi, iv, Tn != 0, q);
    la3dm::raster_prune(sM, sI, sT, sE, sS, v, n, max_level);
    mi = sM[v];
    iv = sI[v];
    Tn = sT[v];
    En = sE[v];
  }
  m_ivar[p] = mi;
  ivar[p] = iv;
  touched[p] = Tn;
  eff[p] = En;
}

// n = 16..64: one CTA per (block, 8^3 tile), one thread per tile voxel.
__global__ void gp_light_tiled_kernel(const float* __restrict__ acc_mean,
                                      const float* __restrict__ acc_var,
                                      const uint8_t* __restrict__ present,
                                      const int32_t* __restrict__ slots,
                                      const int32_t* __restrict__ node_idx_tab,
                                      float* __restrict__ m_ivar, float* __restrict__ ivar,
                                      uint8_t* __restrict__ touched,
                                      int8_t* __restrict__ eff, int start, int cap, int n,
                                      int Vall, int G, int max_level, GPParams q,
                                      int8_t* __restrict__ sum_es,   // [count*tpb,2]
                                      float* __restrict__ sum_f,     // [count*tpb,2]
                                      uint8_t* __restrict__ sum_t,   // [count*tpb]
                                      int32_t* __restrict__ counters) {  // [count], 0
  __shared__ float sM[kTileV], sI[kTileV];
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

  float mi, iv;
  uint8_t Tn;
  int8_t En;
  bcm_voxel(acc_mean, acc_var, present, node_idx_tab, m_ivar, ivar, touched, eff, t, p,
            v, V, Vall, G, q, mi, iv, Tn, En);
  if (max_level > 0) {
    sM[vt] = mi;
    sI[vt] = iv;
    sT[vt] = Tn;
    sE[vt] = En;
    sS[vt] = gp_state(mi, iv, Tn != 0, q);
    la3dm::raster_prune(sM, sI, sT, sE, sS, vt, kTileEdge,
                        max_level < kTileLevels ? max_level : kTileLevels);
    mi = sM[vt];
    iv = sI[vt];
    Tn = sT[vt];
    En = sE[vt];
  }
  m_ivar[p] = mi;
  ivar[p] = iv;
  touched[p] = Tn;
  eff[p] = En;
  if (max_level <= kTileLevels) return;  // no level spans tiles
  la3dm::cross_tile_prune(m_ivar, ivar, touched, eff, base, n, max_level, sM, sI, sT,
                          sE, sS, vt, pos, (size_t)b * tpb, sum_es, sum_f, sum_t,
                          &counters[b]);
}

}  // namespace

// Launch K5 for one scan on ``stream`` over the scan's blocks
// [start, start + count), in K2's shapes and with K2's scratch (see
// la3dm_bgk_light).  Returns cudaGetLastError().
extern "C" int la3dm_gp_light(const float* acc_mean, const float* acc_var,
                              const uint8_t* present, const int32_t* slots,
                              const int32_t* node_idx_tab, float* m_ivar, float* ivar,
                              uint8_t* touched, int8_t* eff, int start, int count,
                              int cap, int n, int Vall, int G, int max_level, float sf2,
                              float min_known_ivar, float max_ivar, float l,
                              float free_thresh, float occupied_thresh, int8_t* sum_es,
                              float* sum_f, uint8_t* sum_t, int32_t* counters,
                              void* stream) {
  if (count <= 0 || n <= 0 || n > 64 || (n & (n - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const GPParams q{sf2, min_known_ivar, max_ivar, l, free_thresh, occupied_thresh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= kTileEdge) {
    gp_light_kernel<<<count, n * n * n, 0, s>>>(acc_mean, acc_var, present, slots,
                                                node_idx_tab, m_ivar, ivar, touched, eff,
                                                start, cap, n, Vall, G, max_level, q);
  } else {
    if (sum_es == nullptr || sum_f == nullptr || sum_t == nullptr || counters == nullptr)
      return (int)cudaErrorInvalidValue;
    const int tpa = n / kTileEdge;
    gp_light_tiled_kernel<<<count * tpa * tpa * tpa, kTileV, 0, s>>>(
        acc_mean, acc_var, present, slots, node_idx_tab, m_ivar, ivar, touched, eff, start,
        cap, n, Vall, G, max_level, q, sum_es, sum_f, sum_t, counters);
  }
  return (int)cudaGetLastError();
}
