// K5 — the GP light pass (BCM fusion) with the prune, hand-written for
// Hopper (sm_90a).
//
// Replaces la3dm_tpu/models/gp.py::_gp_light (lines 119-186:
// kernels/gp.py::bcm_update_sequential, the node_idx_tab selection, the pool
// scatter and models/pruning.py::prune_blocks with posterior.GPStateFn) for
// ONE scan.  The wrapper launches it once per scan, in scan order, on the
// current stream: each scan's prune changes the eff levels the next reads.
//
// One CTA per test block of the scan, one thread per voxel v (V <= 1024):
// * eff = eff[slot, v]; node = node_idx_tab[eff, v];
// * for g = 0..G-1 in slot (ExtendedBlock) order, where the slot holds a
//   trained model (present[t*G+g]): (m, var) = the model's prediction at the
//   node, var == 0 -> 1 (the JAX package's padded-row guard), then
//   ivar = (ivar + 1/var) - sf2, m_ivar = m_ivar + m/var, and the persistent
//   chop ivar >= min_known_ivar => ivar = min(ivar, max_ivar);
// * touched |= any slot present;
// * the bottom-up prune in shared memory (csrc/raster_prune.cuh, shared with
//   K2) with the GP state p = 1/(1 + expf((-l*m_ivar)/max_ivar)), the
//   p-thresholds, UNKNOWN below min_known_ivar and where untouched — the f32
//   rules of la3dm_tpu/models/posterior.py:77-88.
//
// What bounds it: memory.  Per block it reads the G slots' (mean, var) at
// each voxel's eff-level node (V * G * 8 bytes) and reads and writes the pool
// row (m_ivar, ivar: 4 bytes each; touched, eff: 1 byte each), each byte
// once; the prune stays in shared memory.  Built with --fmad=false and
// full-precision division and expf: every expression rounds as the plain
// version's separate ops.  A slot equal to the pool capacity is padding: the
// whole CTA returns.

#include <cuda_runtime.h>
#include <stdint.h>

#include "raster_prune.cuh"

namespace {

using la3dm::kFree;
using la3dm::kMaxV;
using la3dm::kOccupied;
using la3dm::kUnknown;

__device__ __forceinline__ int8_t gp_state(float mi, float iv, bool touched, float l,
                                           float max_ivar, float min_known_ivar,
                                           float free_thresh, float occupied_thresh) {
  const float p = 1.0f / (1.0f + expf((-l * mi) / max_ivar));
  int8_t st = p > occupied_thresh ? kOccupied : (p < free_thresh ? kFree : kUnknown);
  if (iv < min_known_ivar) st = kUnknown;
  return touched ? st : kUnknown;
}

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
                                int max_level, float sf2, float min_known_ivar,
                                float max_ivar, float l, float free_thresh,
                                float occupied_thresh) {
  __shared__ float sM[kMaxV], sI[kMaxV];
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
  float mi = m_ivar[p];
  float iv = ivar[p];
  bool any = false;
  for (int g = 0; g < G; ++g) {
    const size_t row = (size_t)t * G + g;
    if (!present[row]) continue;
    any = true;
    const float m = acc_mean[row * Vall + node];
    float var = acc_var[row * Vall + node];
    if (var == 0.0f) var = 1.0f;
    float iv_new = iv + 1.0f / var;
    iv_new = iv_new - sf2;
    const float mi_new = mi + m / var;
    if (iv_new >= min_known_ivar) iv_new = iv_new > max_ivar ? max_ivar : iv_new;
    mi = mi_new;
    iv = iv_new;
  }
  uint8_t Tn = (touched[p] != 0 || any) ? 1 : 0;
  int8_t En = (int8_t)e;

  if (max_level > 0) {
    sM[v] = mi;
    sI[v] = iv;
    sT[v] = Tn;
    sE[v] = En;
    sS[v] = gp_state(mi, iv, Tn != 0, l, max_ivar, min_known_ivar, free_thresh,
                     occupied_thresh);
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

}  // namespace

// Launch K5 for one scan on ``stream``: ``count`` CTAs of V = n^3 threads
// over the scan's blocks [start, start + count).  Returns cudaGetLastError().
extern "C" int la3dm_gp_light(const float* acc_mean, const float* acc_var,
                              const uint8_t* present, const int32_t* slots,
                              const int32_t* node_idx_tab, float* m_ivar, float* ivar,
                              uint8_t* touched, int8_t* eff, int start, int count,
                              int cap, int n, int Vall, int G, int max_level, float sf2,
                              float min_known_ivar, float max_ivar, float l,
                              float free_thresh, float occupied_thresh, void* stream) {
  const int V = n * n * n;
  if (count <= 0 || V <= 0 || V > kMaxV) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  gp_light_kernel<<<count, V, 0, s>>>(acc_mean, acc_var, present, slots, node_idx_tab,
                                      m_ivar, ivar, touched, eff, start, cap, n, Vall, G,
                                      max_level, sf2, min_known_ivar, max_ivar, l,
                                      free_thresh, occupied_thresh);
  return (int)cudaGetLastError();
}
