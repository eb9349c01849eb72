// K7b — the segmented centroid reduction of device scan ingest, hand-written
// for Hopper (sm_90a).
//
// Replaces the reduction of la3dm_tpu/geometry/device_ingest.py::_downsample
// (lines 192-246: a log-shift segmented scan and a second payload sort).
// Here the caller stable-sorts the voxel keys (torch.sort) and cuts the runs
// (torch.unique_consecutive); this kernel takes one run per thread:
//   corner = ijk * leaf  (ijk decoded from the run's key),
//   sum    = sum over the run, in sorted order, of (p - corner),
//   cent   = corner + sum / count.
// The sum is COMPENSATED, as in the JAX function: a voxel holding N copies of
// a sensor origin that sits on a block face averages to the origin exactly,
// so its closed-box membership cannot flip.  JAX sums each run in a
// Hillis-Steele tree; this kernel and its plain version sum in sorted order,
// the same order in both (against JAX the centroids differ in f32 ulps).
// The one pass serves both the hit and the free-sample downsample.
// What bounds it: bytes (each point read once through its sort index); the
// longest run, the free samples at a scan's origin (one per hit), is one
// thread's serial loop.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ingest_keys.cuh"

namespace {

__global__ void ingest_downsample_kernel(const float* __restrict__ pts,       // [N,3]
                                         const int64_t* __restrict__ perm,    // [>=N]
                                         const int64_t* __restrict__ starts,  // [R]
                                         const int64_t* __restrict__ counts,  // [R]
                                         const int64_t* __restrict__ run_keys,  // [R]
                                         const int32_t* __restrict__ anchors,   // [K,3]
                                         int64_t R, float leaf,
                                         float* __restrict__ cent) {          // [R,3]
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int64_t key = run_keys[r];
  const int32_t* anchor = anchors + 3 * (int)(key >> 48);
  const float cx = (float)key_coord(key, 0, anchor) * leaf;
  const float cy = (float)key_coord(key, 1, anchor) * leaf;
  const float cz = (float)key_coord(key, 2, anchor) * leaf;
  const int64_t st = starts[r];
  const int64_t n = counts[r];
  float sx = 0.0f, sy = 0.0f, sz = 0.0f;
  for (int64_t q = st; q < st + n; ++q) {
    const int64_t p = perm[q];
    sx = sx + (pts[3 * p + 0] - cx);
    sy = sy + (pts[3 * p + 1] - cy);
    sz = sz + (pts[3 * p + 2] - cz);
  }
  const float c = (float)n;
  cent[3 * r + 0] = cx + sx / c;
  cent[3 * r + 1] = cy + sy / c;
  cent[3 * r + 2] = cz + sz / c;
}

constexpr int kThreads = 256;

}  // namespace

// Launch K7b on ``stream``: one thread per run.  Returns cudaGetLastError().
extern "C" int la3dm_ingest_downsample(const float* pts, const int64_t* perm,
                                       const int64_t* starts, const int64_t* counts,
                                       const int64_t* run_keys, const int32_t* anchors,
                                       long long R, float leaf, float* cent, void* stream) {
  if (R <= 0) return (int)cudaErrorInvalidValue;
  const long long grid = (R + kThreads - 1) / kThreads;
  ingest_downsample_kernel<<<(unsigned)grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      pts, perm, starts, counts, run_keys, anchors, R, leaf, cent);
  return (int)cudaGetLastError();
}
