// K7b — the segmented centroid reduction of device scan ingest, hand-written
// for Hopper (sm_90a).
//
// Replaces the reduction of la3dm_tpu/geometry/device_ingest.py::_downsample
// (lines 192-246: a log-shift segmented scan and a second payload sort).
// The caller stable-sorts the voxel keys and cuts the runs (K7s); for each
// run this kernel computes
//   corner = ijk * leaf  (ijk decoded from the run's key),
//   sum    = sum over the run, in sorted order, of (p - corner),
//   cent   = corner + sum / count.
// The sum is COMPENSATED, as in the JAX function: a voxel holding N copies of
// a sensor origin that sits on a block face averages to the origin exactly,
// so its closed-box membership cannot flip.  JAX sums each run in a
// Hillis-Steele tree; this kernel and its plain version sum in sorted order,
// s = s + (p - corner) in f32, the same order in both (against JAX the
// centroids differ in f32 ulps).  The one pass serves both the hit and the
// free-sample downsample.
//
// Mapping.  A run of at most kLong members is one lane's loop (its loads
// four members at a time).  Longer runs — the free samples at a scan's
// origin, one per hit, about 3,500 — are taken by the whole warp, one after
// another once the warp's short runs are done: the warp walks the run in
// batches of 32 kGroups members, 32 consecutive members a group, one a lane
// (perm read coalesced), in a three-stage pipeline (the sort index of batch
// j + 2 and the points of batch j + 1 are in flight while batch j is
// added), and adds each batch in order, every lane keeping the same sum
// from the members broadcast by __shfl_sync: only the f32 adds are serial.
// What bounds it: bytes (each point read once through its sort index); the
// longest run's serial adds, 3 a member, set its least time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ingest_keys.cuh"

namespace {

constexpr int kThreads = 256;
constexpr unsigned kAll = 0xffffffffu;
constexpr int64_t kLong = 64;  // runs of more members are the warp's
constexpr int kGroups = 8;     // 32-member groups a batch
constexpr int64_t kBatch = 32 * kGroups;

struct Pts {
  float x[kGroups], y[kGroups], z[kGroups];
};

// member q (< n) of the run at ``st``: its point minus the corner
__device__ __forceinline__ void diff(const float* __restrict__ pts, int64_t p, float cx,
                                     float cy, float cz, float* dx, float* dy, float* dz) {
  *dx = pts[3 * p + 0] - cx;
  *dy = pts[3 * p + 1] - cy;
  *dz = pts[3 * p + 2] - cz;
}

__device__ __forceinline__ void load_perm(const int64_t* __restrict__ perm, int64_t st,
                                          int64_t n, int64_t b, int lane, int64_t* pi) {
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
    const int64_t q = b + 32 * k + lane;
    pi[k] = q < n ? perm[st + q] : -1;
  }
}

__device__ __forceinline__ void load_pts(const float* __restrict__ pts, const int64_t* pi,
                                         float cx, float cy, float cz, Pts* d) {
#pragma unroll
  for (int k = 0; k < kGroups; ++k) {
    if (pi[k] >= 0) {
      diff(pts, pi[k], cx, cy, cz, &d->x[k], &d->y[k], &d->z[k]);
    } else {
      d->x[k] = d->y[k] = d->z[k] = 0.0f;
    }
  }
}

// add the batch's members b .. min(b + kBatch, n) - 1 in order
__device__ __forceinline__ void add_batch(const Pts& d, int64_t b, int64_t n, float* sx,
                                          float* sy, float* sz) {
  if (b + kBatch <= n) {
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        *sx = *sx + __shfl_sync(kAll, d.x[k], j);
        *sy = *sy + __shfl_sync(kAll, d.y[k], j);
        *sz = *sz + __shfl_sync(kAll, d.z[k], j);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const float ax = __shfl_sync(kAll, d.x[k], j);
        const float ay = __shfl_sync(kAll, d.y[k], j);
        const float az = __shfl_sync(kAll, d.z[k], j);
        if (b + 32 * k + j < n) {
          *sx = *sx + ax;
          *sy = *sy + ay;
          *sz = *sz + az;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
ingest_downsample_kernel(const float* __restrict__ pts,         // [N,3]
                         const int64_t* __restrict__ perm,      // [>=N]
                         const int64_t* __restrict__ starts,    // [R]
                         const int64_t* __restrict__ counts,    // [R]
                         const int64_t* __restrict__ run_keys,  // [R]
                         const int32_t* __restrict__ anchors,   // [K,3]
                         int64_t R, float leaf, float* __restrict__ cent) {  // [R,3]
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const bool have = r < R;
  float cx = 0.0f, cy = 0.0f, cz = 0.0f;
  int64_t st = 0, n = 0;
  if (have) {
    const int64_t key = run_keys[r];
    const int32_t* anchor = anchors + 3 * (int)(key >> 48);
    cx = (float)key_coord(key, 0, anchor) * leaf;
    cy = (float)key_coord(key, 1, anchor) * leaf;
    cz = (float)key_coord(key, 2, anchor) * leaf;
    st = starts[r];
    n = counts[r];
  }
  if (have && n <= kLong) {
    float sx = 0.0f, sy = 0.0f, sz = 0.0f;
    int64_t q = 0;
    for (; q + 4 <= n; q += 4) {
      int64_t p[4];
      float d[4][3];
#pragma unroll
      for (int u = 0; u < 4; ++u) p[u] = perm[st + q + u];
#pragma unroll
      for (int u = 0; u < 4; ++u) diff(pts, p[u], cx, cy, cz, &d[u][0], &d[u][1], &d[u][2]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        sx = sx + d[u][0];
        sy = sy + d[u][1];
        sz = sz + d[u][2];
      }
    }
    for (; q < n; ++q) {
      float dx, dy, dz;
      diff(pts, perm[st + q], cx, cy, cz, &dx, &dy, &dz);
      sx = sx + dx;
      sy = sy + dy;
      sz = sz + dz;
    }
    const float c = (float)n;
    cent[3 * r + 0] = cx + sx / c;
    cent[3 * r + 1] = cy + sy / c;
    cent[3 * r + 2] = cz + sz / c;
  }
  // the warp's long runs, in lane order
  unsigned longs = __ballot_sync(kAll, have && n > kLong);
  while (longs) {
    const int src = __ffs(longs) - 1;
    longs &= longs - 1;
    const int64_t wst = __shfl_sync(kAll, st, src), wn = __shfl_sync(kAll, n, src);
    const float wx = __shfl_sync(kAll, cx, src), wy = __shfl_sync(kAll, cy, src),
                wz = __shfl_sync(kAll, cz, src);
    float sx = 0.0f, sy = 0.0f, sz = 0.0f;
    int64_t pn[kGroups];  // the sort index of the batch after next
    Pts cur, nxt;
    int64_t pi[kGroups];
    load_perm(perm, wst, wn, 0, lane, pi);
    load_pts(pts, pi, wx, wy, wz, &cur);
    load_perm(perm, wst, wn, kBatch, lane, pn);
    for (int64_t b = 0; b < wn; b += kBatch) {
#pragma unroll
      for (int k = 0; k < kGroups; ++k) pi[k] = pn[k];
      load_perm(perm, wst, wn, b + 2 * kBatch, lane, pn);
      load_pts(pts, pi, wx, wy, wz, &nxt);
      add_batch(cur, b, wn, &sx, &sy, &sz);
      cur = nxt;
    }
    if (lane == src) {
      const float c = (float)wn;
      cent[3 * r + 0] = wx + sx / c;
      cent[3 * r + 1] = wy + sy / c;
      cent[3 * r + 2] = wz + sz / c;
    }
  }
}

}  // namespace

// Launch K7b on ``stream``: one lane a short run, one warp a long one.
// Returns cudaGetLastError().
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
