// K7a — the per-point passes of device scan ingest, hand-written for Hopper
// (sm_90a).
//
// Replaces the elementwise parts of la3dm_tpu/geometry/device_ingest.py::
// _ingest_scan: the outlier mask (_outlier_mask, lines 390-405) and the
// ds-voxel key of every raw point (_downsample, line 209), then, for every
// downsampled hit voxel, the range filter and the Kf + 2 free-space beam
// samples with their masks and voxel keys (lines 420-443).
//
// Two kernels, one thread per row:
// * ingest_points_kernel — raw point i of scan s: |p - origin_s|^2 <= lim
//   (lim = (mr + sqrt(3) ds)^2) or the sentinel key; else the key of
//   floor(p * (1/leaf)).
// * ingest_beams_kernel — (hit j, sample k): l = sqrt((dx^2 + dy^2) + dz^2),
//   in range iff l <= mr && l > 0, ndir = diff / max(l, 1e-30) (a division,
//   not a reciprocal); d = (k+1)*fr for k < Kf (kept while d < l), l - fr
//   (kept while l > fr), 0 (the origin, always kept); the sample is
//   origin + ndir * d and its key that of floor(sample * (1/leaf)).
// What bounds them: bytes (a few dozen operations per row against 12-20
// bytes moved).  Built with --fmad=false: with FMA contraction the free
// samples would change voxel at cell boundaries.
//
// Keys: ingest_keys.cuh (scan-local, anchored at each scan's origin cell).

#include <cuda_runtime.h>
#include <stdint.h>

#include "ingest_keys.cuh"

namespace {

__global__ void ingest_points_kernel(const float* __restrict__ pts,      // [N,3]
                                     const int32_t* __restrict__ scan,   // [N]
                                     const float* __restrict__ origins,  // [K,3]
                                     const int32_t* __restrict__ anchors,  // [K,3]
                                     int64_t N, float inv_leaf, float lim,
                                     int64_t* __restrict__ keys) {       // [N]
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const int s = scan[i];
  const float px = pts[3 * i + 0], py = pts[3 * i + 1], pz = pts[3 * i + 2];
  const float dx = px - origins[3 * s + 0];
  const float dy = py - origins[3 * s + 1];
  const float dz = pz - origins[3 * s + 2];
  float d2 = dx * dx;
  d2 = d2 + dy * dy;
  d2 = d2 + dz * dz;
  int64_t key = kSentinel;
  if (d2 <= lim) {
    key = pack_key(s, (int)floorf(px * inv_leaf), (int)floorf(py * inv_leaf),
                   (int)floorf(pz * inv_leaf), anchors + 3 * s);
  }
  keys[i] = key;
}

__global__ void ingest_beams_kernel(const float* __restrict__ hits,       // [R,3]
                                    const int64_t* __restrict__ hit_keys, // [R]
                                    const float* __restrict__ origins,    // [K,3]
                                    const int32_t* __restrict__ anchors,  // [K,3]
                                    int64_t R, int Kf, float mr, float fr,
                                    float inv_leaf,
                                    float* __restrict__ fpts,          // [R*(Kf+2),3]
                                    int64_t* __restrict__ fkeys,       // [R*(Kf+2)]
                                    bool* __restrict__ inr_out) {      // [R]
  const int S = Kf + 2;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= R * S) return;
  const int64_t j = idx / S;
  const int k = (int)(idx - j * S);
  const int s = (int)(hit_keys[j] >> 48);
  const float ox = origins[3 * s + 0], oy = origins[3 * s + 1], oz = origins[3 * s + 2];
  const float dx = hits[3 * j + 0] - ox;
  const float dy = hits[3 * j + 1] - oy;
  const float dz = hits[3 * j + 2] - oz;
  float l2 = dx * dx;
  l2 = l2 + dy * dy;
  l2 = l2 + dz * dz;
  const float l = sqrtf(l2);
  const bool inr = (l <= mr) && (l > 0.0f);
  const float den = fmaxf(l, 1e-30f);
  const float nx = dx / den, ny = dy / den, nz = dz / den;
  float d;
  bool keep;
  if (k < Kf) {
    d = (float)(k + 1) * fr;
    keep = d < l;
  } else if (k == Kf) {
    d = l - fr;
    keep = l > fr;
  } else {
    d = 0.0f;
    keep = true;
  }
  const float fx = ox + nx * d, fy = oy + ny * d, fz = oz + nz * d;
  fpts[3 * idx + 0] = fx;
  fpts[3 * idx + 1] = fy;
  fpts[3 * idx + 2] = fz;
  fkeys[idx] = (keep && inr)
                   ? pack_key(s, (int)floorf(fx * inv_leaf), (int)floorf(fy * inv_leaf),
                              (int)floorf(fz * inv_leaf), anchors + 3 * s)
                   : kSentinel;
  if (k == 0) inr_out[j] = inr;
}

constexpr int kThreads = 256;

}  // namespace

// Launch ingest_points_kernel on ``stream``.  Returns cudaGetLastError().
extern "C" int la3dm_ingest_points(const float* pts, const int32_t* scan,
                                   const float* origins, const int32_t* anchors,
                                   long long N, float inv_leaf, float lim,
                                   int64_t* keys, void* stream) {
  if (N <= 0) return (int)cudaErrorInvalidValue;
  const long long grid = (N + kThreads - 1) / kThreads;
  ingest_points_kernel<<<(unsigned)grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pts, scan, origins, anchors, N, inv_leaf, lim, keys);
  return (int)cudaGetLastError();
}

// Launch ingest_beams_kernel on ``stream``: R * (Kf + 2) threads.
extern "C" int la3dm_ingest_beams(const float* hits, const int64_t* hit_keys,
                                  const float* origins, const int32_t* anchors,
                                  long long R, int Kf, float mr, float fr, float inv_leaf,
                                  float* fpts, int64_t* fkeys, bool* inr, void* stream) {
  if (R <= 0 || Kf < 0) return (int)cudaErrorInvalidValue;
  const long long grid = (R * (Kf + 2) + kThreads - 1) / kThreads;
  ingest_beams_kernel<<<(unsigned)grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      hits, hit_keys, origins, anchors, R, Kf, mr, fr, inv_leaf, fpts, fkeys, inr);
  return (int)cudaGetLastError();
}
