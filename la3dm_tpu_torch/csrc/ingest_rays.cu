// K7d — the BGKL ray pass of device scan ingest, hand-written for Hopper
// (sm_90a).
//
// Replaces the per-ray part of la3dm_tpu/geometry/device_ingest.py::
// _ingest_scan_bgkl (lines 497-574): for every downsampled hit of scan s
// (one warp per hit), all in f32,
//   l = sqrt((dx^2 + dy^2) + dz^2), inr = l <= mr && l > 0,
//   ndir = diff / max(l, 1e-30) (a division),
//   occ = origin + ndir * l, the free ray (origin, origin + ndir * (l - fr)),
//   the Kf + 1 proxy samples: the origin (kept iff inr), then
//   origin + ndir * d with d = l - k * fr (k * fr an f32 product), k = 1..Kf,
//   kept iff inr && d > 0,
// each sample's <= 8 closed-box block memberships (the rule of K7c,
// ingest_members.cu: base = floor(p / bs + 0.5), the tests
// ctr - half <= p <= ctr + half) and their block keys (ingest_keys.cuh),
// and the ray's SET of distinct keys: the per-(block, ray) dedup of
// bgkloctomap.cpp:145-172.
//
// Design:
// * One warp per ray.  The ray's 8 (Kf + 1) candidate keys go to the warp's
//   slice of shared memory, padded with the sentinel to a power of two P,
//   and the warp sorts them (bitonic, ascending).  A key is kept where it
//   differs from its predecessor: the sorted row's first-in-run flags, as
//   the JAX step keeps them (:536-544).  No ordering of the samples along
//   the ray is assumed.
// * Two launches of one kernel: the count pass writes each ray's number of
//   distinct keys (and occ, the segment, inr and, if asked, the samples);
//   the wrapper takes the exclusive prefix sum; the write pass recomputes
//   the sorted row and writes the ray's keys at its offset, in sorted order,
//   positions from warp ballots.  The pair list is in ray order, then key
//   order: no atomics decide it.
// * What bounds it: operations (about 40 for a sample's position and
//   memberships, and the sort's compare-exchanges, P log2(P)^2 / 4 a ray);
//   the bytes are small (12 in and about 60 out a ray, 16 a pair).  Built
//   with --fmad=false: with FMA contraction the samples, hence the block
//   memberships on a face, would change.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ingest_keys.cuh"

namespace {

constexpr int kWarp = 32;

struct Ray {
  int s;
  float ox, oy, oz, nx, ny, nz, l;
  bool inr;
};

__device__ __forceinline__ Ray load_ray(const float* hits, const int64_t* hit_keys,
                                        const float* origins, int64_t r, float mr) {
  Ray y;
  y.s = (int)(hit_keys[r] >> 48);
  y.ox = origins[3 * y.s + 0];
  y.oy = origins[3 * y.s + 1];
  y.oz = origins[3 * y.s + 2];
  const float dx = hits[3 * r + 0] - y.ox;
  const float dy = hits[3 * r + 1] - y.oy;
  const float dz = hits[3 * r + 2] - y.oz;
  float l2 = dx * dx;
  l2 = l2 + dy * dy;
  l2 = l2 + dz * dz;
  y.l = sqrtf(l2);
  y.inr = (y.l <= mr) && (y.l > 0.0f);
  const float den = fmaxf(y.l, 1e-30f);
  y.nx = dx / den;
  y.ny = dy / den;
  y.nz = dz / den;
  return y;
}

// the warp's sorted candidate row of ray r in keys[0, P)
__device__ void sorted_row(const Ray& y, const int32_t* anchors, int Kf, float fr, float bs,
                           float half, int P, int lane, int64_t* keys,
                           float* samples /* [S,3] of this ray, or null */) {
  const int S = Kf + 1;
  for (int i = 8 * S + lane; i < P; i += kWarp) keys[i] = kSentinel;
  const int32_t* anchor = anchors + 3 * y.s;
  for (int k = lane; k < S; k += kWarp) {
    float p[3];
    bool ok;
    if (k == 0) {
      p[0] = y.ox;
      p[1] = y.oy;
      p[2] = y.oz;
      ok = y.inr;
    } else {
      const float d = y.l - (float)k * fr;
      ok = y.inr && d > 0.0f;
      p[0] = y.ox + y.nx * d;
      p[1] = y.oy + y.ny * d;
      p[2] = y.oz + y.nz * d;
    }
    if (samples != nullptr) {
      samples[3 * k + 0] = p[0];
      samples[3 * k + 1] = p[1];
      samples[3 * k + 2] = p[2];
    }
    int base[3], second[3];
    bool base_ok[3], sec_ok[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int b = (int)floorf(p[a] / bs + 0.5f);
      bool in[3];  // base, base + 1, base - 1
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float ctr = (float)(b + (c == 0 ? 0 : (c == 1 ? 1 : -1))) * bs;
        in[c] = (ctr - half <= p[a]) && (p[a] <= ctr + half);
      }
      base[a] = b;
      base_ok[a] = in[0];
      second[a] = in[1] ? b + 1 : b - 1;
      sec_ok[a] = in[1] || in[2];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int bx = (j >> 2) & 1, by = (j >> 1) & 1, bz = j & 1;
      const bool m = ok && (bx ? sec_ok[0] : base_ok[0]) && (by ? sec_ok[1] : base_ok[1])
                     && (bz ? sec_ok[2] : base_ok[2]);
      keys[8 * k + j] = m ? pack_key(y.s, bx ? second[0] : base[0], by ? second[1] : base[1],
                                     bz ? second[2] : base[2], anchor)
                          : kSentinel;
    }
  }
  __syncwarp();
  // bitonic sort, ascending
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = lane; i < P; i += kWarp) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const int64_t a = keys[i], b = keys[ixj];
          const bool up = (i & k) == 0;
          if ((a > b) == up) {
            keys[i] = b;
            keys[ixj] = a;
          }
        }
      }
      __syncwarp();
    }
  }
}

template <bool kWrite>
__global__ void ingest_rays_kernel(const float* __restrict__ hits,       // [R,3]
                                   const int64_t* __restrict__ hit_keys, // [R]
                                   const float* __restrict__ origins,    // [K,3]
                                   const int32_t* __restrict__ anchors,  // [K,3]
                                   int64_t R, int Kf, float mr, float fr, float bs,
                                   float half, int P,
                                   float* __restrict__ occ,       // [R,3]  (count pass)
                                   float* __restrict__ seg,       // [R,6]  (count pass)
                                   bool* __restrict__ inr_out,    // [R]    (count pass)
                                   float* __restrict__ samples,   // [R,Kf+1,3] or null
                                   int64_t* __restrict__ count,   // [R]    (count pass)
                                   const int64_t* __restrict__ offsets,  // [R] (write)
                                   int64_t* __restrict__ pair_ray,       // (write pass)
                                   int64_t* __restrict__ pair_key) {     // (write pass)
  extern __shared__ int64_t smem[];
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int64_t r = (int64_t)blockIdx.x * (blockDim.x / kWarp) + warp;
  if (r >= R) return;  // warp-uniform: the warps share no barrier
  int64_t* keys = smem + (size_t)warp * P;
  const Ray y = load_ray(hits, hit_keys, origins, r, mr);
  if (!kWrite && lane == 0) {
    occ[3 * r + 0] = y.ox + y.nx * y.l;
    occ[3 * r + 1] = y.oy + y.ny * y.l;
    occ[3 * r + 2] = y.oz + y.nz * y.l;
    const float dl = y.l - fr;
    seg[6 * r + 0] = y.ox;
    seg[6 * r + 1] = y.oy;
    seg[6 * r + 2] = y.oz;
    seg[6 * r + 3] = y.ox + y.nx * dl;
    seg[6 * r + 4] = y.oy + y.ny * dl;
    seg[6 * r + 5] = y.oz + y.nz * dl;
    inr_out[r] = y.inr;
  }
  float* my_samples = (!kWrite && samples != nullptr) ? samples + 3 * (size_t)r * (Kf + 1)
                                                      : nullptr;
  sorted_row(y, anchors, Kf, fr, bs, half, P, lane, keys, my_samples);

  int64_t n = 0;
  for (int b = 0; b < P; b += kWarp) {
    if (keys[b] == kSentinel) break;  // sorted: the rest is padding
    const int i = b + lane;
    const int64_t k = keys[i];
    const bool first = k != kSentinel && (i == 0 || k != keys[i - 1]);
    const unsigned mask = __ballot_sync(0xFFFFFFFFu, first);
    if (kWrite && first) {
      const int64_t pos = offsets[r] + n + __popc(mask & ((1u << lane) - 1u));
      pair_ray[pos] = r;
      pair_key[pos] = k;
    }
    n += __popc(mask);
  }
  if (!kWrite && lane == 0) count[r] = n;
}

constexpr int kSmemDefault = 48 * 1024;

int warps_per_block(int P) {
  const int per_warp = P * (int)sizeof(int64_t);
  int w = kSmemDefault / per_warp;
  return w < 1 ? 1 : (w > 8 ? 8 : w);
}

template <bool kWrite>
int launch(const float* hits, const int64_t* hit_keys, const float* origins,
           const int32_t* anchors, long long R, int Kf, float mr, float fr, float bs,
           float half, int P, float* occ, float* seg, bool* inr, float* samples,
           int64_t* count, const int64_t* offsets, int64_t* pair_ray, int64_t* pair_key,
           cudaStream_t s) {
  const int w = warps_per_block(P);
  const size_t smem = (size_t)w * P * sizeof(int64_t);
  if (smem > kSmemDefault) {
    const cudaError_t e = cudaFuncSetAttribute(
        ingest_rays_kernel<kWrite>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long grid = (R + w - 1) / w;
  ingest_rays_kernel<kWrite><<<(unsigned)grid, w * kWarp, smem, s>>>(
      hits, hit_keys, origins, anchors, R, Kf, mr, fr, bs, half, P, occ, seg, inr, samples,
      count, offsets, pair_ray, pair_key);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch K7d's count pass (write == 0: occ, seg, inr, samples if non-null,
// count) or its write pass (write != 0: pair_ray, pair_key at offsets) on
// ``stream``: one warp per ray, P (a power of two >= 8 (Kf + 1), <= 16384)
// sorted keys a warp in shared memory.  Returns cudaGetLastError().
extern "C" int la3dm_ingest_rays(const float* hits, const int64_t* hit_keys,
                                 const float* origins, const int32_t* anchors, long long R,
                                 int Kf, float mr, float fr, float bs, float half, int P,
                                 int write, float* occ, float* seg, bool* inr, float* samples,
                                 int64_t* count, const int64_t* offsets, int64_t* pair_ray,
                                 int64_t* pair_key, void* stream) {
  if (R <= 0 || Kf < 0 || P < 8 * (Kf + 1) || P > 16384 || (P & (P - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (write)
    return launch<true>(hits, hit_keys, origins, anchors, R, Kf, mr, fr, bs, half, P, occ,
                        seg, inr, samples, count, offsets, pair_ray, pair_key, s);
  return launch<false>(hits, hit_keys, origins, anchors, R, Kf, mr, fr, bs, half, P, occ, seg,
                       inr, samples, count, offsets, pair_ray, pair_key, s);
}
