// K7a — the per-point passes of device scan ingest, hand-written for Hopper
// (sm_90a).
//
// Replaces the elementwise parts of la3dm_tpu/geometry/device_ingest.py::
// _ingest_scan: the outlier mask (_outlier_mask, lines 390-405) and the
// ds-voxel key of every raw point (_downsample, line 209), then, for every
// downsampled hit voxel, the range filter and the Kf + 2 free-space beam
// samples with their masks and voxel keys (lines 420-443).
//
// Two kernels:
// * ingest_points_kernel — a thread a raw point i of scan s: |p - origin_s|^2
//   <= lim (lim = (mr + sqrt(3) ds)^2) or the sentinel key; else the key of
//   floor(p * (1/leaf)).
// * ingest_beams_kernel — only the samples that exist, in the dense layout's
//   order (hit j, then slot k), and their count left on the device.  A tile
//   of 64 hits (32 for beams of more than 32 slots: the wrapper's choice) a
//   CTA of 256 threads; a thread a hit computes its scan, origin,
//   l = sqrt((dx^2 + dy^2) + dz^2), in range iff l <= mr && l > 0, and
//   ndir = diff / max(l, 1e-30) (three divisions, not a reciprocal) once,
//   and its kept count in closed form: 0 out of range, else
//   #{k < Kf : (float)(k+1) * fr < l} + (l > fr) + 1.  (float)(k+1) * fr is
//   non-decreasing in k, so the kept k < Kf are a prefix, whose end an
//   estimate l / fr finds and the plain version's own comparisons settle.
//   A scan of the counts by warps 0 and 1 gives each hit its place in the
//   tile, and the tile's place among the tiles is a decoupled look-back
//   (tile_scan.cuh) over tiles in launch order.  While warp 0 looks back,
//   the other warps stage the tile's first 1024 samples in shared memory: a
//   thread a sample, its hit by a search over the tile's offsets, its
//   distance d = (m+1) * fr (m < the prefix), l - fr (slot Kf) or 0 (the
//   origin), the sample origin + ndir * d and its key; then each round of
//   1024 leaves as two coalesced slabs (keys, coordinates).  Each hit's
//   in-range flag is written once.  The scans' origins and anchors (up to
//   64 scans) are staged in shared memory.  The launch is a programmatic
//   dependent launch (Hopper): its CTAs may be scheduled while the kernel
//   before it ends, and wait for that kernel before they read or write.
// What bounds them: bytes (a few dozen operations per row against 12-20
// bytes moved).  Built with --fmad=false: with FMA contraction the free
// samples would change voxel at cell boundaries.
//
// Keys: ingest_keys.cuh (scan-local, anchored at each scan's origin cell).

#include <cuda_runtime.h>
#include <stdint.h>

#include "ingest_keys.cuh"
#include "tile_scan.cuh"

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

constexpr int kBeamThreads = 256;
constexpr int kMaxTileHits = 64;             // hits a tile, at most (warps 0 and 1)
constexpr int kRound = 4 * kBeamThreads;     // samples staged a round
constexpr int kMaxScans = 64;                // scans whose origins are staged

struct BeamTile {
  float o[kMaxTileHits][3], n[kMaxTileHits][3], l[kMaxTileHits];
  int scan[kMaxTileHits], prefix[kMaxTileHits];  // kept k < Kf
  unsigned first[kMaxTileHits + 1];          // each hit's first sample; [nh] the tile's
  float pts[3 * kRound];                     // a round's samples
  int64_t keys[kRound];                      // and their keys
};

// Sample `at` of the tile into slot q of the round: its hit (the last h with
// first[h] <= at, which has samples), the slot m = at - first[h] of its
// kept samples, d = (m+1) * fr (m < the prefix), l - fr (slot Kf) or 0 (the
// origin), the sample origin + ndir * d and its key.
__device__ __forceinline__ void stage_sample(BeamTile& t, int nh, unsigned at, int q, float fr,
                                             float inv_leaf, const int32_t* anchors) {
  int lo = 0, hi = nh - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first[mid] <= at) lo = mid; else hi = mid - 1;
  }
  const int m = (int)(at - t.first[lo]), n = t.prefix[lo];
  const float l = t.l[lo];
  float d;
  if (m < n) {
    d = (float)(m + 1) * fr;
  } else if (m == n && l > fr) {
    d = l - fr;
  } else {
    d = 0.0f;
  }
  const float fx = t.o[lo][0] + t.n[lo][0] * d;
  const float fy = t.o[lo][1] + t.n[lo][1] * d;
  const float fz = t.o[lo][2] + t.n[lo][2] * d;
  t.pts[3 * q + 0] = fx;
  t.pts[3 * q + 1] = fy;
  t.pts[3 * q + 2] = fz;
  const int s = t.scan[lo];
  t.keys[q] = pack_key(s, (int)floorf(fx * inv_leaf), (int)floorf(fy * inv_leaf),
                       (int)floorf(fz * inv_leaf), anchors + 3 * s);
}

__global__ void __launch_bounds__(kBeamThreads)
ingest_beams_kernel(const float* __restrict__ hits,        // [R,3]
                    const int64_t* __restrict__ hit_keys,  // [R]
                    const float* __restrict__ origins,     // [K,3]
                    const int32_t* __restrict__ anchors,   // [K,3]
                    int R, int K, int Kf, float mr, float fr, float inv_leaf, int tile_hits,
                    float* __restrict__ fpts,              // [count,3] of [R*(Kf+2),3]
                    int64_t* __restrict__ fkeys,           // [count] of [R*(Kf+2)]
                    bool* __restrict__ inr_out,            // [R]
                    int32_t* __restrict__ count,           // the samples written
                    unsigned long long* __restrict__ look, unsigned epoch, int n_tiles) {
  __shared__ BeamTile t;
  __shared__ float s_origin[3 * kMaxScans];
  __shared__ int32_t s_anchor[3 * kMaxScans];
  __shared__ long long s_base;
  const int tid = threadIdx.x;
  // tiles in launch order: a CTA is dispatched after every CTA of a lower
  // index, so the tiles it looks back at are running or done (as CUB's
  // single-pass scan has it); no counter round trip before the loads
  const int tile = (int)blockIdx.x;
  const int j0 = tile * tile_hits;
  const int nh = R - j0 < tile_hits ? R - j0 : tile_hits;
  // a programmatic dependent launch: the CTA may start before the kernel
  // before it ends, and waits for it before it reads or writes anything
  asm volatile("griddepcontrol.wait;" ::: "memory");  // cudaGridDependencySynchronize
  // the scans' origins and anchors staged beside the hits' loads
  const bool staged = K <= kMaxScans;
  if (staged) {
    for (int i = tid; i < 3 * K; i += kBeamThreads) {
      s_origin[i] = origins[i];
      s_anchor[i] = anchors[i];
    }
  }
  const float* orig = staged ? s_origin : origins;
  const int32_t* anch = staged ? s_anchor : anchors;
  int64_t hkey = 0;
  float hx = 0.0f, hy = 0.0f, hz = 0.0f;
  if (tid < nh) {
    const int j = j0 + tid;
    hkey = hit_keys[j];
    hx = hits[3 * j + 0];
    hy = hits[3 * j + 1];
    hz = hits[3 * j + 2];
  }
  __syncthreads();
  unsigned c = 0;
  if (tid < nh) {  // a hit's work, once
    const int j = j0 + tid;
    const int s = (int)(hkey >> 48);
    const float ox = orig[3 * s + 0], oy = orig[3 * s + 1], oz = orig[3 * s + 2];
    const float dx = hx - ox;
    const float dy = hy - oy;
    const float dz = hz - oz;
    float l2 = dx * dx;
    l2 = l2 + dy * dy;
    l2 = l2 + dz * dz;
    const float l = sqrtf(l2);
    const bool inr = (l <= mr) && (l > 0.0f);
    const float den = fmaxf(l, 1e-30f);
    int n = 0;
    if (inr) {
      // the kept prefix: (float)n * fr < l and not (float)(n + 1) * fr < l
      const float est = l / fr;
      n = est < (float)Kf ? (int)est : Kf;
      while (n > 0 && !((float)n * fr < l)) --n;
      while (n < Kf && (float)(n + 1) * fr < l) ++n;
      c = (unsigned)n + (l > fr ? 1u : 0u) + 1u;
    }
    inr_out[j] = inr;
    t.o[tid][0] = ox;
    t.o[tid][1] = oy;
    t.o[tid][2] = oz;
    t.n[tid][0] = dx / den;
    t.n[tid][1] = dy / den;
    t.n[tid][2] = dz / den;
    t.l[tid] = l;
    t.scan[tid] = s;
    t.prefix[tid] = n;
  }
  // each hit's place in the tile: warps 0 and 1 hold the hits, one barrier
  __shared__ unsigned s_warp[2];
  const int lane = tid & 31;
  unsigned x = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(tile_scan::kAll, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31 && tid < 64) s_warp[tid >> 5] = x;
  __syncthreads();
  const unsigned tot = s_warp[0] + s_warp[1];
  if (tid < kMaxTileHits) t.first[tid] = (tid < 32 ? 0u : s_warp[0]) + x - c;
  if (tid == 0) t.first[kMaxTileHits] = tot;
  tile_scan::publish(look, epoch, tile, tot);
  __syncthreads();
  // warp 0 looks back while the others stage the first round
  const int n0 = tot < (unsigned)kRound ? (int)tot : kRound;
  if (tid < 32) {
    const unsigned long long before = tile_scan::place(look, epoch, tile, n_tiles, tot, count);
    if (tid == 0) s_base = (long long)before;
  } else {  // unrolled, so that the searches of a thread's samples overlap
#pragma unroll
    for (int k = 0; k < (kRound + kBeamThreads - 33) / (kBeamThreads - 32); ++k) {
      const int q = tid - 32 + k * (kBeamThreads - 32);
      if (q < n0) stage_sample(t, nh, (unsigned)q, q, fr, inv_leaf, anch);
    }
  }
  __syncthreads();
  const long long base = s_base;
  for (unsigned r0 = 0; r0 < tot; r0 += kRound) {
    const int nr = tot - r0 < (unsigned)kRound ? (int)(tot - r0) : kRound;
    if (r0 > 0) {
#pragma unroll
      for (int k = 0; k < kRound / kBeamThreads; ++k) {
        const int q = tid + k * kBeamThreads;
        if (q < nr) stage_sample(t, nh, r0 + q, q, fr, inv_leaf, anch);
      }
      __syncthreads();
    }
    // the round leaves as two slabs
    for (int i = tid; i < nr; i += kBeamThreads) fkeys[base + r0 + i] = t.keys[i];
    float* out = fpts + 3 * (base + r0);
    for (int i = tid; i < 3 * nr; i += kBeamThreads) out[i] = t.pts[i];
    if (r0 + kRound < tot) __syncthreads();
  }
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

// Launch ingest_beams_kernel on ``stream`` over R hits of K scans (1 <= R,
// R (Kf + 2) < 2^30), in tiles of ``tile_hits`` (1 to 64): fpts
// [R (Kf + 2), 3] and fkeys [R (Kf + 2)] get the samples that exist in order
// on their first *count rows; ``look`` (one word a tile, none of epoch
// ``epoch``) is kept by the caller.  Returns cudaGetLastError().
extern "C" int la3dm_ingest_beams(const float* hits, const int64_t* hit_keys,
                                  const float* origins, const int32_t* anchors,
                                  long long R, int K, int Kf, float mr, float fr,
                                  float inv_leaf, int tile_hits, float* fpts, int64_t* fkeys,
                                  bool* inr, int32_t* count, unsigned long long* look,
                                  unsigned epoch, void* stream) {
  if (R <= 0 || K <= 0 || Kf < 0 || R * (Kf + 2) >= (1LL << 30) || tile_hits < 1 ||
      tile_hits > kMaxTileHits || count == nullptr || look == nullptr || epoch == 0u)
    return (int)cudaErrorInvalidValue;
  const int tiles = (int)((R + tile_hits - 1) / tile_hits);
  // a programmatic dependent launch: the CTAs may start while the kernel
  // before them ends, and wait for it (griddepcontrol.wait)
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)tiles);
  cfg.blockDim = dim3(kBeamThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, ingest_beams_kernel, hits, hit_keys, origins, anchors, (int)R, K, Kf, mr, fr,
      inv_leaf, tile_hits, fpts, fkeys, inr, count, look, epoch, tiles);
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}
