// K7d — the BGKL ray pass of device scan ingest, hand-written for Hopper
// (sm_90a).
//
// Replaces the per-ray part of la3dm_tpu/geometry/device_ingest.py::
// _ingest_scan_bgkl (lines 497-574): for every downsampled hit of scan s,
// all in f32,
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
// bgkloctomap.cpp:145-172.  The pair list is in ray order, each ray's keys
// ascending, as ray_pairs_plain's torch.sort leaves it.
//
// Dedup by contiguity along the ray (the JAX docstring, :503-506).  A line
// meets a closed box in one interval of its parameter, and this holds for
// the f32 samples exactly:
// * d = l - k * fr is non-increasing in k (a rounded product or sum is
//   monotone in each argument), and the origin is the sample at d = 0
//   (o + ndir * 0 = o, a signed zero at most, which no test tells apart);
// * on each axis p = o + n * d is monotone in d, and so are
//   floor(p / bs + 0.5) and each closed-box test ctr - half <= p <= ctr + half
//   for a fixed block coordinate; the two boxes c and c + 2 never both hold
//   p, so the rule's choice between base + 1 and base - 1 never drops a
//   membership;
// * so the samples that hold a given block form one run in d-order
//   (k = 1, 2, ... while d > 0, then the origin; the others are not kept).
// Hence a membership of a kept sample is the ray's first occurrence of its
// block exactly when it is not a membership of the kept sample before it in
// d-order.  A sample's memberships are the product of its per-axis sets
// (base if its test holds, the second candidate if its test holds), so that
// test is three per-axis lookups in the previous sample's two fields an
// axis: no sort is needed to find the set.
//
// Design:
// * A ray takes L lanes, the power of two >= Kf + 1 up to a warp (32 / L
//   rays a warp), one sample a lane in d-order; rays of more than 32 samples
//   run in chunks of 32, each carrying the last kept sample of the chunk
//   before.  A lane finds the kept sample before it by a ballot and takes its
//   per-axis fields (4 words) by one shuffle each.
// * Count pass (one launch): each ray's number of distinct keys; per tile of
//   TR rays their offsets in the tile, the tile's total and the longest row;
//   the last CTA to finish (an atomic counter) turns the tiles' totals into
//   their offsets and writes the list's size.  Each sample leaves one
//   8-byte word in the workspace: its first occurrences (8 bits) and its
//   per-axis base fields with the second candidate's step from them (a
//   record).  Also occ, the segment, inr and, if asked, the samples.  The
//   C entry queues a memset of the header before it and a copy of the two
//   sizes to the host after it: the wrapper waits once for them, to
//   allocate the list.
// * Write pass (one launch): no sample is computed again.  A ray's lanes
//   read its records; its distinct keys (its row, a few tens) are staged in
//   shared memory by a segmented prefix over the lanes, and each key goes
//   to the ray's offset plus its rank, the number of the row's keys below
//   it (the keys are distinct, so the ranks are).  A CTA holds as many
//   warps as the longest row's staging lets it.
// * What bounds it: operations (about 60 a sample for its position and
//   memberships, the dedup's 12 comparisons, the ranks: m^2 comparisons a
//   row of m keys); the bytes are small (12 in and about 60 out a ray, 16 a
//   pair, and a record a sample slot written and read between the
//   passes).  Built with --fmad=false: with FMA contraction the samples,
//   hence the block memberships on a face, would change.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ingest_keys.cuh"

namespace {

constexpr int kWarp = 32;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kCountWarps = 8;
constexpr int kMaxTileRays = 256;
constexpr int kSmemDefault = 48 * 1024;
constexpr int kSmemMax = 227 * 1024;

// the workspace: status (int64: the list's size, the longest row), the done
// counter, then the tiles' offsets [n_tiles] int64, the rays' offsets in
// their tile [R] int32 and the records [R, chunks * L] uint64
constexpr size_t kHeader = 32;

// the records' byte offset in the workspace
__host__ __device__ __forceinline__ size_t records_at(long long R, long long n_tiles) {
  return (kHeader + 8 * (size_t)n_tiles + 4 * (size_t)R + 7) & ~(size_t)7;
}

struct Geometry {
  int S;       // samples a ray (Kf + 1)
  int L;       // lanes a ray
  int G;       // rays a warp
  int chunks;  // ceil(S / L)
  int TR;      // rays a count tile
};

Geometry geometry(int Kf) {
  Geometry g;
  g.S = Kf + 1;
  g.L = 1;
  while (g.L < g.S && g.L < kWarp) g.L <<= 1;
  g.G = kWarp / g.L;
  g.chunks = (g.S + g.L - 1) / g.L;
  g.TR = 64 > kCountWarps * g.G ? 64 : kCountWarps * g.G;
  return g;
}

struct Rays {
  const float* hits;
  const int64_t* hit_keys;
  const float* origins;
  const int32_t* anchors;
  long long R;
  int Kf;
  float mr, fr, bs, half;
};

struct Ray {
  int s;
  float ox, oy, oz, nx, ny, nz, l;
  bool inr;
};

__device__ __forceinline__ Ray load_ray(const Rays& a, long long r) {
  Ray y;
  if (r >= a.R) {
    y.s = 0;
    y.ox = y.oy = y.oz = y.nx = y.ny = y.nz = y.l = 0.0f;
    y.inr = false;
    return y;
  }
  y.s = (int)(a.hit_keys[r] >> 48);
  y.ox = a.origins[3 * y.s + 0];
  y.oy = a.origins[3 * y.s + 1];
  y.oz = a.origins[3 * y.s + 2];
  const float dx = a.hits[3 * r + 0] - y.ox;
  const float dy = a.hits[3 * r + 1] - y.oy;
  const float dz = a.hits[3 * r + 2] - y.oz;
  float l2 = dx * dx;
  l2 = l2 + dy * dy;
  l2 = l2 + dz * dz;
  y.l = sqrtf(l2);
  y.inr = (y.l <= a.mr) && (y.l > 0.0f);
  const float den = fmaxf(y.l, 1e-30f);
  y.nx = dx / den;
  y.ny = dy / den;
  y.nz = dz / den;
  return y;
}

// One sample's per-axis membership sets: f[a] = the base block's key field
// | the second candidate's << 16; flags: bit a the base test on axis a, bit
// 3 + a the second's, bit 6 the sample kept.
struct Sets {
  uint32_t f[3];
  uint32_t flags;
};

constexpr uint32_t kKept = 1u << 6;

// sample k (0: the origin) of ray y: its position p and its sets
__device__ __forceinline__ Sets sample_sets(const Ray& y, int k, const Rays& a, float p[3]) {
  bool ok;
  if (k == 0) {
    p[0] = y.ox;
    p[1] = y.oy;
    p[2] = y.oz;
    ok = y.inr;
  } else {
    const float d = y.l - (float)k * a.fr;
    ok = y.inr && d > 0.0f;
    p[0] = y.ox + y.nx * d;
    p[1] = y.oy + y.ny * d;
    p[2] = y.oz + y.nz * d;
  }
  Sets q;
  q.flags = ok ? kKept : 0u;
  const int32_t* anchor = a.anchors + 3 * y.s;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const int b = (int)floorf(p[ax] / a.bs + 0.5f);
    bool in[3];  // base, base + 1, base - 1
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float ctr = (float)(b + (c == 0 ? 0 : (c == 1 ? 1 : -1))) * a.bs;
      in[c] = (ctr - a.half <= p[ax]) && (p[ax] <= ctr + a.half);
    }
    const int second = in[1] ? b + 1 : b - 1;
    q.f[ax] = (uint32_t)key_field(b, anchor[ax]) | ((uint32_t)key_field(second, anchor[ax]) << 16);
    q.flags |= (in[0] ? 1u << ax : 0u) | ((in[1] || in[2]) ? 1u << (3 + ax) : 0u);
  }
  return q;
}

// the first occurrences among sample q's memberships (bit j: x from bit 2,
// y bit 1, z bit 0 of j, 1 = the second candidate), given the kept sample
// before it in d-order (prev.flags == 0: none)
__device__ __forceinline__ unsigned first_members(const Sets& q, const Sets& prev) {
  if (!(q.flags & kKept)) return 0u;
  bool mb[3], ms[3], ib[3], is[3];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const uint32_t fb = q.f[ax] & 0xFFFFu, fs = q.f[ax] >> 16;
    const uint32_t pb = prev.f[ax] & 0xFFFFu, ps = prev.f[ax] >> 16;
    const bool pbo = (prev.flags >> ax) & 1u, pso = (prev.flags >> (3 + ax)) & 1u;
    mb[ax] = (q.flags >> ax) & 1u;
    ms[ax] = (q.flags >> (3 + ax)) & 1u;
    ib[ax] = (pbo && fb == pb) || (pso && fb == ps);
    is[ax] = (pbo && fs == pb) || (pso && fs == ps);
  }
  const bool pk = prev.flags & kKept;
  unsigned first = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int bx = (j >> 2) & 1, by = (j >> 1) & 1, bz = j & 1;
    const bool m = (bx ? ms[0] : mb[0]) && (by ? ms[1] : mb[1]) && (bz ? ms[2] : mb[2]);
    const bool seen = pk && (bx ? is[0] : ib[0]) && (by ? is[1] : ib[1]) && (bz ? is[2] : ib[2]);
    if (m && !seen) first |= 1u << j;
  }
  return first;
}

// A sample's record: bits 0-47 its base fields x, y, z (16 bits each), bits
// 48-53 the second candidate's field minus the base's, plus 1, two bits an
// axis (the fields clamp, so the step is -1, 0 or 1), bits 56-63 its first
// occurrences.
__device__ __forceinline__ uint64_t pack_record(const Sets& q, unsigned first) {
  uint64_t rec = (uint64_t)first << 56;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const uint32_t fb = q.f[ax] & 0xFFFFu, fs = q.f[ax] >> 16;
    rec |= (uint64_t)fb << (16 * ax);
    rec |= (uint64_t)(fs + 1u - fb) << (48 + 2 * ax);
  }
  return rec;
}

// membership j's key (bit 2 of j: x, bit 1: y, bit 0: z; 1 = the second
// candidate) of a record of scan s
__device__ __forceinline__ int64_t record_key(int s, uint64_t rec, int j) {
  int64_t key = (int64_t)s << 48;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    int64_t f = (int64_t)((rec >> (16 * ax)) & 0xFFFFu);
    if ((j >> (2 - ax)) & 1) f += (int64_t)((rec >> (48 + 2 * ax)) & 3u) - 1;
    key |= f << (16 * ax);
  }
  return key;
}

// Walk one ray's samples in d-order on its L lanes (every lane of the warp
// calls it; lane j of segment sg).  Returns the ray's number of distinct
// keys in every lane of the segment; with ``rec``, writes each sample's
// record there (slot i: the sample i in d-order); with ``samples``, each
// sample's position.
__device__ int walk_ray(const Ray& y, const Rays& a, const Geometry& g, int sg, int j,
                        float* samples, uint64_t* rec) {
  const int lane = threadIdx.x & (kWarp - 1);
  const unsigned seg_mask = g.L == kWarp ? kAll : ((1u << g.L) - 1u) << (sg * g.L);
  const unsigned below = (1u << lane) - 1u;
  Sets carry{{0u, 0u, 0u}, 0u};
  int n = 0;
  for (int c = 0; c < g.chunks; ++c) {
    const int i = c * g.L + j;  // the sample's place in d-order: k = i + 1, the origin last
    const int k = i < a.Kf ? i + 1 : 0;
    float p[3];
    Sets q = sample_sets(y, k, a, p);
    if (i >= g.S) q.flags = 0u;
    if (samples != nullptr && i < g.S) {
      samples[3 * k + 0] = p[0];
      samples[3 * k + 1] = p[1];
      samples[3 * k + 2] = p[2];
    }
    const unsigned kept = __ballot_sync(kAll, (q.flags & kKept) != 0u) & seg_mask;
    const unsigned before = kept & below;
    const int src = before ? 31 - __clz(before) : lane;
    Sets prev;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) prev.f[ax] = __shfl_sync(kAll, q.f[ax], src);
    prev.flags = __shfl_sync(kAll, q.flags, src);
    if (!before) prev = carry;
    const unsigned first = first_members(q, prev);
    if (rec != nullptr) rec[i] = pack_record(q, first);
    // the chunk's last kept sample carries into the next chunk
    const int last = kept ? 31 - __clz(kept) : lane;
    Sets tail;
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) tail.f[ax] = __shfl_sync(kAll, q.f[ax], last);
    tail.flags = __shfl_sync(kAll, q.flags, last);
    if (kept) carry = tail;
    int m = __popc(first);
    for (int o = g.L >> 1; o > 0; o >>= 1) m += __shfl_xor_sync(kAll, m, o, g.L);
    n += m;
  }
  return n;
}

// Stage one ray's distinct keys (scan s) from its records, in d-order, at
// most ``cap`` of them (the same walk as walk_ray's, on the lanes' records).
// Returns the ray's number of distinct keys in every lane of the segment.
__device__ int stage_ray(const uint64_t* rec, int s, const Geometry& g, int j,
                         int64_t* stage, int cap) {
  int n = 0;
  for (int c = 0; c < g.chunks; ++c) {
    const uint64_t r = rec != nullptr ? __ldg(&rec[c * g.L + j]) : 0u;
    const unsigned first = (unsigned)(r >> 56);
    const int mine = __popc(first);
    int incl = mine;
    for (int o = 1; o < g.L; o <<= 1) {
      const int t = __shfl_up_sync(kAll, incl, o, g.L);
      if (j >= o) incl += t;
    }
    int pos = n + incl - mine;
    for (unsigned f = first; f; f &= f - 1u, ++pos)
      if (pos < cap) stage[pos] = record_key(s, r, __ffs(f) - 1);
    n += __shfl_sync(kAll, incl, g.L - 1, g.L);
  }
  return n;
}

// exclusive sum of one int a thread over the CTA (256 threads); *total the
// CTA's sum
__device__ __forceinline__ long long cta_exclusive_sum(long long v, long long* total) {
  __shared__ long long ws[kCountWarps];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  long long x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long t = __shfl_up_sync(kAll, x, o);
    if (lane >= o) x += t;
  }
  if (lane == 31) ws[wid] = x;
  __syncthreads();
  long long pre = 0, all = 0;
  for (int w = 0; w < kCountWarps; ++w) {
    if (w < wid) pre += ws[w];
    all += ws[w];
  }
  __syncthreads();
  *total = all;
  return pre + x - v;
}

__global__ void __launch_bounds__(kCountWarps * kWarp)
ingest_rays_count_kernel(Rays a, Geometry g, float* __restrict__ occ, float* __restrict__ seg,
                         bool* __restrict__ inr_out, float* __restrict__ samples,
                         char* __restrict__ work, int n_tiles) {
  __shared__ int s_cnt[kMaxTileRays];
  __shared__ bool s_last;
  long long* status = reinterpret_cast<long long*>(work);
  unsigned* done = reinterpret_cast<unsigned*>(work + 16);
  long long* tile_off = reinterpret_cast<long long*>(work + kHeader);
  int* off_local = reinterpret_cast<int*>(work + kHeader + 8 * (size_t)n_tiles);
  uint64_t* records = reinterpret_cast<uint64_t*>(work + records_at(a.R, n_tiles));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sg = lane / g.L, j = lane % g.L;
  const long long r0 = (long long)blockIdx.x * g.TR;
  for (int t0 = warp * g.G; t0 < g.TR; t0 += kCountWarps * g.G) {
    const int t = t0 + sg;
    const long long r = r0 + t;
    const Ray y = load_ray(a, r);
    if (r < a.R && j == 0) {
      occ[3 * r + 0] = y.ox + y.nx * y.l;
      occ[3 * r + 1] = y.oy + y.ny * y.l;
      occ[3 * r + 2] = y.oz + y.nz * y.l;
      const float dl = y.l - a.fr;
      seg[6 * r + 0] = y.ox;
      seg[6 * r + 1] = y.oy;
      seg[6 * r + 2] = y.oz;
      seg[6 * r + 3] = y.ox + y.nx * dl;
      seg[6 * r + 4] = y.oy + y.ny * dl;
      seg[6 * r + 5] = y.oz + y.nz * dl;
      inr_out[r] = y.inr;
    }
    float* my_samples =
        (samples != nullptr && r < a.R) ? samples + 3 * (size_t)r * g.S : nullptr;
    uint64_t* my_rec = r < a.R ? records + (size_t)r * g.chunks * g.L : nullptr;
    const int n = walk_ray(y, a, g, sg, j, my_samples, my_rec);
    if (j == 0) s_cnt[t] = n;
  }
  __syncthreads();
  const int v = threadIdx.x < g.TR ? s_cnt[threadIdx.x] : 0;
  long long tile_total;
  const long long ex = cta_exclusive_sum(v, &tile_total);
  const long long r = r0 + threadIdx.x;
  if (threadIdx.x < g.TR && r < a.R) off_local[r] = (int)ex;
  int longest = v;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) longest = max(longest, __shfl_xor_sync(kAll, longest, o));
  if (lane == 0 && longest > 0) atomicMax(&status[1], (long long)longest);
  if (threadIdx.x == 0) {
    tile_off[blockIdx.x] = tile_total;
    __threadfence();
    s_last = atomicAdd(done, 1u) == (unsigned)(n_tiles - 1);
  }
  __syncthreads();
  if (!s_last) return;
  // the last CTA: the tiles' totals → their offsets, and the list's size
  __threadfence();
  long long carry = 0;
  for (int b = 0; b < n_tiles; b += kCountWarps * kWarp) {
    const int i = b + threadIdx.x;
    const long long x = i < n_tiles ? __ldcg(&tile_off[i]) : 0;
    long long sum;
    const long long e = cta_exclusive_sum(x, &sum);
    if (i < n_tiles) tile_off[i] = carry + e;
    carry += sum;
  }
  if (threadIdx.x == 0) status[0] = carry;
}

__global__ void ingest_rays_write_kernel(Rays a, Geometry g, int cap, long long n_pairs,
                                         const char* __restrict__ work, int n_tiles,
                                         int64_t* __restrict__ pair_ray,
                                         int64_t* __restrict__ pair_key) {
  extern __shared__ int64_t smem[];
  const long long* tile_off = reinterpret_cast<const long long*>(work + kHeader);
  const int* off_local = reinterpret_cast<const int*>(work + kHeader + 8 * (size_t)n_tiles);
  const uint64_t* records = reinterpret_cast<const uint64_t*>(work + records_at(a.R, n_tiles));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sg = lane / g.L, j = lane % g.L;
  const int wpb = blockDim.x / kWarp;
  const long long r = ((long long)blockIdx.x * wpb + warp) * g.G + sg;
  int64_t* stage = smem + (size_t)(warp * g.G + sg) * cap;
  const bool live = r < a.R;
  const int m = stage_ray(live ? records + (size_t)r * g.chunks * g.L : nullptr,
                          live ? (int)(a.hit_keys[r] >> 48) : 0, g, j, stage, cap);
  __syncwarp();
  if (r >= a.R || m > cap) return;
  const long long off = tile_off[r / g.TR] + off_local[r];
  if (off + m > n_pairs) return;
  for (int t = j; t < m; t += g.L) {
    const int64_t key = stage[t];
    int rank = 0;
    for (int u = 0; u < m; ++u) rank += stage[u] < key;
    pair_ray[off + rank] = r;
    pair_key[off + rank] = key;
  }
}

Rays make_rays(const float* hits, const int64_t* hit_keys, const float* origins,
               const int32_t* anchors, long long R, int Kf, float mr, float fr, float bs,
               float half) {
  return Rays{hits, hit_keys, origins, anchors, R, Kf, mr, fr, bs, half};
}

size_t workspace_bytes(long long R, int Kf) {
  const Geometry g = geometry(Kf);
  const long long n_tiles = (R + g.TR - 1) / g.TR;
  return records_at(R, n_tiles) + 8 * (size_t)R * g.chunks * g.L;
}

}  // namespace

// Workspace bytes K7d needs for R rays of Kf + 1 samples.
extern "C" long long la3dm_ingest_rays_workspace(long long R, int Kf) {
  return (long long)workspace_bytes(R, Kf);
}

// Queue K7d's count pass on ``stream`` (1 <= R, 0 <= Kf, 8 (Kf + 1) <= 16384):
// a memset of the workspace's header, the kernel (occ, seg, inr, samples if
// non-null; each ray's offset in the list), then a copy of the list's size
// and the longest row (two int64) to ``host_sizes`` (pinned).  Returns
// cudaGetLastError().
extern "C" int la3dm_ingest_rays_count(const float* hits, const int64_t* hit_keys,
                                       const float* origins, const int32_t* anchors,
                                       long long R, int Kf, float mr, float fr, float bs,
                                       float half, void* work, long long work_bytes,
                                       long long* host_sizes, float* occ, float* seg,
                                       bool* inr, float* samples, void* stream) {
  if (R <= 0 || Kf < 0 || 8LL * (Kf + 1) > 16384 ||
      work_bytes < (long long)workspace_bytes(R, Kf))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geometry g = geometry(Kf);
  const long long n_tiles = (R + g.TR - 1) / g.TR;
  if (n_tiles >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  char* w = static_cast<char*>(work);
  cudaError_t e = cudaMemsetAsync(w, 0, kHeader, s);
  if (e != cudaSuccess) return (int)e;
  ingest_rays_count_kernel<<<(unsigned)n_tiles, kCountWarps * kWarp, 0, s>>>(
      make_rays(hits, hit_keys, origins, anchors, R, Kf, mr, fr, bs, half), g, occ, seg, inr,
      samples, w, (int)n_tiles);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaMemcpyAsync(host_sizes, w, 2 * sizeof(long long), cudaMemcpyDeviceToHost, s);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Queue K7d's write pass on ``stream``: the (ray, key) pairs of the count
// pass's workspace into pair_ray / pair_key [n_pairs] int64, ``cap`` the
// longest row (both from the count pass's sizes).  A ray whose row would
// pass ``cap`` or the list's end is not written.  Returns cudaGetLastError().
extern "C" int la3dm_ingest_rays_write(const float* hits, const int64_t* hit_keys,
                                       const float* origins, const int32_t* anchors,
                                       long long R, int Kf, float mr, float fr, float bs,
                                       float half, const void* work, long long work_bytes,
                                       int cap, long long n_pairs, int64_t* pair_ray,
                                       int64_t* pair_key, void* stream) {
  if (R <= 0 || Kf < 0 || 8LL * (Kf + 1) > 16384 || cap < 0 || n_pairs < 0 ||
      work_bytes < (long long)workspace_bytes(R, Kf))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geometry g = geometry(Kf);
  const long long n_tiles = (R + g.TR - 1) / g.TR;
  const int row = cap > 0 ? cap : 1;
  const size_t per_warp = (size_t)g.G * row * sizeof(int64_t);
  if (per_warp > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  int wpb = (int)(kSmemDefault / per_warp);
  wpb = wpb < 1 ? 1 : (wpb > 8 ? 8 : wpb);
  const size_t smem = (size_t)wpb * per_warp;
  if (smem > (size_t)kSmemDefault) {
    const cudaError_t e = cudaFuncSetAttribute(
        ingest_rays_write_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long groups = (R + g.G - 1) / g.G;
  const long long grid = (groups + wpb - 1) / wpb;
  ingest_rays_write_kernel<<<(unsigned)grid, wpb * kWarp, smem, s>>>(
      make_rays(hits, hit_keys, origins, anchors, R, Kf, mr, fr, bs, half), g, row, n_pairs,
      static_cast<const char*>(work), (int)n_tiles, pair_ray, pair_key);
  return (int)cudaGetLastError();
}
