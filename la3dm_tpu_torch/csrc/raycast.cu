// K6 — the device DDA of raycast, hand-written for Hopper (sm_90a).
//
// Replaces la3dm_tpu/models/raycast.py::_raycast_loop (lines 145-215):
// Amanatides-Woo stepping of each ray over the base-resolution voxel grid,
// reading each voxel's state through an open-addressing block-coord ->
// pool-slot hash and the int8 state table [cap+1, V] (raster order; row cap
// is the UNKNOWN guard of absent blocks).
//
// Design:
// * One ray a lane at a time.  The JAX step runs every ray in lockstep for
//   max_steps iterations; a stopped ray changes nothing after, so a lane
//   leaves its ray at its first hit or once t > max_range, with the same
//   hit, dist and steps.  One iteration keeps the JAX order: the current
//   voxel's state is checked, then the ray steps along the axis of the
//   smallest t_max (ties to the lowest axis, jnp.argmin's rule), so the
//   voxel reached by the last step is never checked.
// * The state lookup: p = idx * res (the voxel centre), blk = floor(p / bs
//   + 0.5), the block's pool slot from the hash, and the local index
//   trunc((p - blk * bs) / res + n / 2) clipped to [0, n - 1].  The slot:
//   the 30-bit hi / lo split of blk + 524288, the hash ((hi * HC1) ^ (lo *
//   HC2)) & (H - 1) computed in uint32 (it wraps in 32 bits, and signed
//   overflow is undefined in C++), then max_probes linear probes with the
//   JAX rule (stop at a match or an empty entry, hi == -1).
// * Per axis, blk and the local index are a pure function of that axis's
//   voxel index, and a step moves one axis: the lane keeps them in
//   registers and recomputes the stepped axis alone, in the same f32
//   operations (two divisions a step).
// * A block cache a ray: the slot is a pure function of blk under the
//   fixed table and max_probes, so the lane keeps it and looks it up again
//   only at the ray's first lookup and where blk changes; hit, dist and
//   steps cannot change.  A ray stays 2^(block_depth-1) voxels an edge in
//   one block, so most steps skip the hash.
// * Warp-cooperative probes: in SIMT a warp waits for the longest probe
//   chain of any of its lanes, and with one lane in six entering a block
//   on a step some lane almost always does (8 probes a lookup on the BGK
//   demo map, 15 on the BGKLV one, max_probes up to 128; two dependent
//   loads each).  So the lookups that probe are taken by the whole warp,
//   four rays a batch, eight lanes a ray: lane k of a ray's group reads
//   chain position base + k (eight a round, coalesced) and a ballot finds
//   the first that matches or is empty, the JAX walk's stop; a batch takes
//   as many rounds as its longest chain needs (one for chains of up to 8;
//   the BGK demo map's probing lookups walk 8.0 on average).
// * Lanes that refill (the "persistent while-while" traversal of Aila and
//   Laine, Understanding the Efficiency of Ray Traversal on GPUs, HPG
//   2009): one wave of CTAs, each lane starting on ray (global thread id);
//   once at least kRefill of a warp's lanes have stopped, they take the
//   next ray indices from the global counter ``next`` with one
//   warp-aggregated atomicAdd.  A warp no longer lasts as long as its
//   longest ray.  Results are written by ray index; each output has one
//   writer and none depends on the order.
// * Parity: every operation is the JAX step's f32 operation in its order
//   (divisions, not reciprocals; t_max += t_delta in f32; tiny = |d| <
//   1e-12 gives t_max = inf).  Built with --fmad=false.
// * ``counts`` (or null): [0] the lookups that probed (a ray's first and
//   each block change), [1] the probes the JAX walk takes for them; K6's
//   bound counts them.
// * What bounds it: the operations of the lookups and steps the rays take
//   on the CUDA cores (kernels/raycast.py's counts): 12 a lookup and step,
//   10 an axis (three at a ray's first lookup, the stepped one after), 13
//   for the key split and hash, which only the lookups that probe take, and
//   5 a probe.  The bytes that must move are the tables once (a few MB,
//   which stay in L2) and the rays' 24 in and 9 out.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr uint32_t kHC1 = 2654435769u;   // int32 -1640531527
constexpr uint32_t kHC2 = 3432918353u;   // int32 -862048943
constexpr int kKB = 524288;
constexpr int kThreads = 128;
constexpr int kProbeLanes = 8;  // lanes that probe one ray's chain together (< 32)
constexpr int kRefill = 4;      // a warp's idle lanes that take new rays together (1..32)
constexpr unsigned kAll = 0xffffffffu;

// The read-only tables (loaded through the read-only path, __ldg).
struct Tables {
  const int8_t* state_tab;   // [cap+1,V]
  const int32_t* tab_hi;     // [H]
  const int32_t* tab_lo;     // [H]
  const int32_t* tab_slot;   // [H]
  int cap, n, max_probes;
  uint32_t hmask;
  float res, bs;
};

// One ray's DDA state.  Per axis, the block coordinate and the local index
// of the current voxel are a pure function of that axis's voxel index (the
// JAX step's f32 expressions, axis_of), so a step recomputes them only on
// the axis it moved along; ``slot`` is the pool slot of the current block,
// looked up again only when the block changes (``pending``).
struct Ray {
  int64_t r;
  int idx[3], step[3];
  float t_max[3], t_delta[3];
  float t;
  int steps;
  int blk[3], v[3], slot;
  bool pending;
};

struct Out {
  bool* hit;
  float* dist;
  int32_t* steps;
};

__device__ __forceinline__ void finish(const Out& out, const Ray& q, bool hit, float dist) {
  out.hit[q.r] = hit;
  out.dist[q.r] = dist;
  out.steps[q.r] = q.steps;
}

// Block coordinate floor(p / bs + 0.5) and local index trunc((p - blk * bs)
// / res + n / 2), clipped to [0, n - 1], of voxel index i on one axis
// (p = i * res, the voxel centre).
__device__ __forceinline__ void axis_of(int i, const Tables& tb, float half_n, int& blk,
                                        int& v) {
  const float p = (float)i * tb.res;
  blk = (int)floorf(p / tb.bs + 0.5f);
  const float ctr = (float)blk * tb.bs;
  v = (int)((p - ctr) / tb.res + half_n);
  v = v < 0 ? 0 : (v > tb.n - 1 ? tb.n - 1 : v);
}

// Start ray r; false (its result written) where max_steps allows no step.
__device__ __forceinline__ bool ray_start(Ray& q, int64_t r, const float* __restrict__ origins,
                                          const float* __restrict__ dirs, const Tables& tb,
                                          float half_n, int max_steps, const Out& out) {
  const float res = tb.res;
  q.r = r;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float o = origins[3 * r + a];
    const float d = dirs[3 * r + a];
    q.idx[a] = (int)floorf(o / res + 0.5f);
    q.step[a] = d > 0.0f ? 1 : -1;
    const bool tiny = fabsf(d) < 1e-12f;
    const float safe_d = tiny ? 1e-12f : d;
    const float bound = (float)(q.idx[a] + (q.step[a] > 0 ? 1 : 0)) * res - res / 2.0f;
    q.t_max[a] = tiny ? CUDART_INF_F : (bound - o) / safe_d;
    q.t_delta[a] = fabsf(res / safe_d);
    axis_of(q.idx[a], tb, half_n, q.blk[a], q.v[a]);
  }
  q.t = 0.0f;
  q.steps = 0;
  q.pending = true;
  if (max_steps > 0) return true;
  finish(out, q, false, CUDART_INF_F);
  return false;
}

// The pool slots of the rays whose lanes ask (``want``: a ray's first
// lookup, or its block changed), probed by the whole warp: up to 32 / W
// rays a batch, one a group of W = kProbeLanes lanes.  Lane k of a group
// reads probe position base + k of its ray's chain, W positions a round,
// and the first position that matches or is empty (the JAX rule) ends that
// ray's walk; ``probes`` += the probes the JAX step's sequential walk takes
// there.
__device__ __forceinline__ void warp_probe(Ray& q, bool want, const Tables& tb, int lane,
                                           unsigned long long& probed,
                                           unsigned long long& probes) {
  constexpr int W = kProbeLanes;
  constexpr int kGroups = 32 / W;
  constexpr unsigned kGroupMask = (1u << W) - 1u;
  const int g = lane / W, k = lane % W;
  unsigned need = __ballot_sync(kAll, want);
  while (need) {
    unsigned rest = need;
#pragma unroll
    for (int i = 0; i < kGroups; ++i) rest &= rest - 1;
    const unsigned batch = need & ~rest;
    need = rest;
    // this group's ray: the g-th lane of the batch
    unsigned b = batch;
    for (int i = 0; i < g; ++i) b &= b - 1;
    const int src = b ? __ffs(b) - 1 : 0;
    const int c0 = __shfl_sync(kAll, q.blk[0], src) + kKB;
    const int c1 = __shfl_sync(kAll, q.blk[1], src) + kKB;
    const int c2 = __shfl_sync(kAll, q.blk[2], src) + kKB;
    // (the left shift through uint32: a negative field is defined there)
    const int32_t hi = (int32_t)((uint32_t)c0 << 10) | (c1 >> 10);
    const int32_t lo = ((c1 & 1023) << 20) | c2;
    const uint32_t h = (((uint32_t)hi * kHC1) ^ ((uint32_t)lo * kHC2)) & tb.hmask;
    bool done = b == 0;
    int slot = tb.cap, n = tb.max_probes;
    for (int base = 0;; base += W) {
      const int j = base + k;
      bool stop = false;
      int sl = tb.cap;
      if (!done && j < tb.max_probes) {
        const uint32_t pos = (h + (uint32_t)j) & tb.hmask;
        const int32_t th = __ldg(tb.tab_hi + pos);
        const int32_t tl = __ldg(tb.tab_lo + pos);
        const int32_t ts = __ldg(tb.tab_slot + pos);
        const bool match = th == hi && tl == lo;
        stop = match || th == -1;
        sl = match ? ts : tb.cap;
      }
      const unsigned m = (__ballot_sync(kAll, stop) >> (g * W)) & kGroupMask;
      const int f = m ? __ffs(m) - 1 : 0;
      const int got = __shfl_sync(kAll, sl, g * W + f);
      if (!done && m) {
        slot = got;
        n = base + f + 1;
        done = true;
      }
      done = done || base + W >= tb.max_probes;
      if (__all_sync(kAll, done)) break;
    }
    // each asking lane takes its group's result
    const int rank = __popc(batch & ((1u << lane) - 1u));
    const int my_slot = __shfl_sync(kAll, slot, (rank % kGroups) * W);
    const int my_n = __shfl_sync(kAll, n, (rank % kGroups) * W);
    if ((batch >> lane) & 1u) {
      q.slot = my_slot;
      q.pending = false;
      ++probed;
      probes += (unsigned long long)my_n;
    }
  }
}

// One iteration of ray q: check the current voxel, then step.  Returns
// whether the ray goes on (its result is written when it stops).  The step
// is worked out while the state load is in flight and kept only if the
// voxel is not a hit.
__device__ __forceinline__ bool ray_advance(Ray& q, const Tables& tb, float half_n,
                                            int max_steps, int target, float max_range,
                                            const Out& out) {
  const int n = tb.n;
  const int row = q.slot < tb.cap ? q.slot : tb.cap;
  const int vi = q.v[0] + q.v[1] * n + q.v[2] * (n * n);
  const int state = (int)__ldg(tb.state_tab + (size_t)row * (n * n * n) + vi);
  // the step along the axis of the smallest t_max (ties: the lowest);
  // selects keep the arrays in registers, and the stepped axis alone gets
  // its block coordinate and local index anew
  int ax = 0;
  if (q.t_max[1] < q.t_max[ax]) ax = 1;
  if (q.t_max[2] < q.t_max[ax]) ax = 2;
  float t = 0.0f, tm = 0.0f;
  int i = 0, old_blk = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (a == ax) {
      t = q.t_max[a];
      tm = q.t_max[a] + q.t_delta[a];
      i = q.idx[a] + q.step[a];
      old_blk = q.blk[a];
    }
  }
  int nb, nv;
  axis_of(i, tb, half_n, nb, nv);
  if (state == target) {
    finish(out, q, true, q.t);
    return false;
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    if (a == ax) {
      q.t_max[a] = tm;
      q.idx[a] = i;
      q.blk[a] = nb;
      q.v[a] = nv;
    }
  }
  q.t = t;
  q.pending = nb != old_blk;
  ++q.steps;
  if (q.t <= max_range && q.steps < max_steps) return true;
  finish(out, q, false, CUDART_INF_F);
  return false;
}

__global__ void __launch_bounds__(kThreads)
raycast_kernel(Tables tb, const float* __restrict__ origins,   // [N,3]
               const float* __restrict__ dirs,                 // [N,3]
               int64_t N, int max_steps, int target, float max_range,
               unsigned long long* __restrict__ next,          // [1] zeroed
               unsigned long long* __restrict__ counts,        // [2] or null
               Out out) {
  const int lane = threadIdx.x & 31;
  const float half_n = (float)tb.n / 2.0f;
  const int64_t first = (int64_t)gridDim.x * blockDim.x;  // rays taken at the start
  unsigned long long probed = 0, probes = 0;
  Ray q;
  const int64_t r0 = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  bool live = r0 < N && ray_start(q, r0, origins, dirs, tb, half_n, max_steps, out);
  bool more = first < N;  // rays left for refills (warp-uniform)
  for (;;) {
    warp_probe(q, live && q.pending, tb, lane, probed, probes);
    if (live) live = ray_advance(q, tb, half_n, max_steps, target, max_range, out);
    const unsigned idle = __ballot_sync(kAll, !live);
    if (!more) {
      if (idle == kAll) break;
      continue;
    }
    const int n_idle = __popc(idle);
    if (n_idle < kRefill) continue;
    const int leader = __ffs(idle) - 1;
    unsigned long long base = 0;
    if (lane == leader) base = atomicAdd(next, (unsigned long long)n_idle);
    base = __shfl_sync(kAll, base, leader);
    if (!live) {
      const int64_t r = first + (int64_t)base + __popc(idle & ((1u << lane) - 1u));
      if (r < N) live = ray_start(q, r, origins, dirs, tb, half_n, max_steps, out);
    }
    more = first + (int64_t)base + n_idle < N;
  }
  if (counts != nullptr) {
    atomicAdd(&counts[0], probed);
    atomicAdd(&counts[1], probes);
  }
}

// Resident CTAs of raycast_kernel on the current device (one wave).
int resident_ctas() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, raycast_kernel, kThreads, 0) !=
            cudaSuccess)
      return 0;
    cached[dev] = sms * per_sm;
  }
  return cached[dev];
}

}  // namespace

// Launch K6 on ``stream``: one wave of CTAs whose lanes take further rays
// from ``next`` (an int64 [1] zeroed before the launch) once kRefill lanes
// of a warp are idle.  ``counts`` (or null) += (lookups that probed,
// probes).  Returns cudaGetLastError().
extern "C" int la3dm_raycast(const int8_t* state_tab, const int32_t* tab_hi,
                             const int32_t* tab_lo, const int32_t* tab_slot,
                             const float* origins, const float* dirs, long long N, int cap,
                             int H, int n, int max_steps, int target, int max_probes,
                             float res, float bs, float max_range, unsigned long long* next,
                             unsigned long long* counts, bool* hit, float* dist,
                             int32_t* steps, void* stream) {
  if (N <= 0 || cap < 0 || H <= 0 || (H & (H - 1)) != 0 || n <= 0 || next == nullptr)
    return (int)cudaErrorInvalidValue;
  const int wave = resident_ctas();
  if (wave <= 0) return (int)cudaErrorInvalidValue;
  long long grid = (N + kThreads - 1) / kThreads;
  if (grid > wave) grid = wave;
  const Tables tb{state_tab, tab_hi, tab_lo, tab_slot, cap, n, max_probes,
                  (uint32_t)(H - 1), res, bs};
  raycast_kernel<<<(unsigned)grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tb, origins, dirs, N, max_steps, target, max_range, next, counts,
      Out{hit, dist, steps});
  return (int)cudaGetLastError();
}
