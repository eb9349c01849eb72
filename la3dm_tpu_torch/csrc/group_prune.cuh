// The bottom-up prune of K2 (csrc/bgk_light.cu), K5 (csrc/gp_light.cu) and
// K8 (csrc/lv_prune.cu): the group-collapse test as votes over a Morton
// order.
//
// The port of la3dm_tpu/models/pruning.py::prune_blocks.  Levels L = 1..
// max_level: a 2^L-aligned group collapses iff every member has eff == L-1
// and the group's minimum-corner state, and that state is not UNKNOWN; the
// group takes the corner's f0, f1, touched and state, and eff = L.  The
// prune only compares and copies, so it is bit-exact in any order.
//
// Thread t of a CTA holds the N items at Morton indices N*t .. N*t + N-1
// (N = 1, 2 or 4 a kernel): the bits of an index interleave x, y and z
// (bit 0 = x0, bit 1 = y0, bit 2 = z0, bit 3 = x1, ...), so a group of 8^k
// items is the 8^k / N consecutive threads from a multiple of that, and its
// first thread's first item is its minimum corner.  The items are the
// voxels of a cube of edge <= 8 (K2's and K5's block of n <= 8 or 8^3 tile
// of a larger block, K8's tile), whose global loads and stores stay raster
// (a thread's N raster-consecutive voxels): the kernels pass them through
// shared memory; or, in a block's last CTA, the block's tiles (their
// summaries: eff and state where uniform over the tile, else -1, and the
// corner voxel's f0, f1, touched).
//
// The test per group is an AND over its threads, O(N) work a thread a
// level: a group within a warp is a segment of one ballot; a group of
// several warps (64 or 512 items with N = 1, 512 with N = 2 or 4) the
// per-warp votes of its warps in shared memory, one __syncthreads() a
// level.  Each thread reads the corner's values once (a shuffle, or its
// warp's vote).
//
// The Morton order's Python twin is kernels/group_prune.py (the tests
// hold it).

#pragma once

#include <stdint.h>

namespace la3dm {

// The raster voxel (within its block of edge n >= 16) of voxel vt of 8^3
// tile pos; tiles and their voxels are both raster, x fastest (K2's and
// K5's raster pools, whose tiles are not permuted).
__device__ __forceinline__ int tile_voxel(int pos, int vt, int n) {
  const int tpa = n / 8;
  const int tx = pos % tpa, ty = (pos / tpa) % tpa, tz = pos / (tpa * tpa);
  const int lx = vt % 8, ly = (vt / 8) % 8, lz = vt / 64;
  return (tx * 8 + lx) + (ty * 8 + ly) * n + (tz * 8 + lz) * n * n;
}

namespace vote {

constexpr int8_t kUnknown = 2;
constexpr int kMaxWarps = 16;    // 512 threads a CTA
constexpr int kMaxItems = 512;   // items a CTA: a tile, or a block's tiles
constexpr unsigned kFull = 0xffffffffu;

// Coordinates of Morton index t (< 512) in its cube.
__device__ __forceinline__ int morton_x(int t) {
  return (t & 1) | ((t >> 2) & 2) | ((t >> 4) & 4);
}
__device__ __forceinline__ int morton_y(int t) {
  return ((t >> 1) & 1) | ((t >> 3) & 2) | ((t >> 5) & 4);
}
__device__ __forceinline__ int morton_z(int t) {
  return ((t >> 2) & 1) | ((t >> 4) & 2) | ((t >> 6) & 4);
}
// The raster index (x fastest) of Morton index t in a cube of edge e <= 8.
__device__ __forceinline__ int morton_raster(int t, int e) {
  return morton_x(t) + e * (morton_y(t) + e * morton_z(t));
}

// One item: a voxel, or a tile's summary.  eff = -1 marks a slot that holds
// no item (or a tile whose effs differ): it never collapses.
struct Item {
  float f0, f1;
  int8_t eff, state;
  uint8_t touched;
};

__device__ __forceinline__ Item no_item() { return Item{0.f, 0.f, (int8_t)-1, (int8_t)-1, 0}; }

// A warp's vote: its lane 0's first item, and whether every item of the
// warp has lane 0's eff and state.
struct WarpVote {
  float f0, f1;
  int8_t eff, state;
  uint8_t touched;
  bool same_eff, same_state;
};

// The vote scratch of a CTA: two buffers, so that a level's votes never
// overwrite those the level before may still be reading.
struct Votes {
  WarpVote w[2][kMaxWarps];
};

template <int N>
__device__ __forceinline__ WarpVote warp_vote(const Item (&it)[N]) {
  const int8_t e0 = (int8_t)__shfl_sync(kFull, (int)it[0].eff, 0);
  const int8_t s0 = (int8_t)__shfl_sync(kFull, (int)it[0].state, 0);
  bool e = true, s = true;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    e = e && it[j].eff == e0;
    s = s && it[j].state == s0;
  }
  return WarpVote{it[0].f0, it[0].f1, e0, s0, it[0].touched, __all_sync(kFull, e) != 0,
                  __all_sync(kFull, s) != 0};
}

// Levels first .. first + levels - 1 over the CTA's items, thread t holding
// items N*t .. N*t + N-1; the k-th of them collapses groups of 8^k items
// (8^k <= 512).  Every thread of the CTA calls this (blockDim.x a multiple
// of 32, at most 512).  A group's state must be >= 0 (a tile summary's -1:
// its states differ) and not UNKNOWN.
template <int N>
__device__ __forceinline__ void prune_levels(Item (&it)[N], int first, int levels,
                                             Votes& v) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int k = 1; k <= levels; ++k) {
    const int L = first + k - 1;
    const int8_t want = (int8_t)(L - 1);
    const int gt = (1 << (3 * k)) / N;  // threads a group
    bool col;
    Item c;
    if (gt <= 32) {  // a segment of one warp
      const int c0 = lane & ~(gt - 1);
      c = Item{__shfl_sync(kFull, it[0].f0, c0), __shfl_sync(kFull, it[0].f1, c0),
               (int8_t)L, (int8_t)__shfl_sync(kFull, (int)it[0].state, c0),
               (uint8_t)__shfl_sync(kFull, (int)it[0].touched, c0)};
      bool mine = true;
#pragma unroll
      for (int j = 0; j < N; ++j) mine = mine && it[j].eff == want && it[j].state == c.state;
      const unsigned ok = __ballot_sync(kFull, mine);
      const unsigned seg = gt == 32 ? kFull : ((1u << gt) - 1u) << c0;
      col = (ok & seg) == seg;
    } else {  // several warps: their votes
      WarpVote* buf = v.w[k & 1];
      const WarpVote mine = warp_vote<N>(it);
      if (lane == 0) buf[w] = mine;
      __syncthreads();
      const int nw = gt / 32;
      const WarpVote q0 = buf[w & ~(nw - 1)];
      bool ok = true;
      if (lane < nw) {
        const WarpVote& q = buf[(w & ~(nw - 1)) + lane];
        ok = q.same_eff && q.eff == want && q.same_state && q.state == q0.state;
      }
      col = __all_sync(kFull, ok) != 0;
      c = Item{q0.f0, q0.f1, (int8_t)L, q0.state, q0.touched};
    }
    if (col && c.state >= 0 && c.state != kUnknown) {
#pragma unroll
      for (int j = 0; j < N; ++j) it[j] = c;
    }
  }
}

// The voxels of cubes of edge e <= 8 on their way through shared memory
// into Morton order and back, around the levels inside a cube.
struct Cubes {
  float f0[kMaxItems], f1[kMaxItems];
  uint8_t T[kMaxItems];
  int8_t E[kMaxItems], S[kMaxItems];
};

// Levels 1 .. levels of every cube of the CTA (levels <= log2 e): thread i
// holds the raster voxels N*i .. N*i + N-1 of the CTA's cubes (cube m / e^3
// for voxel m, the cubes back to back) on entry and on return; in between,
// the cubes' Morton voxels N*i .. N*i + N-1.  Every thread calls this.  On
// return `c` holds every voxel, raster, its state included.
template <int N>
__device__ __forceinline__ void prune_cubes(Item (&it)[N], int e, int levels, Cubes& c,
                                            Votes& v) {
  const int i = threadIdx.x;
  const int ce = e * e * e;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int m = N * i + j;
    c.f0[m] = it[j].f0;
    c.f1[m] = it[j].f1;
    c.T[m] = it[j].touched;
    c.E[m] = it[j].eff;
    c.S[m] = it[j].state;
  }
  __syncthreads();
  Item mt[N];
  int r[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int m = N * i + j;
    r[j] = (m / ce) * ce + morton_raster(m % ce, e);
    mt[j] = Item{c.f0[r[j]], c.f1[r[j]], c.E[r[j]], c.S[r[j]], c.T[r[j]]};
  }
  const int8_t e_in = mt[0].eff;
  prune_levels<N>(mt, 1, levels, v);
  if (mt[0].eff != e_in) {  // collapsed: a collapse sets all N items and raises eff
#pragma unroll
    for (int j = 0; j < N; ++j) {
      c.f0[r[j]] = mt[j].f0;
      c.f1[r[j]] = mt[j].f1;
      c.T[r[j]] = mt[j].touched;
      c.E[r[j]] = mt[j].eff;
      c.S[r[j]] = mt[j].state;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < N; ++j) {  // (the raster items read back: none held across)
    const int m = N * i + j;
    it[j] = Item{c.f0[m], c.f1[m], c.E[m], c.S[m], c.T[m]};
  }
}

// The summary of the 8^3 tile that prune_cubes has just pruned with its
// three in-tile levels (the CTA's blockDim.x * N items): eff and state where
// uniform over the tile, else -1, and the corner voxel's f0, f1 and
// touched.  It reads the level-3 votes, taken before that level's collapse
// (whose buffer no later vote has overwritten), and the corner's eff after
// it: a tile that collapsed at level 3 is uniform.  Every thread of warp 0
// calls this (no barrier); the result is the same in each.
__device__ __forceinline__ Item tile_summary(const Cubes& c, const Votes& v) {
  const int lane = threadIdx.x & 31;
  const WarpVote* buf = v.w[3 & 1];
  const WarpVote q0 = buf[0];  // warp 0's first item: the corner voxel
  bool same_e = true, same_s = true;
  if (lane < (int)(blockDim.x >> 5)) {
    const WarpVote& q = buf[lane];
    same_e = q.same_eff && q.eff == q0.eff;
    same_s = q.same_state && q.state == q0.state;
  }
  same_e = __all_sync(kFull, same_e) != 0;
  same_s = __all_sync(kFull, same_s) != 0;
  if (c.E[0] != q0.eff)  // collapsed at level 3
    return Item{q0.f0, q0.f1, c.E[0], q0.state, q0.touched};
  return Item{q0.f0, q0.f1, same_e ? q0.eff : (int8_t)-1, same_s ? q0.state : (int8_t)-1,
              q0.touched};
}

// The last-CTA handshake of a block of tpb tiles: thread 0 writes the
// tile's summary `s` (valid in thread 0) at index ti of sum_es [., 2] (eff,
// state), sum_f [., 2] (f0, f1) and sum_t [.], fences, and counts the CTA
// in on the block's counter.  Returns true in the block's last CTA, whose
// threads then see every tile's voxels and summary; that CTA sets the
// counter back to 0, so the counters are zero between launches.  The
// CTA's voxel writes precede the barrier in count_in, and thread 0's
// fences are cumulative: the one before the count publishes them with the
// summary, the one after it (in the last CTA) acquires the other tiles'
// before the barrier below (the release and wait of CUTLASS's split-K
// semaphore); no other thread fences.
__device__ __forceinline__ bool count_in(const Item& s, size_t ti, int8_t* __restrict__ sum_es,
                                         float* __restrict__ sum_f,
                                         uint8_t* __restrict__ sum_t, int32_t* counter,
                                         int tpb) {
  __shared__ bool is_last;
  __syncthreads();  // every voxel of the tile is written
  if (threadIdx.x == 0) {
    sum_es[2 * ti + 0] = s.eff;
    sum_es[2 * ti + 1] = s.state;
    sum_f[2 * ti + 0] = s.f0;
    sum_f[2 * ti + 1] = s.f1;
    sum_t[ti] = s.touched;
    __threadfence();  // the tile and its summary are visible before the count
    is_last = atomicAdd(counter, 1) == tpb - 1;
    if (is_last) {
      *counter = 0;
      __threadfence();
    }
  }
  __syncthreads();
  return is_last;
}

// Levels 4 .. max_level of a block of 8^3 tiles (tpa tiles an edge), run by
// the block's last CTA over the tile summaries (sum_es [., 2] eff and state,
// sum_f [., 2] f0 and f1, sum_t [.], raster tile order from tile0), thread
// u holding the tiles at Morton indices N*u .. N*u + N-1 (blockDim.x * N >=
// tpa^3).  Returns the number of tiles that collapsed; c.f0, c.f1, c.T and
// c.E, indexed by raster tile, then hold their values, and changed[0 ..
// count) their raster indices (in no fixed order: each is rewritten whole,
// by one CTA).  Every thread has passed a __syncthreads().
template <int N>
__device__ __forceinline__ int cross_tile_levels(
    const int8_t* __restrict__ sum_es, const float* __restrict__ sum_f,
    const uint8_t* __restrict__ sum_t, size_t tile0, int tpa, int max_level, Cubes& c,
    int16_t* changed, Votes& v) {
  __shared__ int n_changed;
  const int tpb = tpa * tpa * tpa;
  Item it[N];
  int pos[N];
  int8_t e_in[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int u = N * threadIdx.x + j;
    pos[j] = u < tpb ? morton_raster(u, tpa) : 0;
    it[j] = no_item();
    if (u < tpb) {
      const size_t k = tile0 + pos[j];
      it[j] = Item{__ldcg(&sum_f[2 * k]), __ldcg(&sum_f[2 * k + 1]),
                   __ldcg(&sum_es[2 * k]), __ldcg(&sum_es[2 * k + 1]), __ldcg(&sum_t[k])};
    }
    e_in[j] = it[j].eff;
  }
  if (threadIdx.x == 0) n_changed = 0;
  prune_levels<N>(it, 4, max_level - 3, v);
  __syncthreads();  // n_changed is 0 (prune_levels need not sync)
#pragma unroll
  for (int j = 0; j < N; ++j) {
    if (N * (int)threadIdx.x + j < tpb && it[j].eff != e_in[j]) {  // a collapse raises eff
      c.f0[pos[j]] = it[j].f0;
      c.f1[pos[j]] = it[j].f1;
      c.T[pos[j]] = it[j].touched;
      c.E[pos[j]] = it[j].eff;
      changed[atomicAdd(&n_changed, 1)] = (int16_t)pos[j];
    }
  }
  __syncthreads();
  return n_changed;
}

}  // namespace vote
}  // namespace la3dm
