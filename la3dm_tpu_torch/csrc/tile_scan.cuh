// The tile prefix of the compacting passes of device scan ingest (K7a's
// beams, K7c's compact memberships): a CTA scan of its tile's counts, and
// the tile's place among the tiles by a decoupled look-back (Merrill and
// Garland, 2016).  A tile waits only on tiles already running: tiles are
// numbered in the order their CTAs start (from an atomic counter, K7c), or
// by launch order, in which the CTAs are dispatched (K7a).  The
// look-back words carry the launch's epoch (kept on the host, one more a
// launch), so a word of an earlier launch counts as not yet published and
// the scratch needs no memset.
#pragma once

#include <stdint.h>

namespace tile_scan {

constexpr unsigned kAll = 0xffffffffu;

// a look-back word: the launch's epoch (32 bits), 2 bits of flag, 30 of count
constexpr unsigned long long kAggregate = 1ull << 30, kInclusive = 2ull << 30,
                             kCount = (1ull << 30) - 1;

__device__ __forceinline__ unsigned long long word(unsigned epoch, unsigned long long flag,
                                                   unsigned long long n) {
  return ((unsigned long long)epoch << 32) | flag | n;
}

// exclusive sum of v over the CTA of kThreads threads; *total the CTA's
template <int kThreads>
__device__ __forceinline__ unsigned block_exclusive_sum(unsigned v, unsigned* total) {
  __shared__ unsigned ws[kThreads / 32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  unsigned x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(kAll, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) ws[wid] = x;
  __syncthreads();
  if (wid == 0) {
    unsigned s = lane < kThreads / 32 ? ws[lane] : 0u;
#pragma unroll
    for (int o = 1; o < kThreads / 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(kAll, s, o);
      if (lane >= o) s += y;
    }
    if (lane < kThreads / 32) ws[lane] = s;
  }
  __syncthreads();
  *total = ws[kThreads / 32 - 1];
  return (wid ? ws[wid - 1] : 0u) + x - v;
}

// The look-back of tile `tile` by warp 0: the counts of the tiles before it
// (look[t]: tile t's word, of this launch where its epoch is `epoch`), 32
// words a round back to the first inclusive one.  (128 words a round, four a
// lane, was slower on an H100: more lanes polling words not yet published.)
__device__ __forceinline__ unsigned long long look_back(const unsigned long long* look,
                                                        unsigned epoch, int tile) {
  const int lane = threadIdx.x & 31;
  unsigned long long before = 0;
  for (int t = tile - 1;; t -= 32) {
    const int j = t - lane;
    unsigned long long w = word(epoch, kInclusive, 0);  // before tile 0
    if (j >= 0) {
      do {
        w = *(const volatile unsigned long long*)&look[j];
      } while ((unsigned)(w >> 32) != epoch);
    }
    const unsigned incl = __ballot_sync(kAll, (w & kInclusive) != 0);
    const int stop = incl ? __ffs(incl) - 1 : 31;
    unsigned long long n = lane <= stop ? (w & kCount) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(kAll, n, o);
    before += n;
    if (incl) return before;
  }
}

// The CTA's tile, in the order the CTAs start: thread 0 takes it from
// `counter` (the last tile sets the counter back to 0), every thread returns
// it.
__device__ __forceinline__ int take_tile(unsigned* counter, int n_tiles, int* s_tile) {
  if (threadIdx.x == 0) {
    const int tile = (int)atomicAdd(counter, 1u);
    if (tile == n_tiles - 1) *counter = 0u;  // every CTA has taken its tile
    *s_tile = tile;
  }
  __syncthreads();
  return *s_tile;
}

// Thread 0: publish the tile's count `tot` for the look-backs of the tiles
// after it (tile 0 publishes only its inclusive count).
__device__ __forceinline__ void publish(unsigned long long* look, unsigned epoch, int tile,
                                        unsigned tot) {
  if (threadIdx.x == 0 && tile > 0) atomicExch(&look[tile], word(epoch, kAggregate, tot));
}

// Warp 0: the count of the tiles before this one (its place), once its own
// count `tot` is published; thread 0 publishes the inclusive count, and the
// last tile writes the launch's total to *count.
__device__ __forceinline__ unsigned long long place(unsigned long long* look, unsigned epoch,
                                                    int tile, int n_tiles, unsigned tot,
                                                    int32_t* count) {
  unsigned long long before = 0;
  if (tile > 0) before = look_back(look, epoch, tile);
  if (threadIdx.x == 0) {
    atomicExch(&look[tile], word(epoch, kInclusive, before + tot));
    if (tile == n_tiles - 1) *count = (int32_t)(before + tot);
  }
  return before;
}

}  // namespace tile_scan
