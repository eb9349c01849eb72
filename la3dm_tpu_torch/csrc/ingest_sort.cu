// K7s — the stable sort and run cut of device ingest's scan-local keys,
// hand-written for Hopper (sm_90a).
//
// Replaces the key sorts of la3dm_tpu/geometry/device_ingest.py:
// _downsample's lax.sort of the voxel keys with its run ends (lines 192-246,
// _run_ends 166-180), and _bucket_align's jnp.sort of the membership keys,
// its payload lax.sort and the sort of the candidate test-block keys (lines
// 315, 338, 355).  For keys in the int64 layout of ingest_keys.cuh (the
// sentinel INT64_MAX marks an invalid row) it writes the stable sort index
// of the VALID keys (perm), and their runs: each run's key in the int64
// layout (ukey), its first row (starts) and its length (counts); optionally
// the run of every sorted row (rid).  No library sort inside.
//
// Compact codes.  Each field of a valid key lies within a window of
// ``radius`` cells (or blocks) round its scan's anchor, which the caller
// derives from the statics (kernels/ingest_sort.py).  The key is packed into
// the mixed-radix code ((scan * W + z) * W + y) * W + x, with W = 2 radius
// + 1 and each coordinate counted from the window's low edge: the code
// orders keys exactly as the int64 keys do, in ``bits`` = bit length of
// K W^3 - 1 bits (27 for a demo cell key, 21 for a block key), u32 up to 32
// bits and u64 above.  A valid key outside its window sets status[2]; the
// wrapper reads it at the sync that fetches the sizes and raises.
//
// The sort is LSD radix over the code's bits only, ceil(bits / 8) passes of
// equal digits (27 bits: 4 passes of 7), in the manner of Onesweep (Adinets
// and Merrill, 2022).  Two paths, chosen on the host from N:
// * Small (N at most 4096 keys: 512 threads, 8 keys a thread): one CTA
//   sorts them in shared memory, pass after pass (a warp's rounds without
//   keys skipped), cuts the runs and writes the status words itself.  One
//   launch, no memset.
// * Large: a memset of the control words, then
//     hist     one launch: every pass's digit totals at once (global, from
//              the int64 keys), the valid keys and the out-of-window flag;
//     a pass   one launch each: persistent CTAs take tiles of 2048 keys in
//              order from an atomic counter (the tile also picks the slice
//              of input, so stability and forward progress both hold), rank
//              the tile's keys stably by digit (warp ballots over the
//              digit's bits, per-warp digit counters in warp order), publish
//              each digit's count, and take the digit's offset over the
//              tiles before by a decoupled look-back; then the tile leaves
//              sorted by digit in coalesced runs;
//     run cut  one launch: warp-striped rows (a round reads and writes 32
//              consecutive rows), heads by ballots, their prefix over the
//              tiles by a decoupled look-back, then per run its first row,
//              key and length, and per row its run.
//   passes + 2 launches a sort.  The first pass reads the int64 keys and
//   drops the invalid ones (an invalid key counts in no digit); later
//   passes and the run cut read their size (status[0]) on the device, so
//   nothing waits on the host.  The last pass writes the sort index as
//   int64.
// What bounds it: bytes (the keys read once, perm and the runs written
// once); the passes move about 3 (first pass: 5) words a valid key more.
// What holds it back on an H100 is latency: a launch leaves about 2.4 us of
// the card idle, a tile takes about 5 us from its loads to its ranks, and
// the tiles of one wave start together, so the look-back's inclusive
// prefix reaches tile t only after about t / 16 round trips.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ingest_keys.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                 // keys a thread, multi-CTA passes
constexpr int kTile = kThreads * kItems;  // keys a tile
constexpr int kSmallThreads = 512;         // the one-CTA path: 512 threads x 8 keys
constexpr int kSmallItems = 8;
constexpr int kSmallTile = kSmallThreads * kSmallItems;  // its most keys
constexpr int kMaxBins = 256;             // 8-bit digits at most
constexpr int kMaxPasses = 8;
constexpr unsigned kAll = 0xffffffffu;

// the control words (int32, at the workspace's head): valid keys, runs, the
// out-of-window flag; then each pass's tile counter and the run cut's
constexpr int kValid = 0, kRuns = 1, kFlag = 2, kPassCounter = 4,
              kCutCounter = kPassCounter + kMaxPasses;
constexpr size_t kStatusBytes = 256;

// a look-back word: 2 bits of flag, 30 of count
constexpr unsigned kAggregate = 1u << 30, kInclusive = 2u << 30, kCount = (1u << 30) - 1u;

struct Window {
  int lo;  // the field value of coordinate anchor - radius
  int W;   // 2 radius + 1
  int K;   // scans
};

// the code of a valid key; false where it lies outside the window
__device__ __forceinline__ bool key_code(int64_t key, const Window& w, uint64_t* code) {
  const int s = (int)(key >> 48);
  const int x = (int)(key & 0xFFFF) - w.lo;
  const int y = (int)((key >> 16) & 0xFFFF) - w.lo;
  const int z = (int)((key >> 32) & 0xFFFF) - w.lo;
  if (s < 0 || s >= w.K || x < 0 || x >= w.W || y < 0 || y >= w.W || z < 0 || z >= w.W)
    return false;
  const uint64_t W = (uint64_t)w.W;
  *code = (((uint64_t)s * W + (uint64_t)z) * W + (uint64_t)y) * W + (uint64_t)x;
  return true;
}

// the key of a code (in the code's own width: a u32 code divides in 32 bits)
template <typename KeyT>
__device__ __forceinline__ int64_t code_key(KeyT c, const Window& w) {
  const KeyT W = (KeyT)w.W;
  const int64_t x = (int64_t)(c % W);
  c /= W;
  const int64_t y = (int64_t)(c % W);
  c /= W;
  const int64_t z = (int64_t)(c % W);
  const int64_t s = (int64_t)(c / W);
  return (s << 48) | ((z + w.lo) << 32) | ((y + w.lo) << 16) | (x + w.lo);
}

struct Sum {
  template <typename T>
  __device__ T operator()(T a, T b) const { return a + b; }
};
struct Max {
  template <typename T>
  __device__ T operator()(T a, T b) const { return a > b ? a : b; }
};

// exclusive scan under ``op`` (identity ``id``) of one value a thread over
// the CTA of NT threads (every thread calls it); *total gets the whole CTA's
template <int NT, typename T, typename Op>
__device__ __forceinline__ T block_exclusive_scan(T v, T id, Op op, T* total) {
  constexpr int kWarps = NT / 32;
  __shared__ T ws[kWarps];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  T x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(kAll, x, o);
    if (lane >= o) x = op(y, x);
  }
  T ex = __shfl_up_sync(kAll, x, 1);
  if (lane == 0) ex = id;
  if (lane == 31) ws[wid] = x;
  __syncthreads();
  if (wid == 0) {
    T s = lane < kWarps ? ws[lane] : id;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const T y = __shfl_up_sync(kAll, s, o);
      if (lane >= o) s = op(y, s);
    }
    if (lane < kWarps) ws[lane] = s;
  }
  __syncthreads();
  const T pre = wid ? ws[wid - 1] : id;
  *total = ws[kWarps - 1];
  __syncthreads();  // ws is reused by the next call
  return op(pre, ex);
}

template <int NT = kThreads>
__device__ __forceinline__ int block_exclusive_sum(int v, int* total) {
  return block_exclusive_scan<NT>(v, 0, Sum(), total);
}

// ---------------------------------------------------------------- tile rank

// Shared state of one tile's ranking by NW warps.
template <int NW>
struct RankSmem {
  int wcnt[NW][kMaxBins];  // per warp and digit: its count, then its offset
  int dstart[kMaxBins];        // the tile's first sorted row of each digit
  int dcount[kMaxBins];        // the tile's keys of each digit
};

// Stable ranks of one tile by digit.  Thread (warp wid, lane) holds the
// tile's rows wid * 32 * N + 32 k + lane, k = 0..N-1 (input order);
// digit[k] in [0, 2^dbits) or -1 (no key), and no key from round ``rounds``
// on (the same in every lane of a warp).  On return rank[k] is the row's
// place in the tile sorted by digit, keys of one digit in input order;
// sm.dstart / sm.dcount hold each digit's first row and count.
template <int NT, int N>
__device__ __forceinline__ void tile_rank(const int (&digit)[N], int (&rank)[N], int dbits,
                                          int rounds, RankSmem<NT / 32>& sm) {
  constexpr int kWarps = NT / 32;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nbins = 1 << dbits;
  const unsigned lt = (1u << lane) - 1u;
  for (int t = threadIdx.x; t < kWarps << dbits; t += NT) sm.wcnt[t >> dbits][t & (nbins - 1)] = 0;
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) {
    if (k >= rounds) break;
    const int d = digit[k];
    // the lanes holding the same digit: a ballot a bit
    unsigned peers = __ballot_sync(kAll, d >= 0);
    for (int b = 0; b < dbits; ++b) {
      const bool set = (d >> b) & 1;
      const unsigned bits = __ballot_sync(kAll, set);
      peers &= set ? bits : ~bits;
    }
    const int before = d >= 0 ? sm.wcnt[wid][d] : 0;
    __syncwarp();
    if (d >= 0 && (peers & lt) == 0) sm.wcnt[wid][d] = before + __popc(peers);
    __syncwarp();
    rank[k] = before + __popc(peers & lt);
  }
  __syncthreads();
  // per digit: the warps' counts → their offsets in warp order; the digits'
  // first rows
  int in_tile = 0;
  if (threadIdx.x < nbins) {
    for (int v = 0; v < kWarps; ++v) {
      const int c = sm.wcnt[v][threadIdx.x];
      sm.wcnt[v][threadIdx.x] = in_tile;
      in_tile += c;
    }
  }
  int n_tile;
  const int first = block_exclusive_sum<NT>(in_tile, &n_tile);
  if (threadIdx.x < nbins) {
    sm.dstart[threadIdx.x] = first;
    sm.dcount[threadIdx.x] = in_tile;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k)
    if (digit[k] >= 0) rank[k] += sm.dstart[digit[k]] + sm.wcnt[wid][digit[k]];
}

// the rounds of a warp's rows (wid * 32 * N + 32 k + lane) below ``n_rows``
template <int N>
__device__ __forceinline__ int rounds_below(int n_rows) {
  const int r = (n_rows - (int)(threadIdx.x >> 5) * 32 * N + 31) / 32;
  return r < 0 ? 0 : (r > N ? N : r);
}

// The exclusive prefix of tile ``tile``'s count of one digit over the tiles
// before it: look[t * stride] is tile t's word.  The words of kWindow tiles
// are read at once, then walked back to the first inclusive one; at a word
// not yet published the walk reads a whole window again from that tile.
// The tiles of one wave start together, so tile k may have to add k
// aggregates, and a window takes kWindow of them a round trip.
constexpr int kWindow = 16;

__device__ __forceinline__ unsigned look_back(const unsigned* look, size_t stride, int tile) {
  unsigned before = 0;
  for (int t = tile - 1;;) {
    unsigned w[kWindow];
#pragma unroll
    for (int j = 0; j < kWindow; ++j)
      w[j] = t - j >= 0 ? *(const volatile unsigned*)(look + (size_t)(t - j) * stride)
                        : 2u << 30;  // inclusive, 0
    int next = t - kWindow;
#pragma unroll
    for (int j = kWindow - 1; j >= 0; --j)  // the first word not yet published
      if ((w[j] & ~kCount) == 0u) next = t - j;
#pragma unroll
    for (int j = 0; j < kWindow; ++j) {
      if (t - j > next) {
        before += w[j] & kCount;
        if (w[j] & kInclusive) return before;
      }
    }
    t = next;
  }
}

// the keys a sort reads: the first N, or with a device-side count the first
// min(N, *count) (the rest may hold anything)
__device__ __forceinline__ long long key_count(long long N, const int32_t* count) {
  if (count == nullptr) return N;
  const long long m = *count;
  return m < N ? (m < 0 ? 0 : m) : N;
}

__device__ __forceinline__ int digit_of(uint64_t c, int shift, int dbits) {
  return (int)((c >> shift) & ((1ull << dbits) - 1ull));
}

// ---------------------------------------------------------------- run cut

// The run cut of a CTA's sorted rows, warp-striped: warp w takes rows
// base + 256 w + 32 k + lane, k = 0..7, so each round reads and writes 32
// consecutive rows.  A row is a head where its code differs from the row
// before.  scan() finds the heads (a ballot a round); with the heads and
// the last head of the rows before the warp, write() writes per run its
// first row (starts) and its key decoded (ukey), at its last row its length
// (counts), and per row its run (rid).
template <typename KeyT>
struct RowCut {
  static constexpr int kRounds = 8;
  KeyT c[kRounds];
  unsigned head[kRounds];  // each round's heads
  long long row0;          // the warp's first row
  int heads;               // the warp's heads
  long long last1;         // its last head's row + 1 (0: none)

  __device__ __forceinline__ void scan(const KeyT* codes, long long base, long long n) {
    const int lane = threadIdx.x & 31;
    row0 = base + 32LL * kRounds * (threadIdx.x >> 5);
    heads = 0;
    last1 = 0;
#pragma unroll
    for (int k = 0; k < kRounds; ++k) {
      const long long i = row0 + 32 * k + lane;
      const bool live = i < n;
      c[k] = live ? codes[i] : (KeyT)0;
      head[k] = __ballot_sync(kAll, live && (i == 0 || codes[i - 1] != c[k]));
      heads += __popc(head[k]);
      if (head[k]) last1 = row0 + 32 * k + (31 - __clz(head[k])) + 1;
    }
  }

  // ``before``: the heads before the warp's rows; ``before1``: the last of
  // them's row + 1
  __device__ __forceinline__ void write(const KeyT* codes, long long n, long long before,
                                        long long before1, const Window& w, int64_t* ukey,
                                        int64_t* starts, int64_t* counts, int32_t* rid) {
    const int lane = threadIdx.x & 31;
    const unsigned upto = lane == 31 ? kAll : (2u << lane) - 1u;
#pragma unroll
    for (int k = 0; k < kRounds; ++k) {
      const long long i = row0 + 32 * k + lane;
      if (i < n) {
        const unsigned m = head[k] & upto;
        const long long r = before + __popc(m) - 1;
        if ((head[k] >> lane) & 1u) {
          starts[r] = i;
          ukey[r] = code_key(c[k], w);
        }
        if (rid) rid[i] = (int32_t)r;
        const long long start = m ? row0 + 32 * k + (31 - __clz(m)) : before1 - 1;
        if (i == n - 1 || codes[i + 1] != c[k]) counts[r] = i + 1 - start;
      }
      before += __popc(head[k]);
      if (head[k]) before1 = row0 + 32 * k + (31 - __clz(head[k])) + 1;
    }
  }
};

// ---------------------------------------------------------------- small path

// One CTA: the whole sort and run cut of n <= kSmallTile keys in shared memory.
template <typename KeyT>
__global__ void __launch_bounds__(kSmallThreads)
ingest_sort_small_kernel(const int64_t* __restrict__ keys, int n_keys,
                         const int32_t* __restrict__ count, Window w, int passes, int dbits,
                         int64_t* __restrict__ out, int32_t* __restrict__ rid,
                         int* __restrict__ status) {
  extern __shared__ __align__(16) unsigned char smem[];
  KeyT* s_code = reinterpret_cast<KeyT*>(smem);
  uint32_t* s_idx = reinterpret_cast<uint32_t*>(smem + kSmallTile * sizeof(KeyT));
  __shared__ RankSmem<kSmallThreads / 32> sm;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int wbase = wid * 32 * kSmallItems;
  const int n = (int)key_count(n_keys, count);
  KeyT code[kSmallItems];
  uint32_t idx[kSmallItems];
  int digit[kSmallItems], rank[kSmallItems];
  int bad = 0, valid = 0;
#pragma unroll
  for (int k = 0; k < kSmallItems; ++k) {
    const int i = wbase + 32 * k + lane;
    uint64_t c = 0;
    bool ok = false;
    if (i < n) {
      const int64_t key = keys[i];
      ok = key != kSentinel && key_code(key, w, &c);
      bad |= key != kSentinel && !ok;
    }
    code[k] = (KeyT)c;
    idx[k] = (uint32_t)i;
    digit[k] = ok ? digit_of(c, 0, dbits) : -1;
    valid += ok;
  }
  int V;
  block_exclusive_sum<kSmallThreads>(valid, &V);
  bad = __syncthreads_or(bad);
  for (int p = 0; p < passes; ++p) {
    tile_rank<kSmallThreads>(digit, rank, dbits, rounds_below<kSmallItems>(p == 0 ? n : V), sm);
    __syncthreads();  // every row of the previous pass read
#pragma unroll
    for (int k = 0; k < kSmallItems; ++k) {
      if (digit[k] >= 0) {
        s_code[rank[k]] = code[k];
        s_idx[rank[k]] = idx[k];
      }
    }
    __syncthreads();
    if (p + 1 == passes) break;
#pragma unroll
    for (int k = 0; k < kSmallItems; ++k) {
      const int i = wbase + 32 * k + lane;
      const bool ok = i < V;
      code[k] = ok ? s_code[i] : (KeyT)0;
      idx[k] = ok ? s_idx[i] : 0u;
      digit[k] = ok ? digit_of((uint64_t)code[k], (p + 1) * dbits, dbits) : -1;
    }
  }
  // the run cut over the sorted rows
  int64_t* perm = out;
  RowCut<KeyT> cut;
  cut.scan(s_code, 0, V);
  int R;
  long long last1_all;
  const int ex = __shfl_sync(kAll, block_exclusive_sum<kSmallThreads>(lane ? 0 : cut.heads, &R),
                             0);
  const long long ex1 = __shfl_sync(
      kAll, block_exclusive_scan<kSmallThreads>(lane ? 0LL : cut.last1, 0LL, Max(), &last1_all),
      0);
  cut.write(s_code, V, ex, ex1, w, out + n_keys, out + 2 * (size_t)n_keys,
            out + 3 * (size_t)n_keys, rid);
  for (int i = threadIdx.x; i < V; i += kSmallThreads) perm[i] = (int64_t)s_idx[i];
  if (threadIdx.x == 0) {
    status[kValid] = V;
    status[kRuns] = R;
    status[kFlag] = bad;
  }
}

// ---------------------------------------------------------------- large path

// every pass's digit totals at once, the valid keys and the flag
__global__ void __launch_bounds__(kThreads)
ingest_sort_hist_kernel(const int64_t* __restrict__ keys, long long n_keys,
                        const int32_t* __restrict__ count, Window w, int passes, int dbits,
                        int* __restrict__ status, unsigned* __restrict__ ghist) {
  __shared__ unsigned cnt[kMaxPasses * kMaxBins];
  const long long n = key_count(n_keys, count);
  const int nbins = 1 << dbits;
  for (int t = threadIdx.x; t < passes * nbins; t += kThreads) cnt[t] = 0;
  __syncthreads();
  int bad = 0, valid = 0;
  constexpr int kUnroll = 4;  // loads in flight a thread
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i0 = (long long)blockIdx.x * kThreads + threadIdx.x; i0 < n;
       i0 += kUnroll * stride) {
    int64_t key[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = i0 + u * stride;
      key[u] = i < n ? keys[i] : kSentinel;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      uint64_t c = 0;
      const bool ok = key[u] != kSentinel && key_code(key[u], w, &c);
      bad |= key[u] != kSentinel && !ok;
      if (ok) {
        ++valid;
        for (int p = 0; p < passes; ++p)
          atomicAdd(&cnt[p * nbins + digit_of(c, p * dbits, dbits)], 1u);
      }
    }
  }
  int V;
  block_exclusive_sum(valid, &V);
  if (__syncthreads_or(bad) && threadIdx.x == 0) atomicOr(&status[kFlag], 1);
  if (threadIdx.x == 0 && V) atomicAdd(&status[kValid], V);
  for (int t = threadIdx.x; t < passes * nbins; t += kThreads)
    if (cnt[t]) atomicAdd(&ghist[(t / nbins) * kMaxBins + t % nbins], cnt[t]);
}

// One radix pass over tiles taken in order from the pass's counter.
template <typename KeyT, bool kFirst, bool kLast>
__global__ void __launch_bounds__(kThreads, 4)
ingest_sort_pass_kernel(const int64_t* __restrict__ keys,      // kFirst
                        const KeyT* __restrict__ codes_in,     // later passes
                        const uint32_t* __restrict__ idx_in,   // later passes
                        long long n_keys, const int32_t* __restrict__ count,  // kFirst
                        int* __restrict__ status, Window w, int pass,
                        int dbits, const unsigned* __restrict__ ghist,  // this pass's [kMaxBins]
                        unsigned* __restrict__ look,           // this pass's [tiles, 2^dbits]
                        KeyT* __restrict__ codes_out, uint32_t* __restrict__ idx_out,
                        int64_t* __restrict__ perm) {          // kLast
  extern __shared__ __align__(16) unsigned char smem[];
  KeyT* s_code = reinterpret_cast<KeyT*>(smem);
  uint32_t* s_idx = reinterpret_cast<uint32_t*>(smem + kTile * sizeof(KeyT));
  __shared__ RankSmem<kWarps> sm;
  __shared__ long long s_base[kMaxBins];  // each digit's first output row in this tile
  __shared__ int s_tile;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nbins = 1 << dbits, shift = pass * dbits;
  // each digit's first row over the whole pass
  int total;
  const int gstart = block_exclusive_sum(threadIdx.x < nbins ? (int)ghist[threadIdx.x] : 0,
                                         &total);
  const long long n = kFirst ? key_count(n_keys, count) : (long long)status[kValid];
  const long long n_tiles = (n + kTile - 1) / kTile;
  for (;;) {
    if (threadIdx.x == 0) s_tile = atomicAdd(&status[kPassCounter + pass], 1);
    __syncthreads();
    const int tile = s_tile;
    if (tile >= n_tiles) break;
    const long long wbase = (long long)tile * kTile + wid * 32 * kItems;
    KeyT code[kItems];
    uint32_t idx[kItems];
    int digit[kItems], rank[kItems];
    // the tile's loads first, all in flight, then the codes and digits
    int64_t key[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const long long i = wbase + 32 * k + lane;
      if (kFirst) {
        key[k] = i < n ? keys[i] : kSentinel;
      } else {
        code[k] = i < n ? codes_in[i] : (KeyT)0;
        idx[k] = i < n ? idx_in[i] : 0u;
      }
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const long long i = wbase + 32 * k + lane;
      uint64_t c = kFirst ? 0 : (uint64_t)code[k];
      bool ok = i < n;
      if (kFirst) {
        ok = key[k] != kSentinel && key_code(key[k], w, &c);
        code[k] = (KeyT)c;
        idx[k] = (uint32_t)i;
      }
      digit[k] = ok ? digit_of(c, shift, dbits) : -1;
    }
    tile_rank<kThreads>(digit, rank, dbits,
                        rounds_below<kItems>((int)(n - (long long)tile * kTile < kTile
                                         ? n - (long long)tile * kTile : kTile)), sm);
    // publish each digit's count in the tile, stage the tile sorted by digit,
    // then take each digit's offset over the tiles before by a look-back
    volatile unsigned* word = look + (size_t)tile * nbins + threadIdx.x;
    const unsigned mine = threadIdx.x < nbins ? (unsigned)sm.dcount[threadIdx.x] : 0u;
    if (threadIdx.x < nbins) *word = (tile == 0 ? kInclusive : kAggregate) | mine;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (digit[k] >= 0) {
        s_code[rank[k]] = code[k];
        s_idx[rank[k]] = idx[k];
      }
    }
    if (threadIdx.x < nbins) {
      unsigned before = 0;
      if (tile > 0) {
        before = look_back(look + threadIdx.x, nbins, tile);
        *word = kInclusive | (before + mine);
      }
      s_base[threadIdx.x] = (long long)gstart + before - sm.dstart[threadIdx.x];
    }
    __syncthreads();
    // staged row p of digit d goes to s_base[d] + p: each digit's keys leave
    // the tile as one contiguous run
    const int n_tile = sm.dstart[nbins - 1] + sm.dcount[nbins - 1];
    for (int p = threadIdx.x; p < n_tile; p += kThreads) {
      const KeyT c = s_code[p];
      const long long dst = s_base[digit_of((uint64_t)c, shift, dbits)] + p;
      codes_out[dst] = c;
      if (kLast) {
        perm[dst] = (int64_t)s_idx[p];
      } else {
        idx_out[dst] = s_idx[p];
      }
    }
    __syncthreads();  // the next tile reuses the shared memory
  }
}

// The run cut, over the sorted codes in tiles of 2048 rows (RowCut).  Each
// tile counts its heads and its last head, takes the heads and the last head
// of all tiles before it by a decoupled look-back (tiles numbered in the
// order their CTAs start, so each waits only on tiles already running; a
// tile past the valid rows has nothing to add and leaves), then writes its
// runs.  status[1] gets the number of runs.
constexpr int kCutTile = kThreads * RowCut<uint32_t>::kRounds;
constexpr unsigned long long kCutAggregate = 1ull << 62, kCutInclusive = 2ull << 62;
constexpr unsigned long long kField = (1ull << 31) - 1;

__device__ __forceinline__ unsigned long long tile_word(unsigned long long flag, long long heads,
                                                        long long last1) {
  return flag | ((unsigned long long)heads << 31) | (unsigned long long)last1;
}

template <typename KeyT>
__global__ void __launch_bounds__(kThreads)
ingest_sort_runs_kernel(const KeyT* __restrict__ codes, int* __restrict__ status, Window w,
                        unsigned long long* __restrict__ states,  // [tiles], zeroed
                        int64_t* __restrict__ ukey, int64_t* __restrict__ starts,
                        int64_t* __restrict__ counts, int32_t* __restrict__ rid) {  // or null
  __shared__ int s_tile;
  __shared__ long long s_heads, s_last1;
  if (threadIdx.x == 0) s_tile = atomicAdd(&status[kCutCounter], 1);
  __syncthreads();
  const int tile = s_tile;
  const long long n = status[kValid];
  if ((long long)tile * kCutTile >= n) return;
  const int lane = threadIdx.x & 31;
  RowCut<KeyT> cut;
  cut.scan(codes, (long long)tile * kCutTile, n);
  int tile_heads;
  long long tile_last1;
  const int ex = __shfl_sync(kAll, block_exclusive_sum(lane ? 0 : cut.heads, &tile_heads), 0);
  const long long ex1 = __shfl_sync(
      kAll, block_exclusive_scan<kThreads>(lane ? 0LL : cut.last1, 0LL, Max(), &tile_last1), 0);
  if (threadIdx.x < 32) {
    // warp 0 looks back over the tiles before, 32 words at once, to the
    // first inclusive one
    long long heads = 0, prev1 = 0;  // of the tiles before this one
    if (tile > 0) {
      if (lane == 0) atomicExch(&states[tile], tile_word(kCutAggregate, tile_heads, tile_last1));
      for (int t = tile - 1;; t -= 32) {
        const int j = t - lane;
        unsigned long long st = 2ull << 62;  // before tile 0: inclusive, nothing
        if (j >= 0) {
          do {
            st = *(volatile unsigned long long*)&states[j];
          } while ((st >> 62) == 0);
        }
        const unsigned incl = __ballot_sync(kAll, (st >> 62) == 2);
        const int stop = incl ? __ffs(incl) - 1 : 31;
        long long h = lane <= stop ? (long long)((st >> 31) & kField) : 0;
        long long l1 = lane <= stop ? (long long)(st & kField) : 0;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          h += __shfl_xor_sync(kAll, h, o);
          l1 = max(l1, __shfl_xor_sync(kAll, l1, o));
        }
        heads += h;
        prev1 = max(prev1, l1);
        if (incl) break;
      }
    }
    if (lane == 0) {
      atomicExch(&states[tile], tile_word(kCutInclusive, heads + tile_heads,
                                          tile_last1 ? tile_last1 : prev1));
      atomicMax(&status[kRuns], (int)(heads + tile_heads));
      s_heads = heads;
      s_last1 = prev1;
    }
  }
  __syncthreads();
  cut.write(codes, n, s_heads + ex, max(s_last1, ex1), w, ukey, starts, counts, rid);
}

// ---------------------------------------------------------------- host side

size_t align_up(size_t x) { return (x + 255) & ~(size_t)255; }

struct Plan {
  int passes, dbits;
};

Plan plan(int bits) {
  Plan p;
  p.passes = (bits + 7) / 8;
  p.dbits = (bits + p.passes - 1) / p.passes;
  return p;
}

// The workspace: the control words (zeroed by one memset: the status words
// and counters, every pass's digit totals and look-back words, the run
// cut's tile words), then the codes and indices, two buffers each.
struct Layout {
  size_t ghist, look, states, control, codes_a, codes_b, idx_a, idx_b, bytes;
  size_t look_per_pass;
};

Layout layout(long long N, int bits, int key_bytes, bool small) {
  Layout l{};
  if (small) {
    l.control = l.bytes = kStatusBytes;
    return l;
  }
  const Plan p = plan(bits);
  const size_t tiles = (size_t)((N + kTile - 1) / kTile);
  const size_t cut_tiles = (size_t)((N + kCutTile - 1) / kCutTile);
  size_t off = kStatusBytes;
  l.ghist = off;
  off += align_up((size_t)p.passes * kMaxBins * 4);
  l.look = off;
  l.look_per_pass = tiles * ((size_t)1 << p.dbits) * 4;
  off += align_up((size_t)p.passes * l.look_per_pass);
  l.states = off;
  off += align_up(cut_tiles * 8);
  l.control = off;
  l.codes_a = off;
  off += align_up((size_t)N * key_bytes);
  l.codes_b = off;
  off += align_up((size_t)N * key_bytes);
  l.idx_a = off;
  off += align_up((size_t)N * 4);
  l.idx_b = off;
  off += align_up((size_t)N * 4);
  l.bytes = off;
  return l;
}

template <typename Kernel>
int resident_ctas(Kernel k, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kThreads, smem);
  return (per_sm < 1 ? 1 : per_sm) * (sms < 1 ? 1 : sms);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel k, size_t smem) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename KeyT, bool kFirst, bool kLast>
cudaError_t launch_pass(const int64_t* keys, const KeyT* ci, const uint32_t* ii, long long N,
                        const int32_t* count, int* status, Window w, int pass, int dbits,
                        const unsigned* ghist,
                        unsigned* look, KeyT* co, uint32_t* io, int64_t* perm,
                        cudaStream_t st) {
  auto kernel = ingest_sort_pass_kernel<KeyT, kFirst, kLast>;
  const size_t smem = (size_t)kTile * (sizeof(KeyT) + 4);
  static int resident = 0;  // per instance: one card a process
  if (resident == 0) {
    const cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    resident = resident_ctas(kernel, smem);
  }
  const long long tiles = (N + kTile - 1) / kTile;
  const int grid = (int)(tiles < resident ? tiles : resident);
  kernel<<<grid, kThreads, smem, st>>>(keys, ci, ii, N, count, status, w, pass, dbits, ghist,
                                        look, co, io, perm);
  return cudaGetLastError();
}

template <typename KeyT>
int run_sort(const int64_t* keys, long long N, const int32_t* count, Window w, int bits,
             bool small, char* work, int64_t* out, int32_t* rid, cudaStream_t st) {
  const Plan p = plan(bits);
  int* status = reinterpret_cast<int*>(work);
  if (small) {
    const size_t smem = (size_t)kSmallTile * (sizeof(KeyT) + 4);
    auto kernel = ingest_sort_small_kernel<KeyT>;
    static bool ready = false;
    if (!ready) {
      const cudaError_t e = allow_smem(kernel, smem);
      if (e != cudaSuccess) return (int)e;
      ready = true;
    }
    kernel<<<1, kSmallThreads, smem, st>>>(keys, (int)N, count, w, p.passes, p.dbits, out,
                                           rid, status);
    return (int)cudaGetLastError();
  }
  const Layout l = layout(N, bits, (int)sizeof(KeyT), false);
  unsigned* ghist = reinterpret_cast<unsigned*>(work + l.ghist);
  unsigned* look = reinterpret_cast<unsigned*>(work + l.look);
  unsigned long long* states = reinterpret_cast<unsigned long long*>(work + l.states);
  KeyT* codes[2] = {reinterpret_cast<KeyT*>(work + l.codes_a),
                    reinterpret_cast<KeyT*>(work + l.codes_b)};
  uint32_t* idx[2] = {reinterpret_cast<uint32_t*>(work + l.idx_a),
                      reinterpret_cast<uint32_t*>(work + l.idx_b)};
  cudaError_t e = cudaMemsetAsync(work, 0, l.control, st);
  if (e != cudaSuccess) return (int)e;
  static int hist_grid = 0;
  if (hist_grid == 0) hist_grid = resident_ctas(ingest_sort_hist_kernel, 0);
  const long long hist_ctas = (N + 4 * kThreads - 1) / (4 * kThreads);  // 4 keys a thread
  ingest_sort_hist_kernel<<<(int)(hist_ctas < hist_grid ? hist_ctas : hist_grid), kThreads, 0,
                            st>>>(
      keys, N, count, w, p.passes, p.dbits, status, ghist);
  int cur = 0;  // the buffers the pass reads (after the first)
  for (int q = 0; q < p.passes; ++q) {
    const bool first = q == 0, last = q == p.passes - 1;
    const unsigned* gh = ghist + (size_t)q * kMaxBins;
    unsigned* lk = look + (size_t)q * (l.look_per_pass / 4);
    KeyT* co = codes[1 - cur];
    uint32_t* io = idx[1 - cur];
    if (first && last) {
      e = launch_pass<KeyT, true, true>(keys, codes[cur], idx[cur], N, count, status, w, q, p.dbits, gh,
                                        lk, co, io, out, st);
    } else if (first) {
      e = launch_pass<KeyT, true, false>(keys, codes[cur], idx[cur], N, count, status, w, q, p.dbits,
                                         gh, lk, co, io, out, st);
    } else if (last) {
      e = launch_pass<KeyT, false, true>(keys, codes[cur], idx[cur], N, count, status, w, q, p.dbits,
                                         gh, lk, co, io, out, st);
    } else {
      e = launch_pass<KeyT, false, false>(keys, codes[cur], idx[cur], N, count, status, w, q, p.dbits,
                                          gh, lk, co, io, out, st);
    }
    if (e != cudaSuccess) return (int)e;
    cur = 1 - cur;
  }
  const long long cut_tiles = (N + kCutTile - 1) / kCutTile;
  ingest_sort_runs_kernel<KeyT><<<(unsigned)cut_tiles, kThreads, 0, st>>>(
      codes[cur], status, w, states, out + N, out + 2 * N, out + 3 * N, rid);
  return (int)cudaGetLastError();
}

}  // namespace

// Workspace bytes K7s needs for N keys of ``bits``-bit codes in
// ``key_bytes``-byte words, on the small path (``small`` != 0) or the large
// one; its first 16 bytes are the status words.
extern "C" long long la3dm_ingest_sort_workspace(long long N, int bits, int key_bytes,
                                                 int small) {
  return (long long)layout(N, bits, key_bytes, small != 0).bytes;
}

// Queue K7s on ``stream`` over the N int64 keys (1 <= N < 2^30), or, where
// ``count`` (int32 on the device) is not null, over the first min(N, *count)
// of them: the histogram and the first pass read only those, and the tiles
// past them leave at once; N still sizes the launches and the outputs.  ``lo``,
// ``W``, ``K`` the window, ``bits`` the code's bit length, ``key_bytes`` 4 or
// 8, ``small`` != 0 the one-CTA path (N <= 4096).  ``out`` [4, N] int64
// receives perm, ukey, starts, counts (their valid prefixes: status[0] rows
// of perm, status[1] runs); ``rid`` [N] int32 (or null) the run of each
// sorted row; the workspace's first words (int32) the valid keys, the runs
// and the out-of-window flag.  Returns cudaGetLastError().
extern "C" int la3dm_ingest_sort(const int64_t* keys, long long N, int lo, int W, int K,
                                 int bits, int key_bytes, int small, void* work,
                                 long long work_bytes, int64_t* out, int32_t* rid,
                                 const int32_t* count, void* stream) {
  if (N <= 0 || N >= (1LL << 30) || bits < 1 || bits > 64 || W < 1 || K < 1 ||
      (key_bytes != 4 && key_bytes != 8) || (key_bytes == 4 && bits > 32) ||
      (small && N > kSmallTile) ||
      work_bytes < (long long)layout(N, bits, key_bytes, small != 0).bytes)
    return (int)cudaErrorInvalidValue;
  const Window w{lo, W, K};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  char* ws = static_cast<char*>(work);
  return key_bytes == 4
             ? run_sort<uint32_t>(keys, N, count, w, bits, small != 0, ws, out, rid, st)
             : run_sort<uint64_t>(keys, N, count, w, bits, small != 0, ws, out, rid, st);
}
