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
// The sort is LSD radix over the code's bits only: ceil(bits / 8) passes of
// equal digits (27 bits: 4 passes of 7), on tiles of 2048 keys:
//   hist     (the first pass only) each tile's count of each digit;
//   scan     one CTA per digit: the exclusive scan of its row over the
//            tiles, and the row's total;
//   scatter  ranks the tile's keys stably (each warp takes a contiguous
//            quarter-kilo of the tile, 32 keys a round in input order;
//            __match_any_sync groups a round's lanes by digit, and per-warp
//            digit counters in shared memory carry the rank across rounds;
//            the warps' counters are then prefixed in warp order), stages
//            the tile sorted by digit in shared memory, and writes each
//            digit's keys to its global offset in coalesced runs; each key
//            also counts in the next pass's histogram at its destination
//            tile (one global atomic a group of equal lanes), which the
//            scan zeroed, so a later pass needs no histogram launch.
// The first pass reads the int64 keys and drops the invalid ones (the
// compaction is the first pass itself: an invalid key counts in no digit);
// the sizes of later passes come from status[0] on the device, so nothing
// waits on the host.  The last pass writes the sort index as int64.
// The run cut is one launch after the last pass: heads per tile, their
// prefix over the tiles by a decoupled look-back, then per run its first
// row, key and length, and per row its run.
// What bounds it: bytes (the keys read once, perm and the runs written
// once); the passes move about 3 (first pass: 5) words a valid key more.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ingest_keys.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;  // keys a tile
constexpr int kMaxBins = 256;             // 8-bit digits at most
constexpr unsigned kAll = 0xffffffffu;

// status words (int32): valid keys, runs, the out-of-window flag, the run
// cut's tile counter
constexpr int kValid = 0, kRuns = 1, kFlag = 2, kTileCounter = 3;

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

__device__ __forceinline__ int64_t code_key(uint64_t c, const Window& w) {
  const uint64_t W = (uint64_t)w.W;
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
// the CTA (every thread calls it); *total gets the whole CTA's
template <typename T, typename Op>
__device__ __forceinline__ T block_exclusive_scan(T v, T id, Op op, T* total) {
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

__device__ __forceinline__ int block_exclusive_sum(int v, int* total) {
  return block_exclusive_scan(v, 0, Sum(), total);
}

// ---------------------------------------------------------------- passes

// the first pass's histogram, from the int64 keys: valid keys inside the
// window count in their digit, a valid key outside sets the flag
__global__ void ingest_sort_hist_kernel(const int64_t* __restrict__ keys, long long n,
                                        int* __restrict__ status, Window w, int nbins,
                                        int n_tiles, int* __restrict__ hist) {  // [nbins, n_tiles]
  __shared__ int cnt[kMaxBins];
  for (int t = threadIdx.x; t < nbins; t += kThreads) cnt[t] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * kTile;
  int bad = 0;
  for (int k = 0; k < kItems; ++k) {
    const long long i = base + (long long)k * kThreads + threadIdx.x;
    if (i >= n) break;
    const int64_t key = keys[i];
    uint64_t c = 0;
    const bool ok = key != kSentinel && key_code(key, w, &c);
    bad |= key != kSentinel && !ok;
    if (ok) atomicAdd(&cnt[(int)(c & (uint64_t)(nbins - 1))], 1);
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) atomicOr(&status[kFlag], 1);
  for (int t = threadIdx.x; t < nbins; t += kThreads)
    hist[(size_t)t * n_tiles + blockIdx.x] = cnt[t];
}

// one CTA a row: the exclusive scan of rows[row, :n] in place, the row's
// total to row_tot[row], and added to *total where given; the CTAs also zero
// the ``zero_rows`` rows of n of ``zero`` (the next pass's histogram)
__global__ void ingest_sort_scan_kernel(int* __restrict__ rows, int n,
                                        int* __restrict__ row_tot, int* __restrict__ total,
                                        int* __restrict__ zero, int zero_rows) {
  if (zero) {
    for (size_t j = (size_t)blockIdx.x * kThreads + threadIdx.x; j < (size_t)zero_rows * n;
         j += (size_t)gridDim.x * kThreads)
      zero[j] = 0;
  }
  int* row = rows + (size_t)blockIdx.x * n;
  int carry = 0;
  for (int c0 = 0; c0 < n; c0 += kThreads) {
    const int i = c0 + threadIdx.x;
    const int v = i < n ? row[i] : 0;
    int sum;
    const int ex = block_exclusive_sum(v, &sum);
    if (i < n) row[i] = carry + ex;
    carry += sum;
  }
  if (threadIdx.x == 0) {
    if (row_tot) row_tot[blockIdx.x] = carry;
    if (total) atomicAdd(total, carry);
  }
}

template <typename KeyT, bool kFirst, bool kLast>
__global__ void __launch_bounds__(kThreads)
ingest_sort_scatter_kernel(const int64_t* __restrict__ keys,      // kFirst
                           const KeyT* __restrict__ codes_in,     // later passes
                           const uint32_t* __restrict__ idx_in,   // later passes
                           long long n_keys, const int* __restrict__ status, Window w,
                           int shift, int nbins, int n_tiles,
                           const int* __restrict__ hist,      // scanned rows [nbins, n_tiles]
                           const int* __restrict__ row_tot,   // [nbins]
                           KeyT* __restrict__ codes_out, uint32_t* __restrict__ idx_out,
                           int64_t* __restrict__ perm,        // kLast
                           int next_shift, int next_bins,
                           int* __restrict__ next_hist) {     // !kLast: [next_bins, n_tiles]
  __shared__ int warp_cnt[kWarps][kMaxBins];
  __shared__ int digit_off[kMaxBins];   // the tile's first staged row of each digit
  __shared__ long long glob_off[kMaxBins];
  __shared__ KeyT s_code[kTile];
  __shared__ uint32_t s_idx[kTile];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  for (int t = threadIdx.x; t < kWarps * kMaxBins; t += kThreads) (&warp_cnt[0][0])[t] = 0;
  __syncthreads();

  const long long n = kFirst ? n_keys : (long long)status[kValid];
  const long long wbase = (long long)blockIdx.x * kTile + (long long)wid * 32 * kItems;
  KeyT code[kItems];
  uint32_t idx[kItems];
  int digit[kItems], rank[kItems];
  // rank the warp's keys in input order: round k holds keys wbase + 32 k + lane
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = wbase + 32LL * k + lane;
    uint64_t c = 0;
    bool ok = false;
    uint32_t ix = 0;
    if (i < n) {
      if (kFirst) {
        const int64_t key = keys[i];
        ok = key != kSentinel && key_code(key, w, &c);
        ix = (uint32_t)i;
      } else {
        c = (uint64_t)codes_in[i];
        ix = idx_in[i];
        ok = true;
      }
    }
    const int d = ok ? (int)((c >> shift) & (uint64_t)(nbins - 1)) : -1;
    const unsigned peers = __match_any_sync(kAll, d);
    const int before = ok ? warp_cnt[wid][d] : 0;
    __syncwarp();
    if (ok && (peers & lt) == 0) warp_cnt[wid][d] = before + __popc(peers);
    __syncwarp();
    code[k] = (KeyT)c;
    idx[k] = ix;
    digit[k] = d;
    rank[k] = before + __popc(peers & lt);
  }
  __syncthreads();

  // per digit: the warps' counts → their exclusive prefix in warp order; the
  // tile's digits → their first staged row; each digit's global offset
  int in_tile = 0, tot = 0;
  if (threadIdx.x < nbins) {
    for (int v = 0; v < kWarps; ++v) {
      const int c = warp_cnt[v][threadIdx.x];
      warp_cnt[v][threadIdx.x] = in_tile;
      in_tile += c;
    }
    tot = row_tot[threadIdx.x];
  }
  int n_tile, n_all;
  const int first = block_exclusive_sum(in_tile, &n_tile);
  const int dbase = block_exclusive_sum(tot, &n_all);
  if (threadIdx.x < nbins) {
    digit_off[threadIdx.x] = first;
    glob_off[threadIdx.x] =
        (long long)dbase + hist[(size_t)threadIdx.x * n_tiles + blockIdx.x];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    if (digit[k] >= 0) {
      const int p = digit_off[digit[k]] + warp_cnt[wid][digit[k]] + rank[k];
      s_code[p] = code[k];
      s_idx[p] = idx[k];
    }
  }
  __syncthreads();
  // staged row p of digit d goes to glob_off[d] + (p - digit_off[d]): each
  // digit's keys leave the tile as one contiguous run.  Before the last
  // pass, each key also counts in the next pass's histogram, at its
  // destination tile and next digit (one atomic a group of equal lanes)
  const int rounds = (n_tile + kThreads - 1) / kThreads;
  for (int q = 0; q < rounds; ++q) {
    const int p = q * kThreads + threadIdx.x;
    const bool live = p < n_tile;
    KeyT c = 0;
    long long dst = 0;
    if (live) {
      c = s_code[p];
      const int d = (int)(((uint64_t)c >> shift) & (uint64_t)(nbins - 1));
      dst = glob_off[d] + (p - digit_off[d]);
      codes_out[dst] = c;
      if (kLast) {
        perm[dst] = (int64_t)s_idx[p];
      } else {
        idx_out[dst] = s_idx[p];
      }
    }
    if (!kLast) {
      const long long slot =
          live ? (long long)(((uint64_t)c >> next_shift) & (uint64_t)(next_bins - 1)) * n_tiles
                     + dst / kTile
               : -1;
      const unsigned peers = __match_any_sync(kAll, slot);
      if (live && (peers & lt) == 0) atomicAdd(&next_hist[slot], __popc(peers));
    }
  }
}

// ---------------------------------------------------------------- run cut

// A tile's word in the run cut's look-back: its flag (aggregate or
// inclusive prefix), its heads, and its last head's row + 1 (0: none).
constexpr unsigned long long kAggregate = 1ull << 62, kInclusive = 2ull << 62;
constexpr unsigned long long kField = (1ull << 31) - 1;

__device__ __forceinline__ unsigned long long tile_word(unsigned long long flag, long long heads,
                                                        long long last1) {
  return flag | ((unsigned long long)heads << 31) | (unsigned long long)last1;
}

// The run cut in one launch, over the sorted codes in tiles of 2048 rows
// (thread t: 8 consecutive rows).  A row is a head where its code differs
// from the row before; each tile counts its heads and its last head, takes
// the heads and the last head of all tiles before it by a decoupled
// look-back (tiles numbered in the order their CTAs start, so each waits
// only on tiles already running), and then writes per run its first row
// (starts), its key decoded (ukey) and, at its last row, its length
// (counts); per row its run (rid).  status[1] gets the number of runs.
template <typename KeyT>
__global__ void __launch_bounds__(kThreads)
ingest_sort_runs_kernel(const KeyT* __restrict__ codes, int* __restrict__ status, Window w,
                        unsigned long long* __restrict__ states,  // [n_tiles], zeroed
                        int64_t* __restrict__ ukey, int64_t* __restrict__ starts,
                        int64_t* __restrict__ counts, int32_t* __restrict__ rid) {  // or null
  __shared__ int s_tile;
  __shared__ long long s_heads, s_last1;
  if (threadIdx.x == 0) s_tile = atomicAdd(&status[kTileCounter], 1);
  __syncthreads();
  const int tile = s_tile;
  const long long n = status[kValid];
  const long long i0 = (long long)tile * kTile + (long long)threadIdx.x * kItems;
  bool h[kItems];
  int c = 0;
  long long last1 = 0;  // the thread's last head row + 1
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = i0 + k;
    h[k] = i < n && (i == 0 || codes[i] != codes[i - 1]);
    if (h[k]) {
      ++c;
      last1 = i + 1;
    }
  }
  int tile_heads;
  long long tile_last1;
  const int ex = block_exclusive_sum(c, &tile_heads);
  const long long ex_last1 = block_exclusive_scan(last1, 0LL, Max(), &tile_last1);
  if (threadIdx.x == 0) {
    long long heads = 0, prev1 = 0;  // of the tiles before this one
    if (tile > 0) {
      atomicExch(&states[tile], tile_word(kAggregate, tile_heads, tile_last1));
      for (int j = tile - 1; j >= 0; --j) {
        unsigned long long st;
        do {
          st = *(volatile unsigned long long*)&states[j];
        } while ((st >> 62) == 0);
        heads += (long long)((st >> 31) & kField);
        const long long l1 = (long long)(st & kField);
        if (l1 > prev1) prev1 = l1;
        if ((st >> 62) == 2) break;
      }
    }
    atomicExch(&states[tile], tile_word(kInclusive, heads + tile_heads,
                                        tile_last1 ? tile_last1 : prev1));
    atomicMax(&status[kRuns], (int)(heads + tile_heads));
    s_heads = heads;
    s_last1 = prev1;
  }
  __syncthreads();
  long long r = s_heads + ex - 1;                  // the run of row i0 - 1
  long long head1 = ex_last1 ? ex_last1 : s_last1;  // its first row + 1
#pragma unroll
  for (int k = 0; k < kItems; ++k) {
    const long long i = i0 + k;
    if (i >= n) break;
    if (h[k]) {
      ++r;
      head1 = i + 1;
      starts[r] = i;
      ukey[r] = code_key((uint64_t)codes[i], w);
    }
    if (rid) rid[i] = (int32_t)r;
    if (i == n - 1 || codes[i + 1] != codes[i]) counts[r] = i + 2 - head1;
  }
}

size_t align_up(size_t x) { return (x + 255) & ~(size_t)255; }

struct Layout {
  size_t codes_a, codes_b, idx_a, idx_b, hist, row_tot, states, bytes;
};

Layout layout(long long N, int key_bytes) {
  const size_t n_tiles = (size_t)((N + kTile - 1) / kTile);
  Layout l{};
  size_t off = 0;
  l.codes_a = off;
  off += align_up((size_t)N * key_bytes);
  l.codes_b = off;
  off += align_up((size_t)N * key_bytes);
  l.idx_a = off;
  off += align_up((size_t)N * 4);
  l.idx_b = off;
  off += align_up((size_t)N * 4);
  l.hist = off;  // two histograms, alternating between passes
  off += align_up(2 * kMaxBins * n_tiles * 4);
  l.row_tot = off;
  off += align_up(kMaxBins * 4);
  l.states = off;
  off += align_up(n_tiles * 8);
  l.bytes = off;
  return l;
}

template <typename KeyT>
int run_sort(const int64_t* keys, long long N, Window w, int bits, char* work,
             int64_t* out, int32_t* rid, int* status, cudaStream_t st) {
  const Layout l = layout(N, (int)sizeof(KeyT));
  const int n_tiles = (int)((N + kTile - 1) / kTile);
  KeyT* codes[2] = {reinterpret_cast<KeyT*>(work + l.codes_a),
                    reinterpret_cast<KeyT*>(work + l.codes_b)};
  uint32_t* idx[2] = {reinterpret_cast<uint32_t*>(work + l.idx_a),
                      reinterpret_cast<uint32_t*>(work + l.idx_b)};
  int* hist = reinterpret_cast<int*>(work + l.hist);
  int* row_tot = reinterpret_cast<int*>(work + l.row_tot);
  unsigned long long* states = reinterpret_cast<unsigned long long*>(work + l.states);
  int64_t* perm = out;
  int64_t* ukey = out + N;
  int64_t* starts = out + 2 * N;
  int64_t* counts = out + 3 * N;
  cudaMemsetAsync(status, 0, 4 * sizeof(int), st);
  const int passes = (bits + 7) / 8;
  const int dbits = (bits + passes - 1) / passes;
  auto bins_of = [&](int p) {
    const int shift = p * dbits;
    return 1 << (bits - shift < dbits ? bits - shift : dbits);
  };
  // the first pass's histogram from the keys; each later pass's from the
  // scatter before it (the two histograms alternate)
  int* hists[2] = {hist, hist + (size_t)kMaxBins * n_tiles};
  ingest_sort_hist_kernel<<<n_tiles, kThreads, 0, st>>>(keys, N, status, w, bins_of(0),
                                                        n_tiles, hists[0]);
  int cur = 0;  // the buffers the pass reads (after the first)
  for (int p = 0; p < passes; ++p) {
    const int shift = p * dbits;
    const int nbins = bins_of(p);
    const bool first = p == 0, last = p == passes - 1;
    int* h = hists[p & 1];
    int* nh = last ? nullptr : hists[(p + 1) & 1];
    const int next_bins = last ? 1 : bins_of(p + 1);
    // the scan zeroes the next pass's histogram, or before the run cut its
    // look-back words (two ints a tile)
    ingest_sort_scan_kernel<<<nbins, kThreads, 0, st>>>(
        h, n_tiles, row_tot, first ? status + kValid : nullptr,
        last ? reinterpret_cast<int*>(states) : nh, last ? 2 : next_bins);
    KeyT* co = codes[1 - cur];
    uint32_t* io = idx[1 - cur];
#define LA3DM_SCATTER(F, L)                                                              \
  ingest_sort_scatter_kernel<KeyT, F, L><<<n_tiles, kThreads, 0, st>>>(                 \
      keys, codes[cur], idx[cur], N, status, w, shift, nbins, n_tiles, h, row_tot, co,    \
      io, perm, shift + dbits, next_bins, nh)
    if (first && last) {
      LA3DM_SCATTER(true, true);
    } else if (first) {
      LA3DM_SCATTER(true, false);
    } else if (last) {
      LA3DM_SCATTER(false, true);
    } else {
      LA3DM_SCATTER(false, false);
    }
#undef LA3DM_SCATTER
    cur = 1 - cur;
  }
  ingest_sort_runs_kernel<KeyT><<<n_tiles, kThreads, 0, st>>>(codes[cur], status, w, states,
                                                              ukey, starts, counts, rid);
  return (int)cudaGetLastError();
}

}  // namespace

// Workspace bytes K7s needs for N keys of ``key_bytes``-byte codes.
extern "C" long long la3dm_ingest_sort_workspace(long long N, int key_bytes) {
  return (long long)layout(N, key_bytes).bytes;
}

// Queue K7s on ``stream`` over the N int64 keys (1 <= N < 2^31): ``lo``,
// ``W``, ``K`` the window, ``bits`` the code's bit length, ``key_bytes`` 4 or
// 8.  ``out`` [4, N] int64 receives perm, ukey, starts, counts (their valid
// prefixes: status[0] rows of perm, status[1] runs); ``rid`` [N] int32 (or
// null) the run of each sorted row; ``status`` [4] int32 the valid keys, the
// runs and the out-of-window flag.  Returns cudaGetLastError().
extern "C" int la3dm_ingest_sort(const int64_t* keys, long long N, int lo, int W, int K,
                                 int bits, int key_bytes, void* work, long long work_bytes,
                                 int64_t* out, int32_t* rid, int32_t* status, void* stream) {
  if (N <= 0 || N >= (1LL << 31) || bits < 1 || bits > 64 || W < 1 || K < 1 ||
      (key_bytes != 4 && key_bytes != 8) || (key_bytes == 4 && bits > 32) ||
      work_bytes < (long long)layout(N, key_bytes).bytes)
    return (int)cudaErrorInvalidValue;
  const Window w{lo, W, K};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  char* ws = static_cast<char*>(work);
  int* sts = reinterpret_cast<int*>(status);
  return key_bytes == 4 ? run_sort<uint32_t>(keys, N, w, bits, ws, out, rid, sts, st)
                        : run_sort<uint64_t>(keys, N, w, bits, ws, out, rid, sts, st);
}
