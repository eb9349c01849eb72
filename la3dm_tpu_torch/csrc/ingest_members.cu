// K7c — the closed-box membership expansion of device scan ingest,
// hand-written for Hopper (sm_90a).
//
// Replaces la3dm_tpu/geometry/device_ingest.py::_closed_box_memberships
// (lines 256-283) and the key packing of _local_keys (lines 286-295).  For
// each training entry e of scan s, per axis:
//   base = floor(e / bs + 0.5), and the closed-box test
//   ctr - half <= e <= ctr + half with ctr = c * bs, for c = base, base+1,
//   base-1 (all in f32); at most two of the three pass, so the second
//   candidate is base+1 if it passes, else base-1.
// Candidate j (bits (j>>2, j>>1, j) & 1 on x, y, z, the JAX meshgrid order)
// takes base where its bit is 0 and the second candidate where it is 1; it
// is a membership iff each axis's test passes and the entry is valid, and
// its block key is ingest_keys.cuh's.
//
// Two layouts, one pass over tiles of kTileE = 512 entries (256 threads,
// entries tid and tid + 256 of the tile a thread, so that the scan and flag
// loads coalesce; the tile's coordinates pass through shared memory, read
// as one flat float array).  A thread computes each of its entries'
// candidates once: the membership mask, and the six 16-bit key fields (a
// base and a second candidate an axis) staged in shared memory, from which
// any candidate's key is an OR of shifts.
// * compact (the point family): only the memberships that exist, in the
//   (entry, candidate j) order of the dense layout, as keys mkey[0, M) and
//   their entries mrow[0, M), and M in *count (on the device: the sort that
//   follows reads it there).  A CTA scan of both entries' counts at once
//   (popcounts of the masks, 16 bits each) gives each its place in the
//   tile; the tile publishes its count, stages its memberships in order (as
//   entry * 8 + j, 2 bytes each), and takes its place among the tiles by a
//   decoupled look-back (tile_scan.cuh: tiles numbered in the order their
//   CTAs start, from an atomic counter, so each waits only on tiles already
//   running); then each staged membership's key leaves with its entry,
//   coalesced.  23 KB of shared memory and at most 42 registers a CTA keep
//   6 CTAs on an SM.  The look-back words carry the launch's epoch, so the
//   scratch needs no memset; the last tile sets the tile counter back to 0.
// * dense (BGKL's hits, which the ray pairs follow in one key array whose
//   size the host knows): 8 slots an entry, key or the sentinel at 8e + j,
//   the entry e beside each, a thread a slot (coalesced); no look-back.
// What bounds it: bytes (17 bytes in an entry; 12 out a membership, or 96
// an entry in the dense layout).

#include <cuda_runtime.h>
#include <stdint.h>

#include "ingest_keys.cuh"
#include "tile_scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 2;                   // entries a thread
constexpr int kTileE = kThreads * kPer;   // entries a tile
constexpr int kSlots = 8 * kTileE;        // candidate slots a tile

// The candidate blocks of the entry at ent[0..2]: per axis its base and
// second candidate, and the mask (bit j: candidate j is a membership).
__device__ __forceinline__ unsigned candidates(const float* ent, bool valid, float bs,
                                               float half, int (&base)[3], int (&second)[3]) {
  bool base_ok[3], sec_ok[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float v = ent[a];
    const int b = (int)floorf(v / bs + 0.5f);
    bool ok[3];  // base, base + 1, base - 1
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float ctr = (float)(b + (c == 0 ? 0 : (c == 1 ? 1 : -1))) * bs;
      ok[c] = (ctr - half <= v) && (v <= ctr + half);
    }
    base[a] = b;
    base_ok[a] = ok[0];
    second[a] = ok[1] ? b + 1 : b - 1;
    sec_ok[a] = ok[1] || ok[2];
  }
  unsigned mask = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int bx = (j >> 2) & 1, by = (j >> 1) & 1, bz = j & 1;
    const bool ok = valid && (bx ? sec_ok[0] : base_ok[0]) && (by ? sec_ok[1] : base_ok[1]) &&
                    (bz ? sec_ok[2] : base_ok[2]);
    mask |= (ok ? 1u : 0u) << j;
  }
  return mask;
}

// The key of candidate j of tile entry le from its staged key fields
// (f[6 le + 2 a]: axis a's base candidate, + 1: its second, as
// ingest_keys.cuh's 16-bit fields) and scan: pack_key's bits.
__device__ __forceinline__ int64_t staged_key(const uint16_t* f, const int* s_scan, int le,
                                              int j) {
  const uint16_t* e = f + 6 * le;
  return ((int64_t)s_scan[le] << 48) | ((int64_t)e[4 + (j & 1)] << 32) |
         ((int64_t)e[2 + ((j >> 1) & 1)] << 16) | (int64_t)e[(j >> 2) & 1];
}

// 6 CTAs an SM (at most 42 registers): a tile is a few latencies long, and
// the CTAs of an SM overlap them
template <bool kDense>
__global__ void __launch_bounds__(kThreads, 6)
ingest_members_kernel(const float* __restrict__ ent,        // [E,3]
                      const int32_t* __restrict__ scan,     // [E]
                      const bool* __restrict__ evalid,      // [E]
                      const int32_t* __restrict__ anchors,  // [K,3]
                      long long E, float bs, float half,
                      int64_t* __restrict__ mkey,           // [8E]: compact [M] / dense
                      int32_t* __restrict__ mrow,           // the same
                      int32_t* __restrict__ count,          // compact: M
                      unsigned* __restrict__ counter,       // compact: the tile counter
                      unsigned long long* __restrict__ look,  // compact: [tiles]
                      unsigned epoch, int n_tiles) {
  __shared__ float s_ent[3 * kTileE];
  __shared__ int s_scan[kTileE];
  __shared__ uint16_t s_field[6 * kTileE];  // each entry's key fields, base and second
  __shared__ uint8_t s_mask[kTileE];        // dense: each entry's memberships
  __shared__ uint16_t s_code[kSlots];       // compact: the staged memberships, le * 8 + j
  __shared__ int s_tile;
  __shared__ long long s_base;
  const int tile = kDense ? (int)blockIdx.x : tile_scan::take_tile(counter, n_tiles, &s_tile);
  const long long e0 = (long long)tile * kTileE;
  const int ne = (int)(E - e0 < kTileE ? E - e0 : kTileE);
  for (int i = threadIdx.x; i < 3 * ne; i += kThreads) s_ent[i] = ent[3 * e0 + i];
  int s[kPer];
  bool valid[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int le = k * kThreads + threadIdx.x;
    s[k] = le < ne ? scan[e0 + le] : 0;
    valid[k] = le < ne && evalid[e0 + le];
  }
  __syncthreads();
  // each entry's candidates once: its mask and its key fields
  unsigned mask[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int le = k * kThreads + threadIdx.x;
    int base[3], second[3];
    mask[k] = candidates(&s_ent[3 * (le < ne ? le : 0)], valid[k], bs, half, base, second);
    const int32_t* anchor = anchors + 3 * s[k];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      s_field[6 * le + 2 * a] = (uint16_t)key_field(base[a], anchor[a]);
      s_field[6 * le + 2 * a + 1] = (uint16_t)key_field(second[a], anchor[a]);
    }
    s_scan[le] = s[k];
    if (kDense) s_mask[le] = (uint8_t)mask[k];
  }
  if (kDense) {  // 8 slots an entry, a thread a slot
    __syncthreads();
    for (int i = threadIdx.x; i < 8 * ne; i += kThreads) {
      const int le = i >> 3, j = i & 7;
      mkey[8 * e0 + i] = (s_mask[le] >> j) & 1u ? staged_key(s_field, s_scan, le, j)
                                                : kSentinel;
      mrow[8 * e0 + i] = (int32_t)(e0 + le);
    }
    return;
  }
  // each entry's place in the tile: one scan of both entries' counts (the
  // first entry's in the low 16 bits), entries in tile order k*256 + tid
  unsigned total;
  const unsigned ex =
      tile_scan::block_exclusive_sum<kThreads>(__popc(mask[0]) | (__popc(mask[1]) << 16), &total);
  const unsigned tot0 = total & 0xFFFFu, tot = tot0 + (total >> 16);
  // the tile's count, published before its memberships are staged
  tile_scan::publish(look, epoch, tile, tot);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int le = k * kThreads + threadIdx.x;
    unsigned at = k == 0 ? (ex & 0xFFFFu) : tot0 + (ex >> 16);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if ((mask[k] >> j) & 1u) s_code[at++] = (uint16_t)(le * 8 + j);
  }
  if (threadIdx.x < 32) {
    const unsigned long long before = tile_scan::place(look, epoch, tile, n_tiles, tot, count);
    if (threadIdx.x == 0) s_base = (long long)before;
  }
  __syncthreads();
  const long long b0 = s_base;
  for (int i = threadIdx.x; i < (int)tot; i += kThreads) {
    const int c = s_code[i], le = c >> 3;
    mkey[b0 + i] = staged_key(s_field, s_scan, le, c & 7);
    mrow[b0 + i] = (int32_t)(e0 + le);
  }
}

}  // namespace

// Launch K7c on ``stream`` over E entries (1 <= E, 8E < 2^30), in tiles of
// 512.  Compact (``dense`` == 0): mkey [8E] and mrow [8E] get the M
// memberships in order on their first M rows, *count M; ``counter`` (one
// word, zero, which the launch leaves zero) and ``look`` (one word a tile,
// none of epoch ``epoch``) are kept by the caller.  Dense: mkey [8E] and mrow
// [8E] every slot (the sentinel where no membership), count, counter and
// look unused.  Returns cudaGetLastError().
extern "C" int la3dm_ingest_members(const float* ent, const int32_t* scan,
                                    const bool* evalid, const int32_t* anchors,
                                    long long E, float bs, float half, int dense,
                                    int64_t* mkey, int32_t* mrow, int32_t* count,
                                    unsigned* counter, unsigned long long* look,
                                    unsigned epoch, void* stream) {
  if (E <= 0 || 8 * E >= (1LL << 30) || (!dense && (count == nullptr || counter == nullptr ||
                                                    look == nullptr || epoch == 0u)))
    return (int)cudaErrorInvalidValue;
  const int tiles = (int)((E + kTileE - 1) / kTileE);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dense) {
    ingest_members_kernel<true><<<tiles, kThreads, 0, s>>>(ent, scan, evalid, anchors, E, bs,
                                                           half, mkey, mrow, count, counter,
                                                           look, epoch, tiles);
  } else {
    ingest_members_kernel<false><<<tiles, kThreads, 0, s>>>(ent, scan, evalid, anchors, E, bs,
                                                            half, mkey, mrow, count, counter,
                                                            look, epoch, tiles);
  }
  return (int)cudaGetLastError();
}
