// K8 — the BGKLV tile-major prune, hand-written for Hopper (sm_90a).
//
// Replaces la3dm_tpu/models/bgklv.py::_prune_step_tilemajor (lines 216-239:
// models/pruning.py::prune_blocks with posterior.LVStateFn between a
// stored -> raster and a raster -> stored column permutation), directly on
// the tile-major pool: stored column pos * Vt + vt holds the voxel at
// in-tile raster vt of tile pos (tiles of te = min(8, n) voxels per edge,
// raster over the block).  There is no permutation round trip.
//
// Collapse rule per level L = 1..max_level (bottom up): a 2^L-aligned group
// collapses iff every voxel in it has eff == L-1, every voxel has the
// group's minimum-corner state, and that state is not UNKNOWN (UNCERTAIN
// collapses); the group takes the corner voxel's A, B, touched and state,
// and eff = L.  States follow posterior.py::lv_state in f32 (no FMA
// contraction).
//
// Design: one CTA per (block, tile), four raster-consecutive voxels a thread
// (Vt / 4 <= 128 threads: a CTA of 8^3 voxels is 4 warps, so that all of
// the large map's tiles fit on the card at once), the prune of
// csrc/group_prune.cuh (shared with K5) with N = 4.
// * Each thread loads its voxels' touched flags (4 bytes); a tile with none
//   touched is all UNKNOWN, changes nowhere and reads nothing more.
//   Otherwise each thread loads the rest of its voxels (the tile's Vt
//   voxels are contiguous: 16-byte loads) and computes their states (an
//   untouched voxel is UNKNOWN); the voxels pass through shared memory into
//   Morton order, where each level inside the tile (2^L <= te) is one vote;
//   a thread writes a voxel back only where it collapsed.
// * Levels with 2^L > te (16^3 and 32^3 groups at block_depth 6) depend only
//   on per-tile summaries: the tile's eff and state if uniform (else -1) and
//   its corner voxel's A, B, touched.  Each CTA writes its summary, fences,
//   and counts itself in on a per-block counter; the last CTA of a block
//   votes those levels over the block's tiles in Morton order and rewrites
//   the tiles that collapsed (every voxel takes the group corner's values).
// * What bounds it: bytes.  The prune needs each voxel's touched byte, the
//   A, B (4 bytes each) and eff (1 byte) of each touched voxel, and each
//   voxel that collapsed written once (10 bytes); the kernel reads A, B
//   and eff of every voxel of a tile that holds a touched voxel, and 11
//   bytes of summary a tile.  A slot equal to the pool capacity is padding:
//   its CTAs return.

#include <cuda_runtime.h>
#include <stdint.h>

#include "group_prune.cuh"

namespace {

using la3dm::vote::Cubes;
using la3dm::vote::Item;
using la3dm::vote::Votes;

constexpr int kMaxVt = 512;     // voxels per tile (8^3)
constexpr int kMaxTiles = 512;  // tiles per block (n <= 64)
constexpr int kN = 4;           // voxels a thread: 4 raster-consecutive ones
constexpr int8_t kFree = 0, kOccupied = 1, kUnknown = 2, kUncertain = 3;

// The state of a touched voxel (an untouched one is UNKNOWN).
__device__ __forceinline__ int8_t lv_state(float A, float B, float min_W, float var_thresh,
                                           float free_thresh, float occupied_thresh) {
  const float W = fmaxf(A + B, min_W);
  const float occ = A / (W - B) + (W - A - B) * 0.5f / (W - B);
  const float fre = 0.5f * (W - B - A) / (W - A);
  const float p = A > B ? occ : fre;
  const float q = 1.0f - p;
  const float h = 0.5f - p;
  const float var = (A / W) * (q * q) + ((W - A - B) / W) * (h * h) + (B / W) * (p * p);
  int8_t st = p > occupied_thresh ? kOccupied : (p < free_thresh ? kFree : kUnknown);
  if (var > var_thresh) st = kUncertain;
  return st;
}

__device__ __forceinline__ int ilog2(int x) { return 31 - __clz(x); }

__global__ void lv_prune_kernel(float* __restrict__ A, float* __restrict__ B,
                                uint8_t* __restrict__ touched,
                                int8_t* __restrict__ eff,
                                const int32_t* __restrict__ slots,  // [S]
                                int8_t* __restrict__ sum_es,        // [S*tpb,2]
                                float* __restrict__ sum_ab,         // [S*tpb,2]
                                uint8_t* __restrict__ sum_t,        // [S*tpb]
                                int32_t* __restrict__ counters,     // [S], zero
                                int cap, int n, int max_level, float min_W,
                                float var_thresh, float free_thresh,
                                float occupied_thresh) {
  __shared__ Cubes cubes;
  __shared__ Votes votes;
  __shared__ int16_t changed[kMaxTiles];

  const int te = n < 8 ? n : 8;
  const int Vt = te * te * te;
  const int tpa = n / te;
  const int tpb = tpa * tpa * tpa;
  const int s = blockIdx.x / tpb;
  const int pos = blockIdx.x % tpb;
  const int slot = slots[s];
  if (slot < 0 || slot >= cap) return;  // padding: uniform over the CTA
  const int i = threadIdx.x;
  const bool live = kN * i < Vt;  // Vt is a multiple of kN
  const size_t V = (size_t)n * n * n;
  const size_t p = (size_t)slot * V + (size_t)pos * Vt + kN * i;  // the thread's voxels
  const int lt = ilog2(te);
  const int in_levels = max_level < lt ? max_level : lt;

  const uchar4 t4 = live ? *reinterpret_cast<const uchar4*>(touched + p)
                         : make_uchar4(0, 0, 0, 0);
  const uint8_t T[kN] = {t4.x, t4.y, t4.z, t4.w};
  // levels across tiles exist only with 8^3 tiles (Vt = kN * blockDim.x);
  // the summary of a tile with no touched voxel: every state is UNKNOWN, so
  // no group that holds the tile collapses, in it or across
  Item sum{0.f, 0.f, (int8_t)-1, kUnknown, 0};
  if (__syncthreads_or((t4.x | t4.y | t4.z | t4.w) != 0)) {  // else nothing changes
    Item it[kN];
    if (live) {
      const float4 a4 = *reinterpret_cast<const float4*>(A + p);
      const float4 b4 = *reinterpret_cast<const float4*>(B + p);
      const char4 e4 = *reinterpret_cast<const char4*>(eff + p);
      const float a[kN] = {a4.x, a4.y, a4.z, a4.w}, b[kN] = {b4.x, b4.y, b4.z, b4.w};
      const int8_t e[kN] = {e4.x, e4.y, e4.z, e4.w};
#pragma unroll
      for (int j = 0; j < kN; ++j)  // an untouched voxel is UNKNOWN: no divisions
        it[j] = Item{a[j], b[j], e[j],
                     T[j] != 0 ? lv_state(a[j], b[j], min_W, var_thresh, free_thresh,
                                          occupied_thresh)
                               : kUnknown,
                     T[j]};
    } else {
#pragma unroll
      for (int j = 0; j < kN; ++j) it[j] = la3dm::vote::no_item();
    }
    // levels inside the tile
    if (in_levels > 0) {
      int8_t e_in[kN];
#pragma unroll
      for (int j = 0; j < kN; ++j) e_in[j] = it[j].eff;
      la3dm::vote::prune_cubes<kN>(it, te, in_levels, cubes, votes);
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        if (live && it[j].eff != e_in[j]) {  // collapsed: a collapse raises eff
          A[p + j] = it[j].f0;
          B[p + j] = it[j].f1;
          touched[p + j] = it[j].touched;
          eff[p + j] = it[j].eff;
        }
      }
    }
    if (max_level <= lt) return;  // no level spans tiles
    if (i < 32) sum = la3dm::vote::tile_summary(cubes, votes);
  } else if (max_level <= lt) {
    return;
  }
  const size_t tile0 = (size_t)s * tpb;
  if (!la3dm::vote::count_in(sum, tile0 + pos, sum_es, sum_ab, sum_t, &counters[s], tpb))
    return;
  const int collapsed = la3dm::vote::cross_tile_levels<kN>(sum_es, sum_ab, sum_t, tile0, tpa,
                                                           max_level, cubes, changed, votes);
  // rewrite the collapsed tiles: every voxel takes its tile's new values
  for (int j = 0; j < collapsed; ++j) {
    const int w = changed[j];
    const size_t o = (size_t)slot * V + (size_t)w * Vt + kN * i;
    const float f0 = cubes.f0[w], f1 = cubes.f1[w];
    const uint8_t tw = cubes.T[w];
    const int8_t ew = cubes.E[w];
    *reinterpret_cast<float4*>(A + o) = make_float4(f0, f0, f0, f0);
    *reinterpret_cast<float4*>(B + o) = make_float4(f1, f1, f1, f1);
    *reinterpret_cast<uchar4*>(touched + o) = make_uchar4(tw, tw, tw, tw);
    *reinterpret_cast<char4*>(eff + o) = make_char4(ew, ew, ew, ew);
  }
}

}  // namespace

// Launch K8 for the blocks ``slots[0..S)`` on ``stream``: S * tpb CTAs of
// Vt / 4 threads rounded up to a warp (n >= 2).  A and B 16-byte aligned,
// touched and eff 4-byte aligned.  ``counters`` [S] must be zero; the
// launch leaves them zero.  Returns cudaGetLastError().
extern "C" int la3dm_lv_prune(float* A, float* B, uint8_t* touched, int8_t* eff,
                              const int32_t* slots, int8_t* sum_es, float* sum_ab,
                              uint8_t* sum_t, int32_t* counters, int S, int cap,
                              int n, int max_level, float min_W, float var_thresh,
                              float free_thresh, float occupied_thresh,
                              void* stream) {
  if (S <= 0 || n < 2 || (n & (n - 1)) != 0) return (int)cudaErrorInvalidValue;
  const int te = n < 8 ? n : 8;
  const int Vt = te * te * te;
  const int tpa = n / te;
  const int tpb = tpa * tpa * tpa;
  const int threads = ((Vt / kN + 31) / 32) * 32;
  if (tpb > kMaxTiles || Vt > kMaxVt || (size_t)S * tpb > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  lv_prune_kernel<<<S * tpb, threads, 0, st>>>(A, B, touched, eff, slots, sum_es, sum_ab,
                                               sum_t, counters, cap, n, max_level,
                                               min_W, var_thresh, free_thresh,
                                               occupied_thresh);
  return (int)cudaGetLastError();
}
