// The bottom-up raster prune of K2, the BGK light pass (csrc/bgk_light.cu),
// for blocks of any n <= 64.  It serves K2 only: K5 and K8 vote each
// level over a Morton order (csrc/group_prune.cuh).
//
// The port of la3dm_tpu/models/pruning.py::prune_blocks on the raster pool
// (v = x + y*n + z*n*n, x fastest).  Levels L = 1..max_level: a
// 2^L-aligned group collapses iff every voxel in it has eff == L-1, every
// voxel has the same state, and that state is not UNKNOWN; the
// minimum-corner voxel's f0, f1, touched and state are copied to the group
// and eff is set to L.
//
// Two shapes:
// * n <= 8 (V <= 512): one CTA holds the whole block, one thread per voxel,
//   and raster_prune runs every level in shared memory.
// * n >= 16: one CTA per 8^3 tile of the block, one thread per voxel
//   (tile_voxel maps the thread to its strided raster voxel; the pool is
//   not permuted).  raster_prune runs the levels inside the tile (2^L <= 8)
//   on the tile's own raster, the CTA writes its tile back, then
//   cross_tile_prune runs the levels above (2^L > 8), which depend only on
//   per-tile summaries: the tile's eff and state if uniform (else -1) and
//   its corner voxel's f0, f1 and touched.  Each CTA writes its summary,
//   fences and counts itself in on its block's counter; the block's last
//   CTA runs those levels over the block's tiles in shared memory and
//   rewrites the tiles that collapsed.  This is K8's design
//   (csrc/lv_prune.cu) on the raster layout.

#pragma once

#include <stdint.h>

namespace la3dm {

constexpr int8_t kFree = 0, kOccupied = 1, kUnknown = 2;
constexpr int kTileEdge = 8;                // voxels per tile edge
constexpr int kTileV = 512;                 // voxels per tile
constexpr int kMaxTiles = 512;              // tiles per block (n <= 64)
constexpr int kTileLevels = 3;              // levels inside a tile (2^3 = 8)

// The raster voxel (within its block of edge n >= 8) of voxel vt of tile
// pos; tiles and their voxels are both raster, x fastest.
static __device__ __forceinline__ int tile_voxel(int pos, int vt, int n) {
  const int tpa = n / kTileEdge;
  const int tx = pos % tpa, ty = (pos / tpa) % tpa, tz = pos / (tpa * tpa);
  const int lx = vt % kTileEdge, ly = (vt / kTileEdge) % kTileEdge,
            lz = vt / (kTileEdge * kTileEdge);
  return (tx * kTileEdge + lx) + (ty * kTileEdge + ly) * n +
         (tz * kTileEdge + lz) * n * n;
}

// Levels 1..max_level of one cube of edge n held in shared memory, one
// thread per voxel v (raster).  The caller fills f0/f1, touched, eff and
// each voxel's state under its family's rules; every thread of the CTA
// calls this.  On return the arrays hold the pruned cube and every thread
// has passed a __syncthreads().
static __device__ __forceinline__ void raster_prune(float* f0, float* f1,
                                                    uint8_t* sT, int8_t* sE,
                                                    int8_t* sS, int v, int n,
                                                    int max_level) {
  __syncthreads();  // every voxel's inputs are in shared memory
  const int x = v % n, y = (v / n) % n, z = v / (n * n);
  for (int L = 1; L <= max_level; ++L) {
    const int m = 1 << L;
    const int bx = x & ~(m - 1), by = y & ~(m - 1), bz = z & ~(m - 1);
    const int c = bx + by * n + bz * n * n;  // minimum corner of the group
    const int8_t st = sS[c];
    bool ok = st != kUnknown;
    for (int dz = 0; dz < m && ok; ++dz)
      for (int dy = 0; dy < m && ok; ++dy)
        for (int dx = 0; dx < m && ok; ++dx) {
          const int u = (bx + dx) + (by + dy) * n + (bz + dz) * n * n;
          ok = sE[u] == L - 1 && sS[u] == st;
        }
    const float c0 = f0[c], c1 = f1[c];
    const uint8_t cT = sT[c];
    __syncthreads();  // every thread has read the level's inputs
    if (ok) {
      f0[v] = c0;
      f1[v] = c1;
      sT[v] = cT;
      sS[v] = st;
      sE[v] = (int8_t)L;
    }
    __syncthreads();
  }
}

// Levels kTileLevels+1..max_level of a tiled block (n >= 16), called by
// every thread of each of the block's tiles after the tile's in-tile levels
// (raster_prune with n = kTileEdge) and after the thread has written its
// voxel back to the pool.  g0/g1/gT/gE: the pool, base = slot * n^3.
// s0..sS: the tile's shared arrays (kTileV entries; the last CTA reuses
// them for the tile summaries).  vt: the thread's voxel in the tile, pos:
// the tile, tile0: the summary index of the block's tile 0.  sum_es [.,2]
// (eff, state), sum_f [.,2] (f0, f1), sum_t [.]: scratch of one entry per
// tile of the launch; counter: the block's counter, 0 at the launch.
static __device__ __forceinline__ void cross_tile_prune(
    float* __restrict__ g0, float* __restrict__ g1, uint8_t* __restrict__ gT,
    int8_t* __restrict__ gE, size_t base, int n, int max_level, float* s0,
    float* s1, uint8_t* sT, int8_t* sE, int8_t* sS, int vt, int pos, size_t tile0,
    int8_t* __restrict__ sum_es, float* __restrict__ sum_f,
    uint8_t* __restrict__ sum_t, int32_t* counter) {
  __shared__ bool is_last;
  __shared__ uint8_t changed[kMaxTiles];
  const int tpa = n / kTileEdge;
  const int tpb = tpa * tpa * tpa;
  // this thread's voxel is written before its CTA is counted in: the last
  // CTA may rewrite it
  __threadfence();
  const bool same_e = __syncthreads_and(sE[vt] == sE[0]);
  const bool same_s = __syncthreads_and(sS[vt] == sS[0]);
  const size_t ti = tile0 + pos;
  if (vt == 0) {
    sum_es[2 * ti + 0] = same_e ? sE[0] : (int8_t)-1;
    sum_es[2 * ti + 1] = same_s ? sS[0] : (int8_t)-1;
    sum_f[2 * ti + 0] = s0[0];
    sum_f[2 * ti + 1] = s1[0];
    sum_t[ti] = sT[0];
    __threadfence();  // the summary is visible before the count
    is_last = atomicAdd(counter, 1) == tpb - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // the shared arrays now hold the block's tiles, thread u for tile u
  const int u = vt;
  const bool tile = u < tpb;
  if (tile) {
    const size_t k = tile0 + u;
    sE[u] = __ldcg(&sum_es[2 * k + 0]);
    sS[u] = __ldcg(&sum_es[2 * k + 1]);
    s0[u] = __ldcg(&sum_f[2 * k + 0]);
    s1[u] = __ldcg(&sum_f[2 * k + 1]);
    sT[u] = __ldcg(&sum_t[k]);
    changed[u] = 0;
  }
  __syncthreads();
  const int tx = u % tpa, ty = (u / tpa) % tpa, tz = u / (tpa * tpa);
  for (int L = kTileLevels + 1; L <= max_level; ++L) {
    const int m = 1 << (L - kTileLevels);  // tiles per group edge
    bool ok = false;
    float c0 = 0.f, c1 = 0.f;
    uint8_t cT = 0;
    int8_t st = 0;
    if (tile) {
      const int bx = tx & ~(m - 1), by = ty & ~(m - 1), bz = tz & ~(m - 1);
      const int c = bx + by * tpa + bz * tpa * tpa;  // the group's corner tile
      st = sS[c];
      ok = st >= 0 && st != kUnknown;  // -1: the tile's states differ
      for (int dz = 0; dz < m && ok; ++dz)
        for (int dy = 0; dy < m && ok; ++dy)
          for (int dx = 0; dx < m && ok; ++dx) {
            const int w = (bx + dx) + (by + dy) * tpa + (bz + dz) * tpa * tpa;
            ok = sE[w] == L - 1 && sS[w] == st;
          }
      c0 = s0[c];
      c1 = s1[c];
      cT = sT[c];
    }
    __syncthreads();  // every thread has read the level's inputs
    if (ok) {
      s0[u] = c0;
      s1[u] = c1;
      sT[u] = cT;
      sS[u] = st;
      sE[u] = (int8_t)L;
      changed[u] = 1;
    }
    __syncthreads();
  }
  // rewrite the collapsed tiles: every voxel takes its tile's new values
  for (int k = vt; k < tpb * kTileV; k += blockDim.x) {
    const int w = k / kTileV;
    if (!changed[w]) continue;
    const size_t q = base + tile_voxel(w, k % kTileV, n);
    g0[q] = s0[w];
    g1[q] = s1[w];
    gT[q] = sT[w];
    gE[q] = sE[w];
  }
}

}  // namespace la3dm
