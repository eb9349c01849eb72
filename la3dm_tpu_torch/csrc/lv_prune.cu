// K8 — the BGKLV tile-major prune, hand-written for Hopper (sm_90a).
//
// Replaces la3dm_tpu/models/bgklv.py::_prune_step_tilemajor (lines 211-239:
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
// Design: one CTA per (block, tile), one thread per voxel (Vt <= 512).
// * Levels with 2^L <= te lie inside one tile, whose Vt voxels are
//   contiguous: they run in shared memory as in K2 (csrc/bgk_light.cu), and
//   the CTA writes its tile back.
// * Levels with 2^L > te (16^3 and 32^3 groups at block_depth 6) depend only
//   on per-tile summaries: the tile's eff and state if uniform (else -1) and
//   its corner voxel's A, B, touched.  Each CTA writes its summary, fences,
//   and counts itself in on a per-block counter; the last CTA of a block
//   runs those levels over the block's tiles in shared memory and rewrites
//   the tiles that collapsed (every voxel takes the group corner's values).
// * What bounds it: bytes.  Each pool byte of the scan's blocks is read once
//   and written once (A, B 4 bytes, touched and eff 1 byte each); the
//   summaries are 11 bytes a tile.  A slot equal to the pool capacity is
//   padding: its CTAs return.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxVt = 512;     // voxels per tile (8^3)
constexpr int kMaxTiles = 512;  // tiles per block (n <= 64)
constexpr int8_t kFree = 0, kOccupied = 1, kUnknown = 2, kUncertain = 3;

__device__ __forceinline__ int8_t lv_state(float A, float B, bool touched,
                                           float min_W, float var_thresh,
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
  return touched ? st : kUnknown;
}

__device__ __forceinline__ int ilog2(int x) { return 31 - __clz(x); }

__global__ void lv_prune_kernel(float* __restrict__ A, float* __restrict__ B,
                                uint8_t* __restrict__ touched,
                                int8_t* __restrict__ eff,
                                const int32_t* __restrict__ slots,  // [S]
                                int8_t* __restrict__ sum_es,        // [S*tpb,2]
                                float* __restrict__ sum_ab,         // [S*tpb,2]
                                uint8_t* __restrict__ sum_t,        // [S*tpb]
                                int32_t* __restrict__ counters,     // [S], zeroed
                                int cap, int n, int max_level, float min_W,
                                float var_thresh, float free_thresh,
                                float occupied_thresh) {
  __shared__ float sA[kMaxVt], sB[kMaxVt];
  __shared__ uint8_t sT[kMaxVt];
  __shared__ int8_t sE[kMaxVt], sS[kMaxVt];
  __shared__ bool is_last;

  const int te = n < 8 ? n : 8;
  const int Vt = te * te * te;
  const int tpa = n / te;
  const int tpb = tpa * tpa * tpa;
  const int s = blockIdx.x / tpb;
  const int pos = blockIdx.x % tpb;
  const int slot = slots[s];
  if (slot < 0 || slot >= cap) return;  // padding: uniform over the CTA
  const int v = threadIdx.x;
  const bool live = v < Vt;
  const size_t V = (size_t)n * n * n;
  const size_t p = (size_t)slot * V + (size_t)pos * Vt + v;

  if (live) {
    sA[v] = A[p];
    sB[v] = B[p];
    sT[v] = touched[p];
    sE[v] = eff[p];
    sS[v] = lv_state(sA[v], sB[v], sT[v] != 0, min_W, var_thresh, free_thresh,
                     occupied_thresh);
  }
  __syncthreads();

  // levels inside the tile
  const int lt = ilog2(te);
  const int in_levels = max_level < lt ? max_level : lt;
  const int x = v % te, y = (v / te) % te, z = v / (te * te);
  for (int L = 1; L <= in_levels; ++L) {
    const int m = 1 << L;
    bool ok = false;
    float cA = 0.f, cB = 0.f;
    uint8_t cT = 0;
    int8_t st = 0;
    if (live) {
      const int bx = x & ~(m - 1), by = y & ~(m - 1), bz = z & ~(m - 1);
      const int c = bx + by * te + bz * te * te;  // minimum corner of the group
      st = sS[c];
      ok = st != kUnknown;
      for (int dz = 0; dz < m && ok; ++dz)
        for (int dy = 0; dy < m && ok; ++dy)
          for (int dx = 0; dx < m && ok; ++dx) {
            const int u = (bx + dx) + (by + dy) * te + (bz + dz) * te * te;
            ok = sE[u] == L - 1 && sS[u] == st;
          }
      cA = sA[c];
      cB = sB[c];
      cT = sT[c];
    }
    __syncthreads();  // every thread has read the level's inputs
    if (ok) {
      sA[v] = cA;
      sB[v] = cB;
      sT[v] = cT;
      sS[v] = st;
      sE[v] = (int8_t)L;
    }
    __syncthreads();
  }
  if (live && in_levels > 0) {
    A[p] = sA[v];
    B[p] = sB[v];
    touched[p] = sT[v];
    eff[p] = sE[v];
  }
  if (max_level <= lt) return;  // no level spans tiles
  // the tile is written before this CTA is counted in: the last CTA may
  // rewrite it
  __threadfence();

  // levels across tiles: this tile's summary, then the block's last CTA
  const bool same_e = __syncthreads_and(!live || sE[v] == sE[0]);
  const bool same_s = __syncthreads_and(!live || sS[v] == sS[0]);
  const size_t ti = (size_t)s * tpb + pos;
  if (v == 0) {
    sum_es[2 * ti + 0] = same_e ? sE[0] : (int8_t)-1;
    sum_es[2 * ti + 1] = same_s ? sS[0] : (int8_t)-1;
    sum_ab[2 * ti + 0] = sA[0];
    sum_ab[2 * ti + 1] = sB[0];
    sum_t[ti] = sT[0];
    __threadfence();  // the summary is visible before the count
    is_last = atomicAdd(&counters[s], 1) == tpb - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // the voxel arrays now hold the block's tiles, thread t for tile t
  // (cross-tile levels exist only with 8^3 tiles, so tpb <= Vt threads)
  __shared__ uint8_t changed[kMaxTiles];
  const int t = v;
  const bool tile = t < tpb;
  if (tile) {
    const size_t k = (size_t)s * tpb + t;
    sE[t] = __ldcg(&sum_es[2 * k + 0]);
    sS[t] = __ldcg(&sum_es[2 * k + 1]);
    sA[t] = __ldcg(&sum_ab[2 * k + 0]);
    sB[t] = __ldcg(&sum_ab[2 * k + 1]);
    sT[t] = __ldcg(&sum_t[k]);
    changed[t] = 0;
  }
  __syncthreads();
  const int tx = t % tpa, ty = (t / tpa) % tpa, tz = t / (tpa * tpa);
  for (int L = lt + 1; L <= max_level; ++L) {
    const int m = 1 << (L - lt);  // tiles per group edge
    bool ok = false;
    float cA = 0.f, cB = 0.f;
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
            const int u = (bx + dx) + (by + dy) * tpa + (bz + dz) * tpa * tpa;
            ok = sE[u] == L - 1 && sS[u] == st;
          }
      cA = sA[c];
      cB = sB[c];
      cT = sT[c];
    }
    __syncthreads();
    if (ok) {
      sA[t] = cA;
      sB[t] = cB;
      sT[t] = cT;
      sS[t] = st;
      sE[t] = (int8_t)L;
      changed[t] = 1;
    }
    __syncthreads();
  }
  // rewrite the collapsed tiles: every voxel takes its tile's new values
  const size_t base = (size_t)slot * V;
  for (size_t k = v; k < (size_t)tpb * Vt; k += blockDim.x) {
    const int u = (int)(k / Vt);
    if (!changed[u]) continue;
    A[base + k] = sA[u];
    B[base + k] = sB[u];
    touched[base + k] = sT[u];
    eff[base + k] = sE[u];
  }
}

}  // namespace

// Launch K8 for the blocks ``slots[0..S)`` on ``stream``: S * tpb CTAs of Vt
// threads rounded up to a warp.  ``counters`` [S] must be zero.  Returns
// cudaGetLastError().
extern "C" int la3dm_lv_prune(float* A, float* B, uint8_t* touched, int8_t* eff,
                              const int32_t* slots, int8_t* sum_es, float* sum_ab,
                              uint8_t* sum_t, int32_t* counters, int S, int cap,
                              int n, int max_level, float min_W, float var_thresh,
                              float free_thresh, float occupied_thresh,
                              void* stream) {
  if (S <= 0 || n <= 0 || (n & (n - 1)) != 0) return (int)cudaErrorInvalidValue;
  const int te = n < 8 ? n : 8;
  const int Vt = te * te * te;
  const int tpa = n / te;
  const int tpb = tpa * tpa * tpa;
  const int threads = ((Vt + 31) / 32) * 32;
  if (tpb > kMaxTiles || tpb > threads || (size_t)S * tpb > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  lv_prune_kernel<<<S * tpb, threads, 0, st>>>(A, B, touched, eff, slots, sum_es, sum_ab,
                                               sum_t, counters, cap, n, max_level,
                                               min_W, var_thresh, free_thresh,
                                               occupied_thresh);
  return (int)cudaGetLastError();
}
