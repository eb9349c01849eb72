// K5 — the GP light pass (BCM fusion) with the prune, hand-written for
// Hopper (sm_90a).
//
// Replaces la3dm_tpu/models/gp.py::_gp_light (lines 128-187:
// kernels/gp.py::bcm_update_sequential, the node_idx_tab selection, the pool
// scatter and models/pruning.py::prune_blocks with posterior.GPStateFn) for
// ONE scan.  The wrapper launches it once per scan, in scan order, on the
// current stream: each scan's prune changes the eff levels the next reads.
//
// For n <= 8 a CTA holds pack = max(1, 64 / n^3) whole blocks, one thread a
// voxel (thread b*V + r: raster voxel r of its b-th block): one block of 4^3
// or 8^3 a CTA, blocks of 2^3 eight a CTA, so that a CTA holds whole warps
// for the votes; for n = 16..64 one CTA per (block, 8^3 tile), N
// raster-consecutive voxels of the tile a thread (N = 2 at G = 7, 256
// threads: more tiles on an SM and the 64-voxel groups within a warp; N = 1
// at G = 27, whose slots' values would not fit twice; tile_voxel, the pool
// is not permuted).
// * The fold: a warp reads its block's G `present` flags as one ballot (a
//   bit a slot).  The thread loads eff and the pool row's four values, then
//   the node index of the voxel's eff level, then the (mean, var) pairs of
//   every present slot at that node at once (predicated on the mask, which
//   is known before them: no load waits on another), and folds them in
//   slot order: var == 0 -> 1 (the JAX package's padded-row guard),
//   ivar = (ivar + 1/var) - sf2, m_ivar = m_ivar + m/var, and the
//   persistent chop ivar >= min_known_ivar => ivar = min(ivar, max_ivar).
//   touched |= any slot present.
// * The prune: the GP state p = 1/(1 + expf((-l*m_ivar)/max_ivar)), the
//   p-thresholds, UNKNOWN below min_known_ivar and where untouched (the f32
//   rules of la3dm_tpu/models/posterior.py:77-88); the voxels pass through
//   shared memory into Morton order and csrc/group_prune.cuh votes each
//   level's collapse.  Levels across tiles: each CTA writes its tile's
//   summary, fences and counts itself in on its block's counter; the
//   block's last CTA runs those levels over the block's tiles and rewrites
//   the tiles that collapsed.
//
// What bounds it: memory.  Per block it reads the present slots' (mean,
// var) at each voxel's eff-level node (V * 8 bytes a present slot) and reads
// and writes the pool row (m_ivar, ivar: 4 bytes each; touched, eff: 1 byte
// each), each byte once; the prune stays in shared memory (and 11 bytes of
// summary a tile).
// Built with --fmad=false and full-precision division and expf: every
// expression rounds as the plain version's separate ops.  A slot equal to
// the pool capacity is padding: its voxels are left alone.

#include <cuda_runtime.h>
#include <stdint.h>

#include "group_prune.cuh"

namespace {

using la3dm::tile_voxel;
using la3dm::vote::Cubes;
using la3dm::vote::Item;
using la3dm::vote::Votes;
using la3dm::vote::kFull;

constexpr int8_t kFree = 0, kOccupied = 1, kUnknown = 2;
constexpr int kTileEdge = 8, kTileV = 512, kTileLevels = 3, kMaxThreads = 512;

struct GPParams {
  float sf2, min_known_ivar, max_ivar, l, free_thresh, occupied_thresh;
};

__device__ __forceinline__ int8_t gp_state(float mi, float iv, bool touched,
                                           const GPParams& q) {
  const float p = 1.0f / (1.0f + expf((-q.l * mi) / q.max_ivar));
  int8_t st = p > q.occupied_thresh ? kOccupied : (p < q.free_thresh ? kFree : kUnknown);
  if (iv < q.min_known_ivar) st = kUnknown;
  return touched ? st : kUnknown;
}

// The present slots of block t as a G-bit mask (G <= 32).  Where a warp
// holds one block (V >= 32), one ballot: every lane of the warp calls this.
template <int G>
__device__ __forceinline__ unsigned present_mask(const uint8_t* __restrict__ present,
                                                 int t, int V) {
  const uint8_t* row = present + (size_t)t * G;
  if (V >= 32) {
    const int lane = threadIdx.x & 31;
    return __ballot_sync(kFull, lane < G && row[lane < G ? lane : 0] != 0);
  }
  unsigned mask = 0u;
#pragma unroll
  for (int g = 0; g < G; ++g) mask |= (row[g] != 0 ? 1u : 0u) << g;
  return mask;
}

// The sequential BCM of the thread's N pool voxels p[j] (raster voxels v[j]
// of block t's row) over the present slots `mask`, as prune items.  Every
// load of the N voxels is issued before any fold.
template <int G, int N>
__device__ __forceinline__ void bcm_voxels(const float* __restrict__ acc_mean,
                                           const float* __restrict__ acc_var,
                                           unsigned mask,
                                           const int32_t* __restrict__ node_idx_tab,
                                           const float* m_ivar, const float* ivar,
                                           const uint8_t* touched, const int8_t* eff, int t,
                                           const size_t (&p)[N], const int (&v)[N], int V,
                                           int Vall, const GPParams& q, Item (&it)[N]) {
  int e[N];
  float mi[N], iv[N];
  uint8_t T[N];
  size_t row[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    e[j] = eff[p[j]];
    mi[j] = m_ivar[p[j]];
    iv[j] = ivar[p[j]];
    T[j] = touched[p[j]];
  }
#pragma unroll
  for (int j = 0; j < N; ++j) row[j] = (size_t)t * G * Vall + node_idx_tab[e[j] * V + v[j]];
  float m[N][G], var[N][G];
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int g = 0; g < G; ++g) {  // the present slots' loads, all issued first
      const bool on = (mask >> g) & 1u;
      m[j][g] = on ? acc_mean[row[j] + (size_t)g * Vall] : 0.0f;
      var[j][g] = on ? acc_var[row[j] + (size_t)g * Vall] : 1.0f;
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (!((mask >> g) & 1u)) continue;
      const float vg = var[j][g] == 0.0f ? 1.0f : var[j][g];
      float iv_new = iv[j] + 1.0f / vg;
      iv_new = iv_new - q.sf2;
      const float mi_new = mi[j] + m[j][g] / vg;
      if (iv_new >= q.min_known_ivar) iv_new = iv_new > q.max_ivar ? q.max_ivar : iv_new;
      mi[j] = mi_new;
      iv[j] = iv_new;
    }
    const uint8_t Tn = (T[j] != 0 || mask != 0u) ? 1 : 0;
    it[j] = Item{mi[j], iv[j], (int8_t)e[j], gp_state(mi[j], iv[j], Tn != 0, q), Tn};
  }
}

// n <= 8: `pack` blocks a CTA, one thread per voxel.
// At G = 7 three 512-thread CTAs an SM (at most 42 registers).
template <int G>
__global__ void __launch_bounds__(kMaxThreads, G <= 7 ? 3 : 1)
    gp_light_kernel(const float* __restrict__ acc_mean,    // [Tp*G,Vall]
                    const float* __restrict__ acc_var,     // [Tp*G,Vall]
                    const uint8_t* __restrict__ present,   // [Tp*G]
                    const int32_t* __restrict__ slots,     // [Tp]
                    const int32_t* __restrict__ node_idx_tab,  // [depth,V]
                    float* __restrict__ m_ivar,            // [cap,V]
                    float* __restrict__ ivar,              // [cap,V]
                    uint8_t* __restrict__ touched,         // [cap,V]
                    int8_t* __restrict__ eff,              // [cap,V]
                    int start, int count, int cap, int n, int pack, int Vall,
                    int max_level, GPParams q) {
  __shared__ Cubes cubes;
  __shared__ Votes votes;

  const int V = n * n * n;
  const int b = blockIdx.x * pack + threadIdx.x / V;
  const int v = threadIdx.x % V;
  const int t = start + (b < count ? b : 0);
  const int slot = b < count ? slots[t] : -1;
  const bool live = slot >= 0 && slot < cap;  // else padding, or past the scan
  const size_t p = (size_t)(live ? slot : 0) * V + v;
  const unsigned mask = present_mask<G>(present, t, V);

  Item it[1] = {la3dm::vote::no_item()};
  if (live) {
    const size_t pp[1] = {p};
    const int vv[1] = {v};
    bcm_voxels<G, 1>(acc_mean, acc_var, mask, node_idx_tab, m_ivar, ivar, touched, eff, t,
                     pp, vv, V, Vall, q, it);
  }
  if (max_level > 0) la3dm::vote::prune_cubes<1>(it, n, max_level, cubes, votes);
  if (!live) return;
  m_ivar[p] = it[0].f0;
  ivar[p] = it[0].f1;
  touched[p] = it[0].touched;
  eff[p] = it[0].eff;
}

// n = 16..64: one CTA per (block, 8^3 tile), N raster-consecutive tile
// voxels a thread (kTileV / N threads).
// At G = 7 four 256-thread CTAs an SM (at most 64 registers).
template <int G, int N>
__global__ void __launch_bounds__(kTileV / N, G <= 7 ? 4 : 1)
    gp_light_tiled_kernel(const float* __restrict__ acc_mean,
                          const float* __restrict__ acc_var,
                          const uint8_t* __restrict__ present,
                          const int32_t* __restrict__ slots,
                          const int32_t* __restrict__ node_idx_tab,
                          float* __restrict__ m_ivar, float* __restrict__ ivar,
                          uint8_t* __restrict__ touched, int8_t* __restrict__ eff,
                          int start, int cap, int n, int Vall, int max_level, GPParams q,
                          int8_t* __restrict__ sum_es,   // [count*tpb,2]
                          float* __restrict__ sum_f,     // [count*tpb,2]
                          uint8_t* __restrict__ sum_t,   // [count*tpb]
                          int32_t* __restrict__ counters) {  // [count], zero
  __shared__ Cubes cubes;
  __shared__ Votes votes;
  __shared__ int16_t changed[kMaxThreads];

  const int tpa = n / kTileEdge;
  const int tpb = tpa * tpa * tpa;
  const int b = blockIdx.x / tpb;
  const int pos = blockIdx.x % tpb;
  const int V = n * n * n;
  const int t = start + b;
  const int slot = slots[t];
  if (slot < 0 || slot >= cap) return;  // padding: every tile of the block
  const int i = threadIdx.x;
  const size_t base = (size_t)slot * V;
  size_t p[N];
  int v[N];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    v[j] = tile_voxel(pos, N * i + j, n);
    p[j] = base + v[j];
  }
  const unsigned mask = present_mask<G>(present, t, V);

  Item it[N];
  bcm_voxels<G, N>(acc_mean, acc_var, mask, node_idx_tab, m_ivar, ivar, touched, eff, t, p,
                   v, V, Vall, q, it);
  if (max_level > 0)
    la3dm::vote::prune_cubes<N>(it, kTileEdge,
                                max_level < kTileLevels ? max_level : kTileLevels, cubes,
                                votes);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    m_ivar[p[j]] = it[j].f0;
    ivar[p[j]] = it[j].f1;
    touched[p[j]] = it[j].touched;
    eff[p[j]] = it[j].eff;
  }
  if (max_level <= kTileLevels) return;  // no level spans tiles

  // this tile's summary, then the block's last CTA (the tile is written
  // before it counts in: the last CTA may rewrite it)
  const Item s = i < 32 ? la3dm::vote::tile_summary(cubes, votes) : it[0];
  const size_t tile0 = (size_t)b * tpb;
  if (!la3dm::vote::count_in(s, tile0 + pos, sum_es, sum_f, sum_t, &counters[b], tpb))
    return;
  const int collapsed = la3dm::vote::cross_tile_levels<N>(sum_es, sum_f, sum_t, tile0, tpa,
                                                          max_level, cubes, changed, votes);
  // rewrite the collapsed tiles: every voxel takes its tile's new values
  for (int k = 0; k < collapsed; ++k) {
    const int w = changed[k];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const size_t o = base + tile_voxel(w, N * i + j, n);
      m_ivar[o] = cubes.f0[w];
      ivar[o] = cubes.f1[w];
      touched[o] = cubes.T[w];
      eff[o] = cubes.E[w];
    }
  }
}

template <int G>
int launch(const float* acc_mean, const float* acc_var, const uint8_t* present,
           const int32_t* slots, const int32_t* node_idx_tab, float* m_ivar, float* ivar,
           uint8_t* touched, int8_t* eff, int start, int count, int cap, int n, int Vall,
           int max_level, const GPParams& q, int8_t* sum_es, float* sum_f, uint8_t* sum_t,
           int32_t* counters, cudaStream_t s) {
  if (n <= kTileEdge) {
    const int V = n * n * n;
    const int pack = V >= 64 ? 1 : 64 / V;
    gp_light_kernel<G><<<(count + pack - 1) / pack, pack * V, 0, s>>>(
        acc_mean, acc_var, present, slots, node_idx_tab, m_ivar, ivar, touched, eff, start,
        count, cap, n, pack, Vall, max_level, q);
  } else {
    if (sum_es == nullptr || sum_f == nullptr || sum_t == nullptr || counters == nullptr)
      return (int)cudaErrorInvalidValue;
    // two voxels a thread where the slots' values fit in registers twice
    constexpr int N = G <= 7 ? 2 : 1;
    const int tpa = n / kTileEdge;
    gp_light_tiled_kernel<G, N><<<count * tpa * tpa * tpa, kTileV / N, 0, s>>>(
        acc_mean, acc_var, present, slots, node_idx_tab, m_ivar, ivar, touched, eff, start,
        cap, n, Vall, max_level, q, sum_es, sum_f, sum_t, counters);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Launch K5 for one scan on ``stream`` over the scan's blocks
// [start, start + count): for n <= 8, max(1, 64 / n^3) blocks a CTA;
// above, one CTA per 8^3 tile, with the summaries sum_es [count*tpb, 2],
// sum_f [count*tpb, 2], sum_t [count*tpb] and the block counters [count],
// which must be zero and which the launch leaves zero.  G (slots a block)
// is 7 or 27.  Returns cudaGetLastError().
extern "C" int la3dm_gp_light(const float* acc_mean, const float* acc_var,
                              const uint8_t* present, const int32_t* slots,
                              const int32_t* node_idx_tab, float* m_ivar, float* ivar,
                              uint8_t* touched, int8_t* eff, int start, int count,
                              int cap, int n, int Vall, int G, int max_level,
                              float sf2, float min_known_ivar, float max_ivar, float l,
                              float free_thresh, float occupied_thresh, int8_t* sum_es,
                              float* sum_f, uint8_t* sum_t, int32_t* counters,
                              void* stream) {
  if (count <= 0 || n <= 0 || n > 64 || (n & (n - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const GPParams q{sf2, min_known_ivar, max_ivar, l, free_thresh, occupied_thresh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G == 7)
    return launch<7>(acc_mean, acc_var, present, slots, node_idx_tab, m_ivar, ivar, touched,
                     eff, start, count, cap, n, Vall, max_level, q, sum_es, sum_f,
                     sum_t, counters, s);
  if (G == 27)
    return launch<27>(acc_mean, acc_var, present, slots, node_idx_tab, m_ivar, ivar,
                      touched, eff, start, count, cap, n, Vall, max_level, q, sum_es,
                      sum_f, sum_t, counters, s);
  return (int)cudaErrorInvalidValue;
}
