// K2 — the BGK light pass with the prune, hand-written for Hopper (sm_90a).
//
// Replaces the light half of la3dm_tpu/models/bgk.py::_bgk_seq_step
// (lines 140-177: kernels/predict.py::beta_update, the node_idx_tab
// selection, the pool scatter and models/pruning.py::prune_blocks with
// posterior.BetaStateFn), for ONE scan.  The wrapper launches it once per
// scan, in scan order, on the current stream: scans are sequential because
// each scan's prune changes the eff levels the next scan reads.
//
// For n <= 8 a CTA holds pack = max(1, 64 / n^3) whole blocks, one thread a
// voxel (thread b*V + r: raster voxel r of its b-th block): one block of 4^3
// or 8^3 a CTA, blocks of 2^3 eight a CTA, so that a CTA holds whole warps
// for the votes; for n = 16..64 one CTA per (block, 8^3 tile), N
// raster-consecutive voxels of the tile a thread (N = 2 at G = 7, 256
// threads; N = 1 at G = 27, whose accumulator rows would not fit twice;
// tile_voxel, the pool is not permuted).  K5 (csrc/gp_light.cu) has the
// same shape with the BCM fold in place of the Beta fold.
// * The fold: the thread loads eff and the pool row's A, B and touched
//   together, then the node index of the voxel's eff level; then its warp
//   loads the nodes' rows of 2G accumulator values (G float2 each: a row is
//   8-byte aligned) through shared memory, each warp load reading the rows
//   laid end to end (load_rows: the accumulator is [T, Vall, 2G], so one
//   row a lane would touch a 128-byte line a lane); the thread folds its
//   row in slot order: where kbar_g > gate, dA = dA + ybar_g and dB = dB +
//   (kbar_g - ybar_g), touched |= 1; then A += dA, B += dB (the plain
//   version sums the same way, so the two agree bit for bit on identical
//   inputs).
// * The prune: the Beta state (the f32 rules of
//   la3dm_tpu/models/posterior.py:29-51, built without FMA contraction); the
//   voxels pass through shared memory into Morton order and
//   csrc/group_prune.cuh votes each level's collapse.  Levels across tiles:
//   each CTA writes its tile's summary, fences and counts itself in on its
//   block's counter; the block's last CTA runs those levels over the
//   block's tiles and rewrites the tiles that collapsed.
//
// What bounds it: memory.  Per block it reads V * 2G floats of the
// accumulator (only each voxel's eff-level node) and reads and writes the
// pool row (A, B: 4 bytes each; touched, eff: 1 byte each), each byte once;
// the prune stays in shared memory (and 11 bytes of summary a tile).  A
// slot equal to the pool capacity is padding: its voxels are left alone.

#include <cuda_runtime.h>
#include <stdint.h>

#include "group_prune.cuh"

namespace {

using la3dm::tile_voxel;
using la3dm::vote::Cubes;
using la3dm::vote::Item;
using la3dm::vote::Votes;

constexpr int8_t kFree = 0, kOccupied = 1, kUnknown = 2;
constexpr int kTileEdge = 8, kTileV = 512, kTileLevels = 3, kMaxThreads = 512;

struct BetaParams {
  float gate, var_thresh, free_thresh, occupied_thresh;
};

__device__ __forceinline__ int8_t beta_state(float A, float B, bool touched,
                                             const BetaParams& q) {
  const float prob = A / (A + B);
  const float s = A + B;
  const float var = (A * B) / (s * s * (s + 1.0f));
  int8_t st = prob > q.occupied_thresh ? kOccupied
              : (prob < q.free_thresh ? kFree : kUnknown);
  if (var > q.var_thresh) st = kUnknown;
  return touched ? st : kUnknown;
}

// float2 of a voxel's accumulator row that a warp stages a round
constexpr int kPart = 7;

// The accumulator rows row[j] (float2 offsets, 2G floats = G float2 each)
// of the warp's 32 N voxels into r, through the warp's staging buffer
// `buf` (32 N kPart float2 of shared memory): in each round of up to kPart
// float2 a row, lane l of load k takes float2 k*32 + l of the rows laid end
// to end (voxel by voxel in the warp's raster order), so that where the
// rows are consecutive nodes (eff 0: raster voxels, consecutive within
// runs of 8 or more) a warp load reads 256 contiguous bytes, where one
// float2 a lane 56 bytes apart touched 14 lines.  Every lane of the warp
// calls this.
template <int G, int N>
__device__ __forceinline__ void load_rows(const float2* __restrict__ acc2,
                                          const unsigned long long (&row)[N],
                                          float2 (&r)[N][G],
                                          float2* buf) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r0 = 0; r0 < G; r0 += kPart) {
    constexpr int kRounds = (G + kPart - 1) / kPart;
    const int P = G - r0 < kPart ? G - r0 : kPart;  // float2 a row this round
#pragma unroll
    for (int k = 0; k < N * kPart; ++k) {
      if (k >= N * P) break;
      const int i = k * 32 + lane;
      const int vox = i / P, part = i - vox * P;  // the warp's voxel vox: lane vox / N
      unsigned long long base = __shfl_sync(la3dm::vote::kFull, row[0], vox / N);
      if (N == 2) {
        const unsigned long long b1 = __shfl_sync(la3dm::vote::kFull, row[N - 1], vox / N);
        base = (vox & 1) ? b1 : base;
      }
      buf[i] = __ldg(acc2 + base + r0 + part);
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < N; ++j) {
#pragma unroll
      for (int q = 0; q < kPart; ++q)
        if (q < P) r[j][r0 + q] = buf[(lane * N + j) * P + q];
    }
    if (kRounds > 1) __syncwarp();  // the buffer is refilled
  }
}

// The Beta update of the thread's N pool voxels p[j] (raster voxels v[j] of
// block t's row), as prune items: the pool row's loads, then the node
// indices, then the nodes' accumulator rows (load_rows), then the fold.
// Every lane of the warp calls this (a lane without a voxel on a valid row:
// its items are discarded).
template <int G, int N>
__device__ __forceinline__ void beta_voxels(const float* __restrict__ acc,
                                            const int32_t* __restrict__ node_idx_tab,
                                            const float* A, const float* B,
                                            const uint8_t* touched, const int8_t* eff, int t,
                                            const size_t (&p)[N], const int (&v)[N], int V,
                                            int Vall, const BetaParams& q, float2* buf,
                                            Item (&it)[N]) {
  int e[N];
  float a0[N], b0[N];
  uint8_t T[N];
  if constexpr (N == 2) {  // p[1] = p[0] + 1, p[0] even: one load a field
    const float2 a2 = *reinterpret_cast<const float2*>(A + p[0]);
    const float2 b2 = *reinterpret_cast<const float2*>(B + p[0]);
    const uchar2 t2 = *reinterpret_cast<const uchar2*>(touched + p[0]);
    const char2 e2 = *reinterpret_cast<const char2*>(eff + p[0]);
    e[0] = e2.x, e[1] = e2.y, a0[0] = a2.x, a0[1] = a2.y, b0[0] = b2.x, b0[1] = b2.y;
    T[0] = t2.x, T[1] = t2.y;
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      e[j] = eff[p[j]];
      a0[j] = A[p[j]];
      b0[j] = B[p[j]];
      T[j] = touched[p[j]];
    }
  }
  unsigned long long row[N];  // float2 offset of each voxel's node row
#pragma unroll
  for (int j = 0; j < N; ++j)
    row[j] = ((unsigned long long)t * Vall + node_idx_tab[e[j] * V + v[j]]) * G;
  float2 r[N][G];  // the node's (ybar_0 .. ybar_G-1, kbar_0 .. kbar_G-1), pairwise
  load_rows<G, N>(reinterpret_cast<const float2*>(acc), row, r, buf);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float dA = 0.0f, dB = 0.0f;
    bool any = false;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float yb = (g & 1) ? r[j][g >> 1].y : r[j][g >> 1].x;
      const float kb = ((G + g) & 1) ? r[j][(G + g) >> 1].y : r[j][(G + g) >> 1].x;
      if (kb > q.gate) {
        dA = dA + yb;
        dB = dB + (kb - yb);
        any = true;
      }
    }
    const float An = a0[j] + dA, Bn = b0[j] + dB;
    const uint8_t Tn = (T[j] != 0 || any) ? 1 : 0;
    it[j] = Item{An, Bn, (int8_t)e[j], beta_state(An, Bn, Tn != 0, q), Tn};
  }
}

// the staging buffer of the thread's warp in the dynamic shared memory
template <int N>
__device__ __forceinline__ float2* warp_buffer() {
  extern __shared__ float2 stage[];
  return stage + (threadIdx.x >> 5) * (32 * N * kPart);
}

// n <= 8: `pack` blocks a CTA, one thread per voxel.
// At G = 7 three 512-thread CTAs an SM (at most 42 registers).
template <int G>
__global__ void __launch_bounds__(kMaxThreads, G <= 7 ? 3 : 1)
    bgk_light_kernel(const float* __restrict__ acc,             // [Tp,Vall,2G]
                     const int32_t* __restrict__ slots,         // [Tp]
                     const int32_t* __restrict__ node_idx_tab,  // [depth,V]
                     float* __restrict__ A,                     // [cap,V]
                     float* __restrict__ B,                     // [cap,V]
                     uint8_t* __restrict__ touched,             // [cap,V]
                     int8_t* __restrict__ eff,                  // [cap,V]
                     int start, int count, int cap, int n, int pack, int Vall,
                     int max_level, BetaParams q) {
  __shared__ Cubes cubes;
  __shared__ Votes votes;

  const int V = n * n * n;
  const int b = blockIdx.x * pack + threadIdx.x / V;
  const int v = threadIdx.x % V;
  const int t = start + (b < count ? b : 0);
  const int slot = b < count ? slots[t] : -1;
  const bool live = slot >= 0 && slot < cap;  // else padding, or past the scan
  const size_t p = (size_t)(live ? slot : 0) * V + v;

  Item it[1];
  const size_t pp[1] = {p};
  const int vv[1] = {v};
  beta_voxels<G, 1>(acc, node_idx_tab, A, B, touched, eff, t, pp, vv, V, Vall, q,
                    warp_buffer<1>(), it);
  if (!live) it[0] = la3dm::vote::no_item();
  if (max_level > 0) la3dm::vote::prune_cubes<1>(it, n, max_level, cubes, votes);
  if (!live) return;
  A[p] = it[0].f0;
  B[p] = it[0].f1;
  touched[p] = it[0].touched;
  eff[p] = it[0].eff;
}

// n = 16..64: one CTA per (block, 8^3 tile), N raster-consecutive tile
// voxels a thread (kTileV / N threads; with N = 2 the thread's pool values
// are 2-vectors: its first voxel's x is even).
// At G = 7 four 256-thread CTAs an SM (at most 64 registers).
template <int G, int N>
__global__ void __launch_bounds__(kTileV / N, G <= 7 ? 4 : 1)
    bgk_light_tiled_kernel(const float* __restrict__ acc,
                           const int32_t* __restrict__ slots,
                           const int32_t* __restrict__ node_idx_tab,
                           float* __restrict__ A, float* __restrict__ B,
                           uint8_t* __restrict__ touched, int8_t* __restrict__ eff,
                           int start, int cap, int n, int Vall, int max_level, BetaParams q,
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

  Item it[N];
  beta_voxels<G, N>(acc, node_idx_tab, A, B, touched, eff, t, p, v, V, Vall, q,
                    warp_buffer<N>(), it);
  if (max_level > 0)
    la3dm::vote::prune_cubes<N>(it, kTileEdge,
                                max_level < kTileLevels ? max_level : kTileLevels, cubes,
                                votes);
  if constexpr (N == 2) {
    *reinterpret_cast<float2*>(A + p[0]) = make_float2(it[0].f0, it[1].f0);
    *reinterpret_cast<float2*>(B + p[0]) = make_float2(it[0].f1, it[1].f1);
    *reinterpret_cast<uchar2*>(touched + p[0]) = make_uchar2(it[0].touched, it[1].touched);
    *reinterpret_cast<char2*>(eff + p[0]) = make_char2(it[0].eff, it[1].eff);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      A[p[j]] = it[j].f0;
      B[p[j]] = it[j].f1;
      touched[p[j]] = it[j].touched;
      eff[p[j]] = it[j].eff;
    }
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
      A[o] = cubes.f0[w];
      B[o] = cubes.f1[w];
      touched[o] = cubes.T[w];
      eff[o] = cubes.E[w];
    }
  }
}

template <int G>
int launch(const float* acc, const int32_t* slots, const int32_t* node_idx_tab, float* A,
           float* B, uint8_t* touched, int8_t* eff, int start, int count, int cap, int n,
           int Vall, int max_level, const BetaParams& q, int8_t* sum_es, float* sum_f,
           uint8_t* sum_t, int32_t* counters, cudaStream_t s) {
  if (n <= kTileEdge) {
    const int V = n * n * n;
    const int pack = V >= 64 ? 1 : 64 / V;
    const size_t smem = (size_t)(pack * V / 32) * 32 * kPart * sizeof(float2);
    bgk_light_kernel<G><<<(count + pack - 1) / pack, pack * V, smem, s>>>(
        acc, slots, node_idx_tab, A, B, touched, eff, start, count, cap, n, pack, Vall,
        max_level, q);
  } else {
    if (sum_es == nullptr || sum_f == nullptr || sum_t == nullptr || counters == nullptr)
      return (int)cudaErrorInvalidValue;
    // two voxels a thread where the accumulator rows fit in registers twice
    constexpr int N = G <= 7 ? 2 : 1;
    const int tpa = n / kTileEdge;
    const size_t smem = (size_t)(kTileV / N / 32) * 32 * N * kPart * sizeof(float2);
    bgk_light_tiled_kernel<G, N><<<count * tpa * tpa * tpa, kTileV / N, smem, s>>>(
        acc, slots, node_idx_tab, A, B, touched, eff, start, cap, n, Vall, max_level, q,
        sum_es, sum_f, sum_t, counters);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Launch K2 for one scan on ``stream`` over the scan's blocks
// [start, start + count): for n <= 8, max(1, 64 / n^3) blocks a CTA;
// above, one CTA per 8^3 tile, with the summaries sum_es [count*tpb, 2],
// sum_f [count*tpb, 2], sum_t [count*tpb] and the block counters [count],
// which must be zero and which the launch leaves zero.  G (slots a block)
// is 7 or 27.  Returns cudaGetLastError().
extern "C" int la3dm_bgk_light(const float* acc, const int32_t* slots,
                               const int32_t* node_idx_tab, float* A, float* B,
                               uint8_t* touched, int8_t* eff, int start, int count,
                               int cap, int n, int Vall, int G, float gate,
                               int max_level, float var_thresh, float free_thresh,
                               float occupied_thresh, int8_t* sum_es, float* sum_f,
                               uint8_t* sum_t, int32_t* counters, void* stream) {
  if (count <= 0 || n <= 0 || n > 64 || (n & (n - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const BetaParams q{gate, var_thresh, free_thresh, occupied_thresh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G == 7)
    return launch<7>(acc, slots, node_idx_tab, A, B, touched, eff, start, count, cap, n, Vall,
                     max_level, q, sum_es, sum_f, sum_t, counters, s);
  if (G == 27)
    return launch<27>(acc, slots, node_idx_tab, A, B, touched, eff, start, count, cap, n,
                      Vall, max_level, q, sum_es, sum_f, sum_t, counters, s);
  return (int)cudaErrorInvalidValue;
}
