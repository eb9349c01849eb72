// K1 — the BGK heavy pass, hand-written for Hopper (sm_90a), for point
// entries (BGK) and segment entries (BGKL).
//
// Replaces the heavy half of la3dm_tpu/models/bgk.py::_bgk_seq_step
// (lines 106-138: a chunked lax.scan of cov_sparse, or of
// cov_sparse_segment(lv=False) for segments (lines 121-122), times
// _slot_rhs, scattered into acc[Tp, Vall, 2G] at row_block).
//
// For each test block t and each of its rows of <= 64 merged neighbour
// entries, the sparse kernel k(node, entry) between the block's all-level
// node centres (all_nodes + centre[t]) and the row's entries is accumulated
// per neighbour slot g of the entry:  ybar[g] += k * y,  kbar[g] += k.
// row_block is non-decreasing, so block t's rows are the contiguous range
// [block_rows[t], block_rows[t+1]) (torch.searchsorted in the wrapper).
// Each (block, node) output has one writer: no atomics, deterministic.
// Each row is summed on its own and then added in, as the plain version
// adds its per-row products.
//
// Points (bgk_heavy_kernel): one CTA per test block, one thread per node
// (at most 256, looping over node chunks beyond that).  Each row's entries
// (pre-divided by ell), labels and slot ids are staged in shared memory and
// read by every node thread; the 2G sums live in registers (G is a
// template parameter) and are written once.
//
// Segments (bgk_heavy_seg_kernel):
// * One warp per (test block, 32 nodes) work unit, four units a CTA, all
//   in parallel: Tp * ceil(Vall / 32) warps (the BGKL large map: 147 a
//   block).  Lane i owns node node_order[32 * w + i]; the wrapper orders
//   the nodes along a Morton curve so that a warp's nodes are compact.
// * Each lane loads one or two of the row's entries and their terms
//   (u, u.u, |u|; segment_dist.cuh).  Exact culling (cull.cuh): where the
//   segment misses the warp's node box padded by r_c * ell, every node lies
//   farther than r_c * ell from it, and sparse_kernel_r returns exactly 0
//   for every f32 r >= r_c (r_c = 1: a scan of every f32 value in [1, 2)
//   on the card, kernels/bgk_heavy.py::R_CULL; above 2 the formula is
//   negative); the warp skips the entry.
// * Slot sums without G-way selects: the surviving entries of one slot are
//   taken together, in row order, into one running sum, then added to the
//   slot's block sum: the plain version's per-slot order, bit for bit.  The
//   block sums sit in shared memory, a row of 2G + 1 floats a lane (no bank
//   conflicts), and are written out node by node, coalesced.
// * Warps share nothing: no barrier.
//
// What bounds both: FP32 arithmetic on the CUDA cores — about 50
// operations per point evaluation and 85 per segment evaluation, sinf/cosf
// included, counted for every evaluation of the plain version.  Tensor
// cores are out: the distances feed a clamp whose sign is decided in the
// last ulp (the k-bar > 0 update gate), so parity rules out TF32 and a Gram
// expansion.  Built with --fmad=false and without fast-math: every
// expression rounds as the plain PyTorch version's separate ops round.
//
// Parity with la3dm_tpu/kernels/math.py: per-axis direct subtraction,
// d2 = ((dx*dx) + dy*dy) + dz*dz, both operands divided by ell (no
// reciprocal), node + centre added before the division, and
// TWO_PI = float32(2 * 3.1415926) (sparse_kernel.cuh).  Segments: the
// distance of segment_dist.cuh between the node (node + centre) and the
// segment, then r = d / ell (a division) into the kernel clamped at 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cull.cuh"
#include "segment_dist.cuh"
#include "sparse_kernel.cuh"

namespace {

constexpr int kW = 64;                      // entry-row width (_ROW_W)
constexpr int kWarps = 4;                   // segment work units (warps) per CTA
constexpr unsigned kAll = 0xffffffffu;

template <int G>
__global__ void bgk_heavy_kernel(const float* __restrict__ entries,   // [N,3]
                                 const float* __restrict__ labels,    // [N]
                                 const int32_t* __restrict__ ids,     // [F]
                                 const int8_t* __restrict__ gslot,    // [F]
                                 const int32_t* __restrict__ row_start,  // [R]
                                 const int32_t* __restrict__ row_count,  // [R]
                                 const int64_t* __restrict__ block_rows, // [Tp+1]
                                 const float* __restrict__ centers,   // [Tp,3]
                                 const float* __restrict__ all_nodes, // [Vall,3]
                                 int Vall, float sf2, float ell,
                                 float* __restrict__ acc) {           // [Tp,Vall,2G]
  __shared__ float sa[3][kW], sl[kW];
  __shared__ int sg[kW];

  const int t = blockIdx.x;
  const int64_t r0 = block_rows[t];
  const int64_t r1 = block_rows[t + 1];
  const float cx = centers[3 * t + 0];
  const float cy = centers[3 * t + 1];
  const float cz = centers[3 * t + 2];

  for (int v0 = 0; v0 < Vall; v0 += blockDim.x) {
    const int v = v0 + threadIdx.x;
    const bool live = v < Vall;
    float xv = 0.f, yv = 0.f, zv = 0.f;
    if (live) {
      xv = (all_nodes[3 * v + 0] + cx) / ell;
      yv = (all_nodes[3 * v + 1] + cy) / ell;
      zv = (all_nodes[3 * v + 2] + cz) / ell;
    }
    float yb[G], kb[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      yb[g] = 0.f;
      kb[g] = 0.f;
    }

    for (int64_t r = r0; r < r1; ++r) {
      const int st = row_start[r];
      const int cnt = min(row_count[r], kW);
      __syncthreads();  // the previous row's entries are consumed
      for (int w = threadIdx.x; w < cnt; w += blockDim.x) {
        const int id = ids[st + w];
        const float* e = entries + (size_t)3 * id;
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) sa[ax][w] = e[ax] / ell;
        sl[w] = labels[id];
        sg[w] = gslot[st + w];
      }
      __syncthreads();
      if (!live) continue;
      // the row's own sums first, then added to the block's: the same two
      // levels as the plain version's per-row product and scatter-add
      float ry[G], rk[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        ry[g] = 0.f;
        rk[g] = 0.f;
      }
      for (int w = 0; w < cnt; ++w) {
        const float k =
            sparse_kernel_d2(dist2(xv - sa[0][w], yv - sa[1][w], zv - sa[2][w]), sf2);
        const float ky = k * sl[w];
        const int gw = sg[w];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (g == gw) {
            ry[g] += ky;
            rk[g] += k;
          }
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        yb[g] += ry[g];
        kb[g] += rk[g];
      }
    }

    if (live) {
      float* out = acc + ((size_t)t * Vall + v) * (2 * G);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        out[g] = yb[g];
        out[G + g] = kb[g];
      }
    }
  }
}

__device__ __forceinline__ Seg load_seg(const float* __restrict__ entries,
                                        const float* __restrict__ labels, int id) {
  return seg_load(entries + (size_t)6 * id, labels[id]);
}

// The entries of ``sel`` (lanes holding ``mine``), in lane order, into the
// running slot sums ry, rk.
__device__ __forceinline__ void sum_slot(unsigned sel, const Seg& mine, float xv, float yv,
                                         float zv, float sf2, float ell, float& ry,
                                         float& rk) {
  while (sel) {
    const int src = __ffs(sel) - 1;
    sel &= sel - 1;
    const Seg s = seg_shfl(mine, src);
    const float k = sparse_kernel_r(seg_dist(xv, yv, zv, s) / ell, sf2);
    const float ky = k * s.lab;
    ry += ky;
    rk += k;
  }
}

template <int G>
__global__ void __launch_bounds__(32 * kWarps)
bgk_heavy_seg_kernel(const float* __restrict__ entries,      // [N,6]
                     const float* __restrict__ labels,       // [N]
                     const int32_t* __restrict__ ids,        // [F]
                     const int8_t* __restrict__ gslot,       // [F]
                     const int32_t* __restrict__ row_start,  // [R]
                     const int32_t* __restrict__ row_count,  // [R]
                     const int64_t* __restrict__ block_rows, // [Tp+1]
                     const float* __restrict__ centers,      // [Tp,3]
                     const float* __restrict__ all_nodes,    // [Vall,3]
                     const int32_t* __restrict__ node_order, // [Vall]
                     unsigned long long* __restrict__ culled,  // [1] or null
                     int64_t n_units, int Vall, float sf2, float ell, float reach,
                     float* __restrict__ acc) {               // [Tp,Vall,2G]
  constexpr int S = 2 * G + 1;  // a lane's row of block sums, padded
  __shared__ float s_acc[kWarps][32 * S];

  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int64_t unit = (int64_t)blockIdx.x * kWarps + wib;
  if (unit >= n_units) return;  // uniform over the warp
  const int wpb = (Vall + 31) / 32;
  const int64_t t = unit / wpb;
  const int i0 = (int)(unit % wpb) * 32;
  const bool live = i0 + lane < Vall;
  const int node = live ? node_order[i0 + lane] : 0;
  const float xv = all_nodes[3 * node + 0] + centers[3 * t + 0];
  const float yv = all_nodes[3 * node + 1] + centers[3 * t + 1];
  const float zv = all_nodes[3 * node + 2] + centers[3 * t + 2];
  float plo[3], phi[3];
  warp_box(live, xv, yv, zv, reach, plo, phi);

  float* mine_acc = s_acc[wib] + lane * S;
#pragma unroll
  for (int q = 0; q < 2 * G; ++q) mine_acc[q] = 0.f;

  for (int64_t r = block_rows[t]; r < block_rows[t + 1]; ++r) {
    const int st = row_start[r];
    const int cnt = min(row_count[r], kW);
    // lane i holds entries i and 32 + i of the row
    Seg e0{}, e1{};
    int g0 = -1, g1 = -1;
    bool k0 = false, k1 = false;
    if (lane < cnt) {
      e0 = load_seg(entries, labels, ids[st + lane]);
      g0 = gslot[st + lane];
      k0 = !segment_misses_box(e0.a, e0.u, plo, phi);
    }
    if (32 + lane < cnt) {
      e1 = load_seg(entries, labels, ids[st + 32 + lane]);
      g1 = gslot[st + 32 + lane];
      k1 = !segment_misses_box(e1.a, e1.u, plo, phi);
    }
    unsigned m0 = __ballot_sync(kAll, k0), m1 = __ballot_sync(kAll, k1);
    if (culled != nullptr && lane == 0)
      atomicAdd(culled, (unsigned long long)(cnt - __popc(m0) - __popc(m1)));
    while (m0 | m1) {
      // the slot of the first surviving entry, then all of that slot's
      // surviving entries in row order (lanes of the first half, then the
      // second): each slot's running sum takes its entries in row order
      const int g = m0 ? __shfl_sync(kAll, g0, __ffs(m0) - 1)
                       : __shfl_sync(kAll, g1, __ffs(m1) - 1);
      const unsigned s0 = __ballot_sync(kAll, g0 == g) & m0;
      const unsigned s1 = __ballot_sync(kAll, g1 == g) & m1;
      m0 &= ~s0;
      m1 &= ~s1;
      float ry = 0.f, rk = 0.f;
      sum_slot(s0, e0, xv, yv, zv, sf2, ell, ry, rk);
      sum_slot(s1, e1, xv, yv, zv, sf2, ell, ry, rk);
      mine_acc[g] += ry;
      mine_acc[G + g] += rk;
    }
  }
  __syncwarp();
  // the warp's nodes, one 2G row each, written by the whole warp
  const float* rows = s_acc[wib];
  for (int j = 0; j < 32 && i0 + j < Vall; ++j) {
    const int nj = __shfl_sync(kAll, node, j);
    float* out = acc + ((size_t)t * Vall + nj) * (2 * G);
    for (int q = lane; q < 2 * G; q += 32) out[q] = rows[j * S + q];
  }
}

// The sparse kernel of every r, as K1's segment branch evaluates it.
__global__ void sparse_kernel_scan_kernel(const float* __restrict__ r, float* __restrict__ out,
                                          long long n, float sf2) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = sparse_kernel_r(r[i], sf2);
}

}  // namespace

// Launch K1 for points on ``stream``: Tp CTAs, one thread per node (at most
// 256, the CTA loops over nodes beyond that).  Returns cudaGetLastError().
extern "C" int la3dm_bgk_heavy(const float* entries, const float* labels,
                               const int32_t* ids, const int8_t* gslot,
                               const int32_t* row_start, const int32_t* row_count,
                               const int64_t* block_rows, const float* centers,
                               const float* all_nodes, int Tp, int Vall, int G, float sf2,
                               float ell, float* acc, void* stream) {
  if (Tp <= 0 || Vall <= 0) return (int)cudaErrorInvalidValue;
  int threads = ((Vall + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G == 7) {
    bgk_heavy_kernel<7><<<Tp, threads, 0, s>>>(entries, labels, ids, gslot, row_start,
                                               row_count, block_rows, centers, all_nodes,
                                               Vall, sf2, ell, acc);
  } else if (G == 27) {
    bgk_heavy_kernel<27><<<Tp, threads, 0, s>>>(entries, labels, ids, gslot, row_start,
                                                row_count, block_rows, centers, all_nodes,
                                                Vall, sf2, ell, acc);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Launch K1 for segments on ``stream``: Tp * ceil(Vall / 32) warp units,
// four a CTA; ``node_order`` a permutation of the Vall nodes, ``reach`` =
// r_c * ell, ``culled`` (or null) counts the (warp, entry) pairs skipped.
// Returns cudaGetLastError().
extern "C" int la3dm_bgk_heavy_seg(const float* entries, const float* labels,
                                   const int32_t* ids, const int8_t* gslot,
                                   const int32_t* row_start, const int32_t* row_count,
                                   const int64_t* block_rows, const float* centers,
                                   const float* all_nodes, const int32_t* node_order,
                                   unsigned long long* culled, int Tp, int Vall, int G,
                                   float sf2, float ell, float reach, float* acc,
                                   void* stream) {
  if (Tp <= 0 || Vall <= 0) return (int)cudaErrorInvalidValue;
  const long long units = (long long)Tp * ((Vall + 31) / 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LA3DM_K1S(GG)                                                                      \
  bgk_heavy_seg_kernel<GG><<<(unsigned)((units + kWarps - 1) / kWarps), 32 * kWarps, 0, s>>>( \
      entries, labels, ids, gslot, row_start, row_count, block_rows, centers, all_nodes,      \
      node_order, culled, units, Vall, sf2, ell, reach, acc)
  if (G == 7) {
    LA3DM_K1S(7);
  } else if (G == 27) {
    LA3DM_K1S(27);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef LA3DM_K1S
  return (int)cudaGetLastError();
}

// sparse_kernel_r of each of the n values r on ``stream`` (the r_c scan).
extern "C" int la3dm_sparse_kernel_scan(const float* r, float* out, long long n, float sf2,
                                        void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sparse_kernel_scan_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(r, out, n, sf2);
  return (int)cudaGetLastError();
}
