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
//
// Design:
// * One CTA per test block, one thread per node v.  row_block is
//   non-decreasing, so block t's rows are the contiguous range
//   [block_rows[t], block_rows[t+1]) (torch.searchsorted in the wrapper):
//   each CTA owns its accumulator rows, with no atomics, and the result is
//   deterministic.  The 2G sums live in registers (G is a template
//   parameter) and are written once; each row is summed on its own and
//   then added in, as the plain version adds its per-row products.
// * Each row's entries, labels and slot ids are staged in shared memory and
//   read by every node thread: D = 3 (points) pre-divided by ell; D = 6
//   (segments: start, end) with their terms u, u.u and |u|
//   (segment_dist.cuh), computed once per entry.
// * The entry width D is a template parameter, as is G.
// * What bounds it: FP32 arithmetic on the CUDA cores — about 50 operations
//   per kernel evaluation, sinf/cosf included.  Tensor cores are out: the
//   distances feed a clamp whose sign is decided in the last ulp (the
//   k-bar > 0 update gate), so parity rules out TF32 and a Gram expansion.
//   Built with --fmad=false and without fast-math: every expression rounds
//   as the plain PyTorch version's separate ops round.
//
// Parity with la3dm_tpu/kernels/math.py: per-axis direct subtraction,
// d2 = ((dx*dx) + dy*dy) + dz*dz, both operands divided by ell (no
// reciprocal), node + centre added before the division, and
// TWO_PI = float32(2 * 3.1415926) (sparse_kernel.cuh).  Segments: the
// distance of segment_dist.cuh between the node (node + centre) and the
// segment, then r = d / ell (a division) into the kernel clamped at 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include "segment_dist.cuh"
#include "sparse_kernel.cuh"

namespace {

constexpr int kW = 64;                      // entry-row width (_ROW_W)

template <int G, int D>
__global__ void bgk_heavy_kernel(const float* __restrict__ entries,   // [N,D]
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
  // points: sa = entry / ell; segments: sa = start, sb = end, su = end - start
  __shared__ float sa[3][kW], sb[3][kW], su[3][kW], sc2[kW], slen[kW], sl[kW];
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
      xv = all_nodes[3 * v + 0] + cx;
      yv = all_nodes[3 * v + 1] + cy;
      zv = all_nodes[3 * v + 2] + cz;
      if (D == 3) {
        xv = xv / ell;
        yv = yv / ell;
        zv = zv / ell;
      }
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
        const float* e = entries + (size_t)D * id;
        if (D == 3) {
#pragma unroll
          for (int ax = 0; ax < 3; ++ax) sa[ax][w] = e[ax] / ell;
        } else {
#pragma unroll
          for (int ax = 0; ax < 3; ++ax) {
            sa[ax][w] = e[ax];
            sb[ax][w] = e[3 + ax];
          }
          const SegTerms tm = segment_terms(e[0], e[1], e[2], e[3], e[4], e[5]);
          su[0][w] = tm.ux;
          su[1][w] = tm.uy;
          su[2][w] = tm.uz;
          sc2[w] = tm.c2;
          slen[w] = tm.len;
        }
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
        float k;
        if (D == 3) {
          k = sparse_kernel_d2(dist2(xv - sa[0][w], yv - sa[1][w], zv - sa[2][w]), sf2);
        } else {
          const float d = segment_dist(xv, yv, zv, sa[0][w], sa[1][w], sa[2][w], sb[0][w],
                                       sb[1][w], sb[2][w], su[0][w], su[1][w], su[2][w],
                                       sc2[w], slen[w]);
          k = sparse_kernel_r(d / ell, sf2);
        }
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

template <int G, int D>
void launch(const float* entries, const float* labels, const int32_t* ids,
            const int8_t* gslot, const int32_t* row_start, const int32_t* row_count,
            const int64_t* block_rows, const float* centers, const float* all_nodes,
            int Tp, int threads, int Vall, float sf2, float ell, float* acc,
            cudaStream_t s) {
  bgk_heavy_kernel<G, D><<<Tp, threads, 0, s>>>(entries, labels, ids, gslot, row_start,
                                                row_count, block_rows, centers, all_nodes,
                                                Vall, sf2, ell, acc);
}

}  // namespace

// Launch K1 on ``stream``: Tp CTAs, one thread per node (at most 256, the
// CTA loops over nodes beyond that); entries of width D (3: points, 6:
// segments).  Returns cudaGetLastError().
extern "C" int la3dm_bgk_heavy(const float* entries, const float* labels,
                               const int32_t* ids, const int8_t* gslot,
                               const int32_t* row_start, const int32_t* row_count,
                               const int64_t* block_rows, const float* centers,
                               const float* all_nodes, int Tp, int Vall, int G, int D,
                               float sf2, float ell, float* acc, void* stream) {
  if (Tp <= 0 || Vall <= 0) return (int)cudaErrorInvalidValue;
  int threads = ((Vall + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LA3DM_K1(GG, DD)                                                                  \
  launch<GG, DD>(entries, labels, ids, gslot, row_start, row_count, block_rows, centers, \
                 all_nodes, Tp, threads, Vall, sf2, ell, acc, s)
  if (G == 7 && D == 3) {
    LA3DM_K1(7, 3);
  } else if (G == 27 && D == 3) {
    LA3DM_K1(27, 3);
  } else if (G == 7 && D == 6) {
    LA3DM_K1(7, 6);
  } else if (G == 27 && D == 6) {
    LA3DM_K1(27, 6);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef LA3DM_K1
  return (int)cudaGetLastError();
}
