// K1' — the BGK heavy pass of the device-ingest path, hand-written for
// Hopper (sm_90a), for point entries (BGK) and segment entries (BGKL).
//
// Replaces la3dm_tpu/models/bgk.py::_aligned_heavy (lines 204-252) and the
// accumulator half of _bgk_seq_step_aligned (lines 255-302): for each test
// block t and neighbour slot g, the entries of entry block u = t + off_g
// (tb_u[t, g]; U means none), given relative to u's centre (ent_rel), are
// evaluated against the shifted node table ext_nodes[g] = all_nodes -
// off_g * bs, since node(t) - e = ext_nodes[g] - ent_rel:
//   acc[t, v, g]     = sum_e k(ext_nodes[g, v], ent_rel[e]) * label[e]
//   acc[t, v, G + g] = sum_e k(ext_nodes[g, v], ent_rel[e])
// with k the clamped sparse kernel (sparse_kernel.cuh).  Segment entries
// (D = 6: start, end, both relative to u's centre; models/bgk.py:229-230)
// take the distance of segment_dist.cuh, shared with K1 and K3, and
// r = d / ell.  acc has K2's layout [T, Vall, 2G], so the light pass runs
// unchanged after it.
//
// Design:
// * One CTA per test block, one thread per node (at most 256, the CTA loops
//   over nodes beyond that).  Each (t, g) has one writer: plain stores, no
//   atomics, deterministic.
// * Each entry run is staged in shared memory 64 entries at a time
//   (points: coordinates pre-divided by ell; segments: start, end and the
//   terms u, u.u, |u| of segment_dist.cuh; labels) and read by every node
//   thread.  The entry width D is a template parameter.
// * Sum order: the JAX step sums rows of Wa = 8 entries (aligned at the run's
//   start) and then adds the rows; so does this kernel, and its plain
//   version.  The k-bar > 0 gate is decided term by term anyway: every term
//   is clamped >= 0, so a sum is > 0 exactly when one of its terms is.
// * What bounds it: FP32 arithmetic on the CUDA cores, about 50 operations
//   per kernel evaluation.  No tensor cores: the clamp boundary is decided
//   in the last ulp.  Built with --fmad=false, division by ell (no
//   reciprocal), per-axis x, y, z sums.

#include <cuda_runtime.h>
#include <stdint.h>

#include "segment_dist.cuh"
#include "sparse_kernel.cuh"

namespace {

constexpr int kStage = 64;   // entries staged at once (a multiple of Wa)
constexpr int kWa = 8;       // the JAX step's entry-row width

template <int D>
__global__ void bgk_aligned_heavy_kernel(const float* __restrict__ ent_rel,  // [M,D]
                                         const float* __restrict__ labels,   // [M]
                                         const int64_t* __restrict__ ustart, // [U]
                                         const int64_t* __restrict__ ucount, // [U]
                                         const int64_t* __restrict__ tb_u,   // [T,G]
                                         const float* __restrict__ ext_nodes,  // [G*Vall,3]
                                         int64_t U, int Vall, int G, float sf2, float ell,
                                         float* __restrict__ acc) {          // [T,Vall,2G]
  // points: sa = entry / ell; segments: sa = start, sb = end, su = end - start
  __shared__ float sa[3][kStage], sb[3][kStage], su[3][kStage], sc2[kStage],
      slen[kStage], sl[kStage];
  const int64_t t = blockIdx.x;

  for (int v0 = 0; v0 < Vall; v0 += blockDim.x) {
    const int v = v0 + threadIdx.x;
    const bool live = v < Vall;
    float* out = acc + ((size_t)t * Vall + (live ? v : 0)) * (2 * G);
    for (int g = 0; g < G; ++g) {
      const int64_t u = tb_u[t * G + g];
      float xv = 0.f, yv = 0.f, zv = 0.f;
      if (live) {
        const float* node = ext_nodes + 3 * ((size_t)g * Vall + v);
        xv = node[0];
        yv = node[1];
        zv = node[2];
        if (D == 3) {
          xv = xv / ell;
          yv = yv / ell;
          zv = zv / ell;
        }
      }
      float yb = 0.f, kb = 0.f;
      const int64_t st = u < U ? ustart[u] : 0;
      const int64_t n = u < U ? ucount[u] : 0;
      for (int64_t c0 = 0; c0 < n; c0 += kStage) {
        const int cnt = (int)min((int64_t)kStage, n - c0);
        __syncthreads();  // the previous stage is consumed
        for (int w = threadIdx.x; w < cnt; w += blockDim.x) {
          const int64_t e = st + c0 + w;
          const float* x = ent_rel + D * e;
          if (D == 3) {
#pragma unroll
            for (int ax = 0; ax < 3; ++ax) sa[ax][w] = x[ax] / ell;
          } else {
#pragma unroll
            for (int ax = 0; ax < 3; ++ax) {
              sa[ax][w] = x[ax];
              sb[ax][w] = x[3 + ax];
            }
            const SegTerms tm = segment_terms(x[0], x[1], x[2], x[3], x[4], x[5]);
            su[0][w] = tm.ux;
            su[1][w] = tm.uy;
            su[2][w] = tm.uz;
            sc2[w] = tm.c2;
            slen[w] = tm.len;
          }
          sl[w] = labels[e];
        }
        __syncthreads();
        if (!live) continue;
        for (int r0 = 0; r0 < cnt; r0 += kWa) {
          float ry = 0.f, rk = 0.f;   // one Wa-row's sums, then added in
          const int r1 = min(r0 + kWa, cnt);
          for (int w = r0; w < r1; ++w) {
            float k;
            if (D == 3) {
              k = sparse_kernel_d2(dist2(xv - sa[0][w], yv - sa[1][w], zv - sa[2][w]), sf2);
            } else {
              const float d = segment_dist(xv, yv, zv, sa[0][w], sa[1][w], sa[2][w],
                                           sb[0][w], sb[1][w], sb[2][w], su[0][w],
                                           su[1][w], su[2][w], sc2[w], slen[w]);
              k = sparse_kernel_r(d / ell, sf2);
            }
            ry = ry + k * sl[w];
            rk = rk + k;
          }
          yb = yb + ry;
          kb = kb + rk;
        }
      }
      if (live) {
        out[g] = yb;
        out[G + g] = kb;
      }
    }
  }
}

}  // namespace

// Launch K1' on ``stream``: T CTAs, one thread per node (at most 256);
// entries of width D (3: points, 6: segments).  Returns cudaGetLastError().
extern "C" int la3dm_bgk_aligned_heavy(const float* ent_rel, const float* labels,
                                       const int64_t* ustart, const int64_t* ucount,
                                       const int64_t* tb_u, const float* ext_nodes,
                                       long long T, long long U, int Vall, int G, int D,
                                       float sf2, float ell, float* acc, void* stream) {
  if (T <= 0 || Vall <= 0 || G <= 0) return (int)cudaErrorInvalidValue;
  int threads = ((Vall + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 3) {
    bgk_aligned_heavy_kernel<3><<<(unsigned)T, threads, 0, s>>>(
        ent_rel, labels, ustart, ucount, tb_u, ext_nodes, U, Vall, G, sf2, ell, acc);
  } else if (D == 6) {
    bgk_aligned_heavy_kernel<6><<<(unsigned)T, threads, 0, s>>>(
        ent_rel, labels, ustart, ucount, tb_u, ext_nodes, U, Vall, G, sf2, ell, acc);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
