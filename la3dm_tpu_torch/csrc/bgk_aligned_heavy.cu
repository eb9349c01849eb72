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
// Design (K1's segment branch, bgk_heavy.cu, carried over to this frame):
// * One warp per (test block, 32 nodes) work unit, four units a CTA, all in
//   parallel: T * ceil(Vall / 32) warps, no barrier between them.  Lane i
//   owns node node_order[32 * w + i] (kernels/bgk_heavy.py::node_order, a
//   Morton order, so that a warp's nodes are compact).
// * A unit walks its G slots in order.  For slot g with u = tb_u[t, g] < U
//   its lanes take their coordinates from ext_nodes[g] and walk u's run,
//   32 entries a step, one entry a lane: each lane loads its entry and its
//   terms (points: coordinates / ell; segments: u, u.u, |u|).
// * Exact culling (cull.cuh): the warp's box over ext_nodes[g]'s f32 values
//   of its live lanes, padded by r_c * ell and the margin.  An entry whose
//   segment misses it (a point: lies outside it) is skipped by the warp.
//   Segments: every node lies farther than r_c * ell from the segment, and
//   sparse_kernel_r is exactly 0 for every f32 r >= r_c (K1's argument).
//   Points: the kernel evaluates sqrtf(dist2(x/ell - e/ell)).  A culled
//   point lies, on some axis, farther than ell + m/2 from every node x of
//   the warp (m = 1e-4 * (1 + |box|) >= 1e-4 * (1 + |x|); the padding's own
//   rounding takes at most a few ulp of it).  The two divisions and the
//   difference round by at most 2^-24 each, so the scaled difference loses
//   at most about 2^-23 * (|x - e| + |x|) / ell; at the nearest a culled
//   point comes, |x - e| = ell + m/2, it has m / (2 ell) to spare, more
//   than that loss for every ell below about 400 m: so
//   |dx| >= 1 on that axis, dx*dx >= 1 (rounding is monotone and 1 exact),
//   d2 >= 1 (adding squares never rounds below an addend), r = sqrtf(d2)
//   >= 1, and the kernel is exactly 0.  tests/test_torch_cull.py holds the
//   plain predicate (kernels/bgk_aligned_heavy.py::bgk_aligned_heavy_cull)
//   to never cull a pair with a non-zero plain kernel value, at the support
//   and on the padded box faces.
// * The JAX step's sum order, bit for bit: within one (t, g) the entries
//   add into a row sum of Wa = 8 entries in entry order (rows aligned at
//   the run's start), and each row sum into the slot's total.  A step's
//   survivors are taken in entry order (lane order), and the row sum is
//   flushed into the total at every row boundary.  A culled entry adds
//   exactly +0 in the plain version (k = 0, labels 0 or 1), and adding a
//   zero leaves a sum unchanged, so skipping it changes no bit.  A (t, g)
//   with u = U stays exactly 0.
// * Output: the unit's 32 rows of 2G sums sit in shared memory, a row of
//   2G + 1 floats a lane (no bank conflicts), and are written out node by
//   node by the whole warp, coalesced.  Each output element has one writer:
//   plain stores, no atomics, deterministic.
// * ``culled`` (or null) counts the (warp, entry) pairs skipped, one atomic
//   a unit.
// * What bounds it: FP32 arithmetic on the CUDA cores, about 50 operations
//   per point evaluation and 85 per segment evaluation, on the pairs the
//   culling keeps.  No tensor cores: the clamp boundary is decided in the
//   last ulp.  Built with --fmad=false, division by ell (no reciprocal),
//   per-axis x, y, z sums.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cull.cuh"
#include "segment_dist.cuh"
#include "sparse_kernel.cuh"

namespace {

constexpr int kWa = 8;          // the JAX step's entry-row width
constexpr int kStep = 32;       // entries a warp takes a step, one a lane
constexpr int kWarps = 4;       // work units (warps) per CTA
constexpr int kSmemMax = 48 * 1024;
constexpr unsigned kAll = 0xffffffffu;

// A point entry as the point branch evaluates it: coordinates / ell, label.
struct Pt {
  float x, y, z, lab;
};

template <int D>
__global__ void __launch_bounds__(32 * kWarps)
bgk_aligned_heavy_kernel(const float* __restrict__ ent_rel,      // [M,D]
                         const float* __restrict__ labels,       // [M]
                         const int64_t* __restrict__ ustart,     // [U]
                         const int64_t* __restrict__ ucount,     // [U]
                         const int64_t* __restrict__ tb_u,       // [T,G]
                         const float* __restrict__ ext_nodes,    // [G*Vall,3]
                         const int32_t* __restrict__ node_order, // [Vall]
                         unsigned long long* __restrict__ culled,  // [1] or null
                         int64_t n_units, int64_t U, int Vall, int G, float sf2, float ell,
                         float reach, float* __restrict__ acc) {  // [T,Vall,2G]
  extern __shared__ float s_rows[];  // per warp: 32 rows of 2G + 1 floats
  const int S = 2 * G + 1;
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int64_t unit = (int64_t)blockIdx.x * kWarps + wib;
  if (unit >= n_units) return;  // uniform over the warp
  const int wpb = (Vall + 31) / 32;
  const int64_t t = unit / wpb;
  const int i0 = (int)(unit % wpb) * 32;
  const bool live = i0 + lane < Vall;
  const int node = live ? node_order[i0 + lane] : 0;
  float* rows = s_rows + (size_t)wib * 32 * S;
  float* mine = rows + lane * S;
  unsigned long long n_culled = 0;

  for (int g = 0; g < G; ++g) {
    const int64_t u = tb_u[t * G + g];
    float yb = 0.f, kb = 0.f;
    if (u < U) {
      const float* p = ext_nodes + 3 * ((size_t)g * Vall + node);
      float xv = p[0], yv = p[1], zv = p[2];
      float plo[3], phi[3];
      warp_box(live, xv, yv, zv, reach, plo, phi);
      if (D == 3) {
        xv = xv / ell;
        yv = yv / ell;
        zv = zv / ell;
      }
      const int64_t st = ustart[u];
      const int64_t n = ucount[u];
      float ry = 0.f, rk = 0.f;  // the current Wa-row's sums
      int64_t row = 0;
      for (int64_t c0 = 0; c0 < n; c0 += kStep) {
        const int cnt = (int)min((int64_t)kStep, n - c0);
        bool keep = false;
        Pt pt{};
        Seg sg{};
        if (lane < cnt) {
          const int64_t e = st + c0 + lane;
          const float* x = ent_rel + D * e;
          if (D == 3) {
            const float a[3] = {x[0], x[1], x[2]};
            keep = !point_misses_box(a, plo, phi);
            if (keep) pt = Pt{a[0] / ell, a[1] / ell, a[2] / ell, labels[e]};
          } else {
            sg = seg_load(x, labels[e]);
            keep = !segment_misses_box(sg.a, sg.u, plo, phi);
          }
        }
        unsigned m = __ballot_sync(kAll, keep);
        n_culled += (unsigned)(cnt - __popc(m));
        while (m) {  // the survivors in entry order
          const int src = __ffs(m) - 1;
          m &= m - 1;
          const int64_t r = (c0 + src) / kWa;
          if (r != row) {
            yb = yb + ry;
            kb = kb + rk;
            ry = 0.f;
            rk = 0.f;
            row = r;
          }
          float k, lab;
          if (D == 3) {
            const float ex = __shfl_sync(kAll, pt.x, src);
            const float ey = __shfl_sync(kAll, pt.y, src);
            const float ez = __shfl_sync(kAll, pt.z, src);
            lab = __shfl_sync(kAll, pt.lab, src);
            k = sparse_kernel_d2(dist2(xv - ex, yv - ey, zv - ez), sf2);
          } else {
            const Seg s = seg_shfl(sg, src);
            lab = s.lab;
            k = sparse_kernel_r(seg_dist(xv, yv, zv, s) / ell, sf2);
          }
          ry = ry + k * lab;
          rk = rk + k;
        }
      }
      yb = yb + ry;
      kb = kb + rk;
    }
    mine[g] = yb;
    mine[G + g] = kb;
  }
  if (culled != nullptr && lane == 0) atomicAdd(culled, n_culled);
  __syncwarp();
  // the warp's nodes, one 2G row each, written by the whole warp
  for (int j = 0; j < 32 && i0 + j < Vall; ++j) {
    const int nj = __shfl_sync(kAll, node, j);
    float* out = acc + ((size_t)t * Vall + nj) * (2 * G);
    for (int q = lane; q < 2 * G; q += 32) out[q] = rows[j * S + q];
  }
}

}  // namespace

// Launch K1' on ``stream``: T * ceil(Vall / 32) warp units, four a CTA
// (G <= 47: a CTA's rows of 2G + 1 floats a lane within 48 KB of shared
// memory); entries of width D (3: points, 6: segments); ``node_order`` a
// permutation of the Vall nodes, ``reach`` = r_c * ell, ``culled`` (or null)
// counts the (warp, entry) pairs skipped.  Returns cudaGetLastError().
extern "C" int la3dm_bgk_aligned_heavy(const float* ent_rel, const float* labels,
                                       const int64_t* ustart, const int64_t* ucount,
                                       const int64_t* tb_u, const float* ext_nodes,
                                       const int32_t* node_order, unsigned long long* culled,
                                       long long T, long long U, int Vall, int G, int D,
                                       float sf2, float ell, float reach, float* acc,
                                       void* stream) {
  const size_t smem = (size_t)kWarps * 32 * (2 * G + 1) * sizeof(float);
  if (T <= 0 || Vall <= 0 || G <= 0 || smem > kSmemMax) return (int)cudaErrorInvalidValue;
  const long long units = T * ((Vall + 31) / 32);
  const unsigned blocks = (unsigned)((units + kWarps - 1) / kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 3) {
    bgk_aligned_heavy_kernel<3><<<blocks, 32 * kWarps, smem, s>>>(
        ent_rel, labels, ustart, ucount, tb_u, ext_nodes, node_order, culled, units, U,
        Vall, G, sf2, ell, reach, acc);
  } else if (D == 6) {
    bgk_aligned_heavy_kernel<6><<<blocks, 32 * kWarps, smem, s>>>(
        ent_rel, labels, ustart, ucount, tb_u, ext_nodes, node_order, culled, units, U,
        Vall, G, sf2, ell, reach, acc);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
