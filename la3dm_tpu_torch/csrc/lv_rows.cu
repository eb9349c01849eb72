// K3 — the BGKLV tile row engine, hand-written for Hopper (sm_90a).
//
// Replaces la3dm_tpu/models/bgklv.py::_lv_rows_step (lines 127-208, with
// _ray_membership :66-119, kernels/math.py::point_to_segment_dist and
// sparse_kernel_lv): every (scan, 8^3 tile) row of <= 64 segment entries
// (hits are degenerate segments), the closed-form +-ell cube membership of
// each ray's proxy samples, the LV kernel on the point-to-segment distance,
// (ybar, kbar) per voxel summed over the tile's rows, the gate
// kbar > gate && eff == 0, and the add into the tile-major pool.
//
// Design:
// * One CTA per pool row (slot * tpb + pos) that the dispatch reaches, one
//   thread per voxel of the tile (Vt <= 512).  The wrapper sorts the tile
//   list by pool row with a stable sort and passes the runs of equal pool
//   rows (run_start); CTA i walks run i in scan order.  So one CTA owns each
//   pool row: no atomics, and a tile that several scans of one dispatch
//   reach is gated and added once per scan, in scan order, as the plain
//   version adds it (deterministic; the JAX step's scatter-add has no fixed
//   order).
// * A tile's rows are contiguous (row_tile is non-decreasing):
//   tile_rows[t] .. tile_rows[t+1] from torch.searchsorted in the wrapper.
//   Each row's entries are staged in shared memory with their per-entry
//   terms (u, |u|, u/|u|, ceil(|u|/fr) - 1), computed once per entry.
// * Each thread sums a row's entries in order, then adds the row total to
//   its tile sum: the same two levels as the plain version (per-row sum,
//   then index_add over rows).  Non-members contribute exactly 0 and are
//   skipped.
// * What bounds it: FP32 operations on the CUDA cores — 61 per (voxel,
//   entry) for the membership and 61 more for a member's distance, kernel
//   and sums (sinf and cosf counted as one each).  Parity keeps it off the
//   tensor cores.  Built with --fmad=false and without fast math: every
//   expression rounds like the plain PyTorch version's separate operations
//   (the membership decides samples on a cube face in the last ulp, and
//   the kbar > 0.001 gate sits on the kernel's support boundary).
//
// Parity with the JAX package: slab test, flat axis at |n| < 1e-12 with
// +-inf sentinels, ceil/floor of (l - d)/fr with real divisions; the
// point-to-segment distance of segment_dist.cuh (shared with K1 and K1' in
// segment mode); r = d/ell (a division) clamped to <= 1;
// TWO_PI = float32(2 * 3.1415926).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "segment_dist.cuh"

namespace {

constexpr int kW = 64;                      // entry-row width (_ROW_W)
constexpr int kMaxVt = 512;                 // voxels per tile (8^3)
constexpr float kTwoPi = 0x1.921fb4p+2f;   // float32(2 * 3.1415926)

__global__ void lv_rows_kernel(const float* __restrict__ entries,    // [E,6]
                               const float* __restrict__ labels,     // [E]
                               const int32_t* __restrict__ ids,      // [F]
                               const int32_t* __restrict__ row_start,  // [R]
                               const int32_t* __restrict__ row_count,  // [R]
                               const int64_t* __restrict__ tile_rows,  // [T+1]
                               const int64_t* __restrict__ order,    // [T]
                               const int64_t* __restrict__ run_start,  // [U+1]
                               const int32_t* __restrict__ tile_slot,  // [T]
                               const int32_t* __restrict__ tile_pos,   // [T]
                               const float* __restrict__ tile_ctr,   // [T,3]
                               const float* __restrict__ vox_base_t, // [tpb,Vt,3]
                               const int8_t* __restrict__ eff,       // [cap*V]
                               float* __restrict__ A,                // [cap*V]
                               float* __restrict__ B,                // [cap*V]
                               uint8_t* __restrict__ touched,        // [cap*V]
                               int cap, int tpb, int Vt, float sf2, float ell,
                               float fr, float gate) {
  __shared__ float s_a[3][kW], s_b[3][kW], s_u[3][kW], s_n[3][kW];
  __shared__ float s_l[kW], s_c2[kW], s_kcap[kW], s_lab[kW];

  const int64_t j0 = run_start[blockIdx.x], j1 = run_start[blockIdx.x + 1];
  const int64_t t0 = order[j0];
  const int slot = tile_slot[t0];
  if (slot < 0 || slot >= cap) return;  // padding tiles: uniform over the CTA
  const int pos = tile_pos[t0];
  const int v = threadIdx.x;
  const bool live = v < Vt;
  const size_t p = ((size_t)slot * tpb + pos) * Vt + v;

  const bool base_leaf = live && eff[p] == 0;
  float An = 0.f, Bn = 0.f;
  uint8_t Tn = 0;
  float bx = 0.f, by = 0.f, bz = 0.f;
  if (live) {
    An = A[p];
    Bn = B[p];
    Tn = touched[p];
    const float* vb = vox_base_t + ((size_t)pos * Vt + v) * 3;
    bx = vb[0];
    by = vb[1];
    bz = vb[2];
  }

  for (int64_t j = j0; j < j1; ++j) {
    const int64_t t = order[j];
    // the voxel centre, as the plain version adds it: centre + offset
    const float px = tile_ctr[3 * t + 0] + bx;
    const float py = tile_ctr[3 * t + 1] + by;
    const float pz = tile_ctr[3 * t + 2] + bz;
    const float lo[3] = {px - ell, py - ell, pz - ell};
    const float hi[3] = {px + ell, py + ell, pz + ell};
    float ay = 0.f, ak = 0.f;

    for (int64_t r = tile_rows[t]; r < tile_rows[t + 1]; ++r) {
      const int st = row_start[r];
      const int cnt = min(row_count[r], kW);
      __syncthreads();  // the previous row's entries are consumed
      for (int w = threadIdx.x; w < cnt; w += blockDim.x) {
        const int id = ids[st + w];
        const float* e = entries + 6 * (size_t)id;
        float u[3];
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) {
          s_a[ax][w] = e[ax];
          s_b[ax][w] = e[3 + ax];
          u[ax] = e[3 + ax] - e[ax];
          s_u[ax][w] = u[ax];
        }
        float c2 = u[0] * u[0];
        c2 = c2 + u[1] * u[1];
        c2 = c2 + u[2] * u[2];
        const float l = sqrtf(c2);
        const float lc = fmaxf(l, 1e-30f);
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) s_n[ax][w] = u[ax] / lc;
        s_l[w] = l;
        s_c2[w] = c2;
        s_kcap[w] = ceilf(l / fr) - 1.0f;
        s_lab[w] = labels[id];
      }
      __syncthreads();
      if (!live) continue;

      float ry = 0.f, rk = 0.f;
      for (int w = 0; w < cnt; ++w) {
        // --- membership: does a proxy sample of the ray lie in the cube?
        bool in_a = true;
        float dlo = -CUDART_INF_F, dhi = CUDART_INF_F;
#pragma unroll
        for (int ax = 0; ax < 3; ++ax) {
          const float a_ = s_a[ax][w];
          const float n_ = s_n[ax][w];
          const bool slab = (a_ >= lo[ax]) && (a_ <= hi[ax]);
          in_a = in_a && slab;
          const bool flat = fabsf(n_) < 1e-12f;
          const float safe = flat ? 1.0f : n_;
          const float t0v = (lo[ax] - a_) / safe;
          const float t1v = (hi[ax] - a_) / safe;
          float tmn = fminf(t0v, t1v);
          float tmx = fmaxf(t0v, t1v);
          if (flat) {
            tmn = slab ? -CUDART_INF_F : CUDART_INF_F;
            tmx = slab ? CUDART_INF_F : -CUDART_INF_F;
          }
          dlo = fmaxf(dlo, tmn);
          dhi = fminf(dhi, tmx);
        }
        const float l = s_l[w];
        const float k_min = fmaxf(ceilf((l - dhi) / fr), 1.0f);
        const float k_max = fminf(floorf((l - fmaxf(dlo, 0.0f)) / fr), s_kcap[w]);
        const bool in_beam = (k_min <= k_max) && (dhi >= dlo);
        if (!(in_a || in_beam)) continue;  // K = 0: adds nothing

        // --- point-to-segment distance (segment_dist.cuh)
        const float d = segment_dist(px, py, pz, s_a[0][w], s_a[1][w], s_a[2][w], s_b[0][w],
                                     s_b[1][w], s_b[2][w], s_u[0][w], s_u[1][w], s_u[2][w],
                                     s_c2[w], s_l[w]);

        // --- LV sparse kernel: r clamped to <= 1, no output clamp
        const float rr = fminf(d / ell, 1.0f);
        const float ang = kTwoPi * rr;
        const float k = ((2.0f + cosf(ang)) * (1.0f - rr) / 3.0f + sinf(ang) / kTwoPi) * sf2;
        const float ky = k * s_lab[w];
        ry = ry + ky;
        rk = rk + k;
      }
      ay = ay + ry;
      ak = ak + rk;
    }
    // gate once per (scan, tile): kbar > gate at a base-resolution leaf
    if (base_leaf && ak > gate) {
      An = An + ay;
      Bn = Bn + (ak - ay);
      Tn = 1;
    }
  }
  if (live) {
    A[p] = An;
    B[p] = Bn;
    touched[p] = Tn;
  }
}

}  // namespace

// Launch K3 on ``stream``: U CTAs (one per run of equal pool rows in the
// sorted tile list, run_start [U+1]) of Vt threads rounded up to a warp.
// Returns cudaGetLastError().
extern "C" int la3dm_lv_rows(const float* entries, const float* labels,
                             const int32_t* ids, const int32_t* row_start,
                             const int32_t* row_count, const int64_t* tile_rows,
                             const int64_t* order, const int64_t* run_start,
                             const int32_t* tile_slot, const int32_t* tile_pos,
                             const float* tile_ctr, const float* vox_base_t,
                             const int8_t* eff, float* A, float* B, uint8_t* touched,
                             int U, int cap, int tpb, int Vt, float sf2, float ell,
                             float free_res, float gate, void* stream) {
  if (U <= 0 || Vt <= 0 || Vt > kMaxVt || tpb <= 0) return (int)cudaErrorInvalidValue;
  const int threads = ((Vt + 31) / 32) * 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  lv_rows_kernel<<<U, threads, 0, s>>>(entries, labels, ids, row_start, row_count,
                                       tile_rows, order, run_start, tile_slot, tile_pos,
                                       tile_ctr, vox_base_t, eff, A, B, touched, cap, tpb,
                                       Vt, sf2, ell, free_res, gate);
  return (int)cudaGetLastError();
}
