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
// Design: two phases per chunk of the (scan, tile) list, which the wrapper
// plans (kernels/lv_rows.py::lv_rows_plan).
// * Phase 1, the row sums: one warp per (row, 32 voxels) work unit, all in
//   parallel, four units a CTA, so that a tile of many rows (the sensor's
//   own, which every ray crosses) spreads over many warps.  Lane i owns
//   voxel 32*w + i of the row's tile, in the tile's raster order (8 x 4 x 1
//   voxels a warp), and sums the row's entries in order into a [Rc, Vt] f32
//   scratch.  Warps share nothing: no barrier.
// * Each lane loads one or two of the row's entries and computes their
//   terms (u, |u|, u/|u|, ceil(|u|/fr) - 1) once; an entry whose segment
//   misses the warp's voxel box padded by ell is a member of none of the
//   32 cubes and is skipped by the whole warp (cull.cuh: exact); the
//   others are broadcast by shuffles and tested lane by lane.  The slab
//   test runs first, and the beam interval only where it fails and the
//   entry has a backward sample at all (ceil(|u|/fr) - 1 >= 1).
// * Phase 2, the tile sums and the gate: one CTA per position of the
//   chunk's tile list sorted by pool row (stable: scan order within a pool
//   row); the first of each run of equal pool rows adds each (scan, tile)'s
//   row sums in row order — the plain version's two levels — then applies
//   kbar > gate && eff == 0 and adds the sums into the pool row, tile by
//   tile in scan order, as the plain version does.  eff is read-only within
//   a dispatch (the prune K8 runs after it), so splitting the sums from the
//   gate changes no bit.  No atomics: the result is deterministic.
// * What bounds it: FP32 operations on the CUDA cores — 61 per (voxel,
//   entry) for the membership and 61 more for a member's distance, kernel
//   and sums (sinf and cosf counted as one each), counted for every pair
//   the plain version evaluates.  Parity keeps it off the tensor cores.
//   Built with --fmad=false and without fast math: every expression rounds
//   like the plain PyTorch version's separate operations (the membership
//   decides samples on a cube face in the last ulp, and the kbar > 0.001
//   gate sits on the kernel's support boundary).
//
// Parity with the JAX package: slab test, flat axis at |n| < 1e-12 with
// +-inf sentinels, ceil/floor of (l - d)/fr with real divisions; the
// point-to-segment distance of segment_dist.cuh (shared with K1 and K1' in
// segment mode); r = d/ell (a division) clamped to <= 1;
// TWO_PI = float32(2 * 3.1415926).

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "cull.cuh"
#include "segment_dist.cuh"

namespace {

constexpr int kW = 64;                      // entry-row width (_ROW_W)
constexpr int kMaxVt = 512;                 // voxels per tile (8^3)
constexpr int kWarps = 4;                   // work units (warps) per CTA
constexpr float kTwoPi = 0x1.921fb4p+2f;   // float32(2 * 3.1415926)

// One entry's terms, as the kernel's membership and distance read them.
struct Entry {
  float a[3], b[3], u[3], n[3];
  float l, c2, kcap, lab;
};

__device__ __forceinline__ Entry load_entry(const float* __restrict__ entries,
                                            const float* __restrict__ labels, int id,
                                            float fr) {
  Entry e;
  const float* p = entries + 6 * (size_t)id;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    e.a[ax] = p[ax];
    e.b[ax] = p[3 + ax];
    e.u[ax] = e.b[ax] - e.a[ax];
  }
  float c2 = e.u[0] * e.u[0];
  c2 = c2 + e.u[1] * e.u[1];
  c2 = c2 + e.u[2] * e.u[2];
  e.c2 = c2;
  e.l = sqrtf(c2);
  const float lc = fmaxf(e.l, 1e-30f);
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) e.n[ax] = e.u[ax] / lc;
  e.kcap = ceilf(e.l / fr) - 1.0f;
  e.lab = labels[id];
  return e;
}

__device__ __forceinline__ Entry shfl_entry(const Entry& x, int src) {
  Entry e;
  constexpr unsigned kAll = 0xffffffffu;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    e.a[ax] = __shfl_sync(kAll, x.a[ax], src);
    e.b[ax] = __shfl_sync(kAll, x.b[ax], src);
    e.u[ax] = __shfl_sync(kAll, x.u[ax], src);
    e.n[ax] = __shfl_sync(kAll, x.n[ax], src);
  }
  e.l = __shfl_sync(kAll, x.l, src);
  e.c2 = __shfl_sync(kAll, x.c2, src);
  e.kcap = __shfl_sync(kAll, x.kcap, src);
  e.lab = __shfl_sync(kAll, x.lab, src);
  return e;
}

// Is a proxy sample of the entry in the voxel's cube [lo, hi]?  The old
// one-CTA kernel's membership, op for op; the beam interval only where the
// slab test fails and the entry has a backward sample at all (k in
// [1, kcap]: none when kcap < 1, as for hits).
__device__ __forceinline__ bool member_of(const Entry& e, bool live, const float lo[3],
                                          const float hi[3], float fr) {
  bool in_a = live;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) in_a = in_a && (e.a[ax] >= lo[ax]) && (e.a[ax] <= hi[ax]);
  if (in_a || !live || e.kcap < 1.0f) return in_a;
  float dlo = -CUDART_INF_F, dhi = CUDART_INF_F;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float a_ = e.a[ax];
    const float n_ = e.n[ax];
    const bool slab = (a_ >= lo[ax]) && (a_ <= hi[ax]);
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
  const float k_min = fmaxf(ceilf((e.l - dhi) / fr), 1.0f);
  const float k_max = fminf(floorf((e.l - fmaxf(dlo, 0.0f)) / fr), e.kcap);
  return (k_min <= k_max) && (dhi >= dlo);
}

// The LV kernel of the voxel's distance to the entry's segment
// (segment_dist.cuh): r clamped to <= 1, no output clamp.
__device__ __forceinline__ float lv_kernel(const Entry& e, float px, float py, float pz,
                                           float ell, float sf2) {
  const float d = segment_dist(px, py, pz, e.a[0], e.a[1], e.a[2], e.b[0], e.b[1], e.b[2],
                               e.u[0], e.u[1], e.u[2], e.c2, e.l);
  const float rr = fminf(d / ell, 1.0f);
  const float ang = kTwoPi * rr;
  return ((2.0f + cosf(ang)) * (1.0f - rr) / 3.0f + sinf(ang) / kTwoPi) * sf2;
}

// Phase 1: rows_y / rows_k [Rc, Vt], the sums of rows r0 .. r0 + Rc - 1.
__global__ void __launch_bounds__(32 * kWarps)
lv_rows_acc_kernel(const float* __restrict__ entries,      // [E,6]
                   const float* __restrict__ labels,       // [E]
                   const int32_t* __restrict__ ids,        // [F]
                   const int32_t* __restrict__ row_start,  // [R]
                   const int32_t* __restrict__ row_count,  // [R]
                   const int32_t* __restrict__ row_tile,   // [R]
                   const int32_t* __restrict__ tile_slot,  // [T]
                   const int32_t* __restrict__ tile_pos,   // [T]
                   const float* __restrict__ tile_ctr,     // [T,3]
                   const float* __restrict__ vox_base_t,   // [tpb,Vt,3]
                   float* __restrict__ rows_y,             // [Rc,Vt]
                   float* __restrict__ rows_k,             // [Rc,Vt]
                   unsigned long long* __restrict__ culled,  // [1] or null
                   int64_t r0, int64_t n_units, int cap, int Vt, float sf2, float ell,
                   float fr) {
  const int lane = threadIdx.x & 31;
  const int64_t unit = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (unit >= n_units) return;  // uniform over the warp
  const int wpt = (Vt + 31) / 32;
  const int64_t rc = unit / wpt;
  const int64_t r = r0 + rc;
  const int64_t t = row_tile[r];
  const int slot = tile_slot[t];
  if (slot < 0 || slot >= cap) return;  // padding tiles: phase 2 skips them
  const int pos = tile_pos[t];
  const int v = (int)(unit % wpt) * 32 + lane;
  const bool live = v < Vt;

  // the voxel centre, as the plain version adds it: centre + offset
  float px = 0.f, py = 0.f, pz = 0.f;
  if (live) {
    const float* vb = vox_base_t + ((size_t)pos * Vt + v) * 3;
    px = tile_ctr[3 * t + 0] + vb[0];
    py = tile_ctr[3 * t + 1] + vb[1];
    pz = tile_ctr[3 * t + 2] + vb[2];
  }
  const float lo[3] = {px - ell, py - ell, pz - ell};
  const float hi[3] = {px + ell, py + ell, pz + ell};
  float plo[3], phi[3];
  warp_box(live, px, py, pz, ell, plo, phi);

  const int st = row_start[r];
  const int cnt = min(row_count[r], kW);
  float ry = 0.f, rk = 0.f;
  for (int h = 0; h < cnt; h += 32) {
    const bool have = h + lane < cnt;
    Entry mine{};
    bool keep = false;
    if (have) {
      mine = load_entry(entries, labels, ids[st + h + lane], fr);
      keep = !segment_misses_box(mine.a, mine.u, plo, phi);
    }
    unsigned mask = __ballot_sync(0xffffffffu, keep);
    if (culled != nullptr && lane == 0)
      atomicAdd(culled, (unsigned long long)(min(cnt - h, 32) - __popc(mask)));
    while (mask) {  // the surviving entries, in row order
      const int src = __ffs(mask) - 1;
      mask &= mask - 1;
      const Entry e = shfl_entry(mine, src);
      if (member_of(e, live, lo, hi, fr)) {  // a non-member adds nothing
        const float k = lv_kernel(e, px, py, pz, ell, sf2);
        const float ky = k * e.lab;
        ry = ry + ky;
        rk = rk + k;
      }
    }
  }
  if (live) {
    rows_y[rc * Vt + v] = ry;
    rows_k[rc * Vt + v] = rk;
  }
}

// Phase 2: CTA j owns position j of the chunk's tiles sorted by pool row;
// the first of a run sums each tile's rows and gates and adds the run's
// (scan, tile) sums in scan order.
__global__ void lv_rows_apply_kernel(const int64_t* __restrict__ apply_order,  // [Tc]
                                     const int64_t* __restrict__ tile_rows,   // [T+1]
                                     const int32_t* __restrict__ tile_slot,   // [T]
                                     const int32_t* __restrict__ tile_pos,    // [T]
                                     const float* __restrict__ rows_y,        // [Rc,Vt]
                                     const float* __restrict__ rows_k,        // [Rc,Vt]
                                     const int8_t* __restrict__ eff,          // [cap*V]
                                     float* __restrict__ A, float* __restrict__ B,
                                     uint8_t* __restrict__ touched, int64_t t0,
                                     int64_t Tc, int64_t r0, int cap, int tpb, int Vt,
                                     float gate) {
  const int64_t j = blockIdx.x;
  const int64_t t = t0 + apply_order[j];
  const int slot = tile_slot[t];
  if (slot < 0 || slot >= cap) return;  // padding tiles
  const int64_t key = (int64_t)slot * tpb + tile_pos[t];
  if (j > 0) {
    const int64_t tp = t0 + apply_order[j - 1];
    if ((int64_t)tile_slot[tp] * tpb + tile_pos[tp] == key) return;  // not a run head
  }
  const int v = threadIdx.x;
  if (v >= Vt) return;
  const size_t p = (size_t)key * Vt + v;
  const bool base_leaf = eff[p] == 0;
  float An = A[p], Bn = B[p];
  uint8_t Tn = touched[p];
  for (int64_t jj = j; jj < Tc; ++jj) {
    const int64_t tj = t0 + apply_order[jj];
    if ((int64_t)tile_slot[tj] * tpb + tile_pos[tj] != key) break;
    // the (scan, tile) sums: its rows' sums added in row order
    float ay = 0.f, ak = 0.f;
    for (int64_t r = tile_rows[tj]; r < tile_rows[tj + 1]; ++r) {
      ay = ay + rows_y[(r - r0) * Vt + v];
      ak = ak + rows_k[(r - r0) * Vt + v];
    }
    // gate once per (scan, tile): kbar > gate at a base-resolution leaf
    if (base_leaf && ak > gate) {
      An = An + ay;
      Bn = Bn + (ak - ay);
      Tn = 1;
    }
  }
  A[p] = An;
  B[p] = Bn;
  touched[p] = Tn;
}

}  // namespace

// Launch K3 on ``stream`` for one chunk of the tile list, tiles
// t0 .. t0 + Tc - 1 and their rows r0 .. r0 + Rc - 1: phase 1 (Rc *
// ceil(Vt/32) warp units, four a CTA) into the scratch rows_y / rows_k
// [Rc, Vt], then phase 2 (Tc CTAs over ``apply_order``, the chunk's tiles
// sorted by pool row).  ``culled`` (or null) counts the (warp, entry) pairs
// the warps skip.  Returns cudaGetLastError().
extern "C" int la3dm_lv_rows(const float* entries, const float* labels,
                             const int32_t* ids, const int32_t* row_start,
                             const int32_t* row_count, const int32_t* row_tile,
                             const int64_t* tile_rows, const int64_t* apply_order,
                             const int32_t* tile_slot, const int32_t* tile_pos,
                             const float* tile_ctr, const float* vox_base_t,
                             const int8_t* eff, float* A, float* B, uint8_t* touched,
                             float* rows_y, float* rows_k, unsigned long long* culled,
                             long long t0, long long Tc, long long r0, long long Rc,
                             int cap, int tpb, int Vt, float sf2, float ell, float free_res,
                             float gate, void* stream) {
  if (Tc <= 0 || t0 < 0 || r0 < 0 || Rc < 0 || Vt <= 0 || Vt > kMaxVt || tpb <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long units = Rc * ((Vt + 31) / 32);
  if (units > 0) {
    lv_rows_acc_kernel<<<(unsigned)((units + kWarps - 1) / kWarps), 32 * kWarps, 0, s>>>(
        entries, labels, ids, row_start, row_count, row_tile, tile_slot, tile_pos, tile_ctr,
        vox_base_t, rows_y, rows_k, culled, r0, units, cap, Vt, sf2, ell, free_res);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  const int threads = ((Vt + 31) / 32) * 32;
  lv_rows_apply_kernel<<<(unsigned)Tc, threads, 0, s>>>(apply_order, tile_rows, tile_slot,
                                                        tile_pos, rows_y, rows_k, eff, A, B,
                                                        touched, t0, Tc, r0, cap, tpb, Vt,
                                                        gate);
  return (int)cudaGetLastError();
}
