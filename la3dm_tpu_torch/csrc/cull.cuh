// Exact warp-level culling, shared by K1's segment branch (bgk_heavy.cu),
// K1' (bgk_aligned_heavy.cu, both branches) and K3 (lv_rows.cu).  The plain
// PyTorch mirror of every function here is in kernels/math.py (pad_box,
// segment_misses_box, warp_cull), which the CPU tests hold against the
// memberships and kernel values they guard.
//
// A warp owns 32 output points (K3: voxel centres, K1 and K1': node
// centres) and walks the same entries.  Everything an entry can contribute
// to a point lies on the entry's segment a -> b (a point entry: a = b):
// * K3: the proxy samples a + n*d (d in [0, |u|]) of the +-ell cube test;
// * K1 and K1': the point-to-segment distance, whose kernel is exactly 0
//   from r = d / ell >= r_c on (bgk_heavy.cu, kernels/bgk_heavy.py::R_CULL);
//   K1''s point branch, see bgk_aligned_heavy.cu for its rounding.
// So where the segment misses the box spanned by the warp's 32 points,
// padded by ell (K3) or r_c*ell (K1, K1'), it contributes exactly nothing
// to any of them and the warp skips it: the sums are those of the full loop.
//
// Rounding never culls a contributor: the box is padded by a further
// margin of 1e-4 * (1 + |x|) per axis, four orders of magnitude above the
// f32 rounding of the kernels' own tests (a few ulp of coordinates under
// 100 m) and of the clip below (a few ulp of t in [0, 1], times |u|).
#pragma once

constexpr float kCullMargin = 1e-4f;

// The box [lo, hi] of one axis padded by ``reach`` and the margin.
__device__ __forceinline__ void pad_box(float lo, float hi, float reach, float& plo,
                                        float& phi) {
  const float m = kCullMargin * (1.0f + fmaxf(fabsf(lo), fabsf(hi)));
  plo = lo - (reach + m);
  phi = hi + (reach + m);
}

// Does the segment a -> a + u (t in [0, 1]) miss the box [plo, phi]?
// Liang-Barsky clipping in f32; an axis with u == 0 tests a alone.
__device__ __forceinline__ bool segment_misses_box(const float a[3], const float u[3],
                                                   const float plo[3],
                                                   const float phi[3]) {
  float t_in = 0.0f, t_out = 1.0f;
  bool miss = false;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    if (u[ax] == 0.0f) {
      miss = miss || !(a[ax] >= plo[ax] && a[ax] <= phi[ax]);
    } else {
      const float t0 = (plo[ax] - a[ax]) / u[ax];
      const float t1 = (phi[ax] - a[ax]) / u[ax];
      t_in = fmaxf(t_in, fminf(t0, t1));
      t_out = fminf(t_out, fmaxf(t0, t1));
    }
  }
  return miss || t_in > t_out;
}

// Does the point a lie outside the box [plo, phi]?  (segment_misses_box
// with u = 0.)
__device__ __forceinline__ bool point_misses_box(const float a[3], const float plo[3],
                                                 const float phi[3]) {
  bool miss = false;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) miss = miss || !(a[ax] >= plo[ax] && a[ax] <= phi[ax]);
  return miss;
}

// The warp's box over its live lanes' points, padded by ``reach``: every
// lane gets the same plo / phi.
__device__ __forceinline__ void warp_box(bool live, float x, float y, float z, float reach,
                                         float plo[3], float phi[3]) {
  float lo[3] = {live ? x : __int_as_float(0x7f800000), live ? y : __int_as_float(0x7f800000),
                 live ? z : __int_as_float(0x7f800000)};
  float hi[3] = {live ? x : -__int_as_float(0x7f800000),
                 live ? y : -__int_as_float(0x7f800000),
                 live ? z : -__int_as_float(0x7f800000)};
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) {
      lo[ax] = fminf(lo[ax], __shfl_xor_sync(0xffffffffu, lo[ax], off));
      hi[ax] = fmaxf(hi[ax], __shfl_xor_sync(0xffffffffu, hi[ax], off));
    }
  }
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) pad_box(lo[ax], hi[ax], reach, plo[ax], phi[ax]);
}
