// The point-to-segment distance of the segment families, shared by K1 and
// K1' in segment mode (BGKL: bgk_heavy.cu, bgk_aligned_heavy.cu) and K3
// (BGKLV: lv_rows.cu), and the segment entry that K1's and K1''s warps pass
// from lane to lane (Seg).  The callers differ only in the kernel they apply to
// it: BGKL clamps the sparse kernel's output at 0 (sparse_kernel.cuh), LV
// clamps r = d / ell at 1 first.
//
// Parity with la3dm_tpu/kernels/math.py::point_to_segment_dist (the branch
// structure of bgklinference.h:106-141), all in f32:
//   |p1 - p0| < 1e-4   -> |p - p0|
//   c1 = (p - p0).u <= 0 -> |p - p0|
//   c2 = u.u <= c1     -> |p - p1|
//   else               -> |p - (p0 + u * (c1 / max(c2, 1e-30)))|
// with u = p1 - p0, and c1, c2 and each squared distance accumulated x, y, z
// in that order.  Built with --fmad=false: every product and sum rounds as
// the plain PyTorch version's separate operations round.
#pragma once

// The per-segment terms, computed once per segment: u = b - a,
// c2 = u.u and len = sqrt(c2).
struct SegTerms {
  float ux, uy, uz, c2, len;
};

__device__ __forceinline__ SegTerms segment_terms(float ax, float ay, float az, float bx,
                                                  float by, float bz) {
  SegTerms s;
  s.ux = bx - ax;
  s.uy = by - ay;
  s.uz = bz - az;
  float c2 = s.ux * s.ux;
  c2 = c2 + s.uy * s.uy;
  c2 = c2 + s.uz * s.uz;
  s.c2 = c2;
  s.len = sqrtf(c2);
  return s;
}

// |p - segment (a, b)|, with the segment's terms from segment_terms(a, b)
__device__ __forceinline__ float segment_dist(float px, float py, float pz, float ax,
                                              float ay, float az, float bx, float by,
                                              float bz, float ux, float uy, float uz,
                                              float c2, float len) {
  const float d0x = px - ax, d0y = py - ay, d0z = pz - az;
  const float d1x = px - bx, d1y = py - by, d1z = pz - bz;
  float d0sq = d0x * d0x;
  d0sq = d0sq + d0y * d0y;
  d0sq = d0sq + d0z * d0z;
  float d1sq = d1x * d1x;
  d1sq = d1sq + d1y * d1y;
  d1sq = d1sq + d1z * d1z;
  float c1 = d0x * ux;
  c1 = c1 + d0y * uy;
  c1 = c1 + d0z * uz;
  const float bb = c1 / fmaxf(c2, 1e-30f);
  const float mx = px - (ax + ux * bb);
  const float my = py - (ay + uy * bb);
  const float mz = pz - (az + uz * bb);
  float dmsq = mx * mx;
  dmsq = dmsq + my * my;
  dmsq = dmsq + mz * mz;
  float d = c1 <= 0.0f ? sqrtf(d0sq) : (c2 <= c1 ? sqrtf(d1sq) : sqrtf(dmsq));
  if (len < 1e-4f) d = sqrtf(d0sq);
  return d;
}

// One segment entry's terms, as segment_dist reads them, and its label.
struct Seg {
  float a[3], b[3], u[3];
  float c2, len, lab;
};

// The segment e = (start, end) [6] with label ``lab``.
__device__ __forceinline__ Seg seg_load(const float* __restrict__ e, float lab) {
  Seg s;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    s.a[ax] = e[ax];
    s.b[ax] = e[3 + ax];
  }
  const SegTerms tm = segment_terms(e[0], e[1], e[2], e[3], e[4], e[5]);
  s.u[0] = tm.ux;
  s.u[1] = tm.uy;
  s.u[2] = tm.uz;
  s.c2 = tm.c2;
  s.len = tm.len;
  s.lab = lab;
  return s;
}

// Lane ``src``'s segment, to every lane of the (full) warp.
__device__ __forceinline__ Seg seg_shfl(const Seg& x, int src) {
  Seg s;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    s.a[ax] = __shfl_sync(0xffffffffu, x.a[ax], src);
    s.b[ax] = __shfl_sync(0xffffffffu, x.b[ax], src);
    s.u[ax] = __shfl_sync(0xffffffffu, x.u[ax], src);
  }
  s.c2 = __shfl_sync(0xffffffffu, x.c2, src);
  s.len = __shfl_sync(0xffffffffu, x.len, src);
  s.lab = __shfl_sync(0xffffffffu, x.lab, src);
  return s;
}

// |p - s|
__device__ __forceinline__ float seg_dist(float px, float py, float pz, const Seg& s) {
  return segment_dist(px, py, pz, s.a[0], s.a[1], s.a[2], s.b[0], s.b[1], s.b[2], s.u[0],
                      s.u[1], s.u[2], s.c2, s.len);
}
