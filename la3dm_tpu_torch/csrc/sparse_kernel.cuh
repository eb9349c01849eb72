// The BGK sparse kernel of one normalised distance, shared by the heavy
// passes K1 (bgk_heavy.cu) and K1' (bgk_aligned_heavy.cu), in point mode
// (from the squared distance) and in segment mode (from r = d / ell).
//
// Parity with la3dm_tpu/kernels/math.py::sparse_kernel:
//   k = ((2 + cos 2*pi*r) * (1 - r) / 3 + sin(2*pi*r) / (2*pi)) * sf2,
// clamped at 0, with r = sqrt(d2), full-precision sinf/cosf and
// TWO_PI = float32(2 * 3.1415926).  Built with --fmad=false, so every
// product and sum rounds as the plain PyTorch version's separate ops round.
#pragma once

constexpr float kTwoPi = 0x1.921fb4p+2f;   // float32(2 * 3.1415926)

__device__ __forceinline__ float sparse_kernel_r(float rr, float sf2) {
  const float a = kTwoPi * rr;
  const float k = ((2.0f + cosf(a)) * (1.0f - rr) / 3.0f + sinf(a) / kTwoPi) * sf2;
  return fmaxf(k, 0.0f);
}

__device__ __forceinline__ float sparse_kernel_d2(float d2, float sf2) {
  return sparse_kernel_r(sqrtf(d2), sf2);
}

// ((dx*dx) + dy*dy) + dz*dz, the per-axis order of pairwise_dist
__device__ __forceinline__ float dist2(float dx, float dy, float dz) {
  float d2 = dx * dx;
  d2 = d2 + dy * dy;
  d2 = d2 + dz * dz;
  return d2;
}
