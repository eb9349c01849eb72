// K6 — the device DDA of raycast, hand-written for Hopper (sm_90a).
//
// Replaces la3dm_tpu/models/raycast.py::_raycast_loop (lines 145-215):
// Amanatides-Woo stepping of each ray over the base-resolution voxel grid,
// reading each voxel's state through an open-addressing block-coord ->
// pool-slot hash and the int8 state table [cap+1, V] (raster order; row cap
// is the UNKNOWN guard of absent blocks).
//
// Design:
// * One thread per ray.  The JAX step runs every ray in lockstep for
//   max_steps iterations; a stopped ray changes nothing after, so the
//   thread leaves at its first hit or once t > max_range, with the same
//   hit, dist and steps.  One iteration keeps the JAX order: the current
//   voxel's state is checked, then the ray steps along the axis of the
//   smallest t_max (ties to the lowest axis, jnp.argmin's rule), so the
//   voxel reached by the last step is never checked.
// * The state lookup (state_at): p = idx * res (the voxel centre),
//   blk = floor(p / bs + 0.5), the 30-bit hi / lo split of blk + 524288,
//   the hash ((hi * HC1) ^ (lo * HC2)) & (H - 1) computed in uint32 (it
//   wraps in 32 bits, and signed overflow is undefined in C++), then
//   max_probes linear probes with the JAX rule (stop at a match or an
//   empty entry, hi == -1), and the local index
//   trunc((p - blk * bs) / res + n / 2) clipped to [0, n - 1].
// * Parity: every operation is the JAX step's f32 operation in its order
//   (divisions, not reciprocals; t_max += t_delta in f32; tiny = |d| <
//   1e-12 gives t_max = inf).  Built with --fmad=false.
// * What bounds it: the operations of the lookups, steps and hash probes
//   the rays take (about 55 a lookup and step, 5 a probe) on the CUDA
//   cores.  The bytes that must move are the tables once (a few MB, which
//   stay in L2) and the rays' 24 in and 9 out.  Rays of one warp diverge in
//   their step counts and probe chains; the warp runs as long as its
//   longest ray.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr uint32_t kHC1 = 2654435769u;   // int32 -1640531527
constexpr uint32_t kHC2 = 3432918353u;   // int32 -862048943
constexpr int kKB = 524288;

__global__ void raycast_kernel(const int8_t* __restrict__ state_tab,   // [cap+1,V]
                               const int32_t* __restrict__ tab_hi,     // [H]
                               const int32_t* __restrict__ tab_lo,     // [H]
                               const int32_t* __restrict__ tab_slot,   // [H]
                               const float* __restrict__ origins,      // [N,3]
                               const float* __restrict__ dirs,         // [N,3]
                               int64_t N, int cap, int H, int n, int max_steps,
                               int target, int max_probes, float res, float bs,
                               float max_range, bool* __restrict__ hit_out,
                               float* __restrict__ dist_out,
                               int32_t* __restrict__ steps_out) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= N) return;
  const int V = n * n * n;
  const float half_n = (float)n / 2.0f;
  const uint32_t hmask = (uint32_t)(H - 1);

  int idx[3], step[3];
  float t_max[3], t_delta[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float o = origins[3 * r + a];
    const float d = dirs[3 * r + a];
    idx[a] = (int)floorf(o / res + 0.5f);
    step[a] = d > 0.0f ? 1 : -1;
    const bool tiny = fabsf(d) < 1e-12f;
    const float safe_d = tiny ? 1e-12f : d;
    const float bound = (float)(idx[a] + (step[a] > 0 ? 1 : 0)) * res - res / 2.0f;
    t_max[a] = tiny ? CUDART_INF_F : (bound - o) / safe_d;
    t_delta[a] = fabsf(res / safe_d);
  }

  float t = 0.0f;
  bool hit = false;
  float dist = CUDART_INF_F;
  int steps = 0;
  for (int it = 0; it < max_steps; ++it) {
    // the state of the current voxel
    float p[3];
    int blk[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      p[a] = (float)idx[a] * res;
      blk[a] = (int)floorf(p[a] / bs + 0.5f);
    }
    const int c0 = blk[0] + kKB, c1 = blk[1] + kKB, c2 = blk[2] + kKB;
    // (the left shift through uint32: a negative field is defined there)
    const int32_t hi = (int32_t)((uint32_t)c0 << 10) | (c1 >> 10);
    const int32_t lo = ((c1 & 1023) << 20) | c2;
    const uint32_t h = (((uint32_t)hi * kHC1) ^ ((uint32_t)lo * kHC2)) & hmask;
    int slot = cap;
    for (int j = 0; j < max_probes; ++j) {
      const uint32_t pos = (h + (uint32_t)j) & hmask;
      const int32_t th = tab_hi[pos];
      if (th == hi && tab_lo[pos] == lo) {
        slot = tab_slot[pos];
        break;
      }
      if (th == -1) break;
    }
    int vi = 0;
    int mul = 1;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float ctr = (float)blk[a] * bs;
      int v = (int)((p[a] - ctr) / res + half_n);
      v = v < 0 ? 0 : (v > n - 1 ? n - 1 : v);
      vi += v * mul;
      mul *= n;
    }
    const int row = slot < cap ? slot : cap;
    if ((int)state_tab[(size_t)row * V + vi] == target) {
      hit = true;
      dist = t;
      break;
    }
    // the step along the axis of the smallest t_max (ties: the lowest)
    int ax = 0;
    if (t_max[1] < t_max[ax]) ax = 1;
    if (t_max[2] < t_max[ax]) ax = 2;
    t = t_max[ax];
    idx[ax] += step[ax];
    t_max[ax] = t_max[ax] + t_delta[ax];
    ++steps;
    if (!(t <= max_range)) break;
  }
  hit_out[r] = hit;
  dist_out[r] = dist;
  steps_out[r] = steps;
}

constexpr int kThreads = 128;

}  // namespace

// Launch K6 on ``stream``: one thread per ray.  Returns cudaGetLastError().
extern "C" int la3dm_raycast(const int8_t* state_tab, const int32_t* tab_hi,
                             const int32_t* tab_lo, const int32_t* tab_slot,
                             const float* origins, const float* dirs, long long N, int cap,
                             int H, int n, int max_steps, int target, int max_probes,
                             float res, float bs, float max_range, bool* hit, float* dist,
                             int32_t* steps, void* stream) {
  if (N <= 0 || cap < 0 || H <= 0 || (H & (H - 1)) != 0 || n <= 0)
    return (int)cudaErrorInvalidValue;
  const long long grid = (N + kThreads - 1) / kThreads;
  raycast_kernel<<<(unsigned)grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      state_tab, tab_hi, tab_lo, tab_slot, origins, dirs, N, cap, H, n, max_steps, target,
      max_probes, res, bs, max_range, hit, dist, steps);
  return (int)cudaGetLastError();
}
