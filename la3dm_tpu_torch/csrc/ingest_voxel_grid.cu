// K7v — the server's pre-downsample (PCL's VoxelGrid) on the card,
// hand-written for Hopper (sm_90a).
//
// Replaces no JAX kernel: the JAX OnlineIntegrator downsamples each raw
// cloud on the host (la3dm_tpu/pipeline.py, geometry/preprocess.py::
// voxel_downsample, a numpy lexsort and reduceat), and so did the port.  On
// the card the cloud's centroids stay there and go straight into device
// ingest.  The output is bit-equal to preprocess.voxel_downsample:
//   cell      floor(p * inv) per axis in float32 (inv = float32(1 / leaf),
//             taken in float64 on the host, as numpy takes it);
//   order     the cells z-major, x fastest (np.lexsort((x, y, z))), the
//             points of a cell in the cloud's order (both sorts stable);
//   sum       a cell's points in float64 as np.add.reduceat sums them: the
//             first point, plus numpy's pairwise_sum of the rest (under 8
//             values: a running sum from -0.0; up to 128: eight running
//             sums, a stride of 8 apart, combined as ((r0 + r1) + (r2 + r3))
//             + ((r4 + r5) + (r6 + r7)), then the tail; above 128: the two
//             halves, the first of n / 2 rounded down to a multiple of 8);
//   centroid  (float)(sum / (double)count).
// Three steps on the stream, nothing waits between them
// (kernels/ingest_voxel_grid.py):
//   keys    one thread a point: its cell as a K7s key (ingest_keys.cuh's
//           layout, scan 0) round the anchor cell, in K7s's one-scan window
//           of radius ``radius``; a point that is not finite, or whose cell
//           lies outside the window, gets the sentinel, which K7s leaves out
//           of the runs, so that its cell is left out of the centroids (the
//           caller makes sure device ingest would drop that cell's centroid
//           by range: kernels/ingest_voxel_grid.py);
//   sort    one K7s sort of the keys (csrc/ingest_sort.cu): the stable sort
//           index and the runs, their count in K7s's status words;
//   reduce  one lane a run: numpy's pairwise tree walked in order, each
//           leaf's sum in the lane's registers (its loads eight at a time),
//           the left halves' sums on a small stack.  In the benchmark's city
//           block at a 0.5 m leaf, 5 of 1,020,722 cells in 120 scans hold
//           more than a leaf's 129 points, at most 170, so a lane a run
//           keeps the warps even.  The run count is read on the card
//           (status[1]), so the grid covers every point.
// What bounds it: bytes — 12 bytes a point in, 12 a centroid out, K7s's
// passes between — under a microsecond at a VLP-16 cloud (28,800 points).
// What holds it back is launches: the keys, K7s's (a memset, a histogram,
// four passes and the run cut above 4096 points) and the reduce, about 2-3
// us of the card each; the host waits once, for K7s's status.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ingest_keys.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kLeaf = 128;  // numpy's PW_BLOCKSIZE: a pairwise leaf's most values
constexpr int kDepth = 32;      // pairwise levels of a run of under 2^30 points: at most 25

__global__ void __launch_bounds__(kThreads)
ingest_voxel_grid_keys_kernel(const float* __restrict__ pts,  // [N,3]
                              int64_t N, float inv, int64_t ax, int64_t ay, int64_t az,
                              int radius, int64_t* __restrict__ keys) {  // [N]
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const int64_t a[3] = {ax, ay, az};
  int64_t f[3];
  bool ok = true;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float c = floorf(pts[3 * i + d] * inv);
    // not finite, or beyond int64's reach: no key (NaN fails the compare)
    if (!(fabsf(c) < 2147483648.0f)) {
      ok = false;
      f[d] = 0;
    } else {
      f[d] = (int64_t)c - a[d];
      ok = ok && f[d] >= -radius && f[d] <= radius;
    }
  }
  keys[i] = ok ? ((f[2] + kFieldBias) << 32) | ((f[1] + kFieldBias) << 16) | (f[0] + kFieldBias)
               : kSentinel;
}

struct D3 {
  double x, y, z;
};

__device__ __forceinline__ D3 load(const float* __restrict__ pts, int64_t p) {
  return {(double)pts[3 * p + 0], (double)pts[3 * p + 1], (double)pts[3 * p + 2]};
}

__device__ __forceinline__ D3 add(D3 a, D3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }

// numpy's pairwise_sum of the n <= kLeaf values at sorted rows lo .. lo + n - 1,
// in one lane
__device__ D3 lane_leaf(const float* __restrict__ pts, const int64_t* __restrict__ perm,
                        int64_t lo, int64_t n) {
  if (n < 8) {
    D3 r = {-0.0, -0.0, -0.0};
    for (int64_t i = 0; i < n; ++i) r = add(r, load(pts, perm[lo + i]));
    return r;
  }
  D3 r[8];
  int64_t p[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) p[j] = perm[lo + j];
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = load(pts, p[j]);
  const int64_t full = n - n % 8;
  for (int64_t i = 8; i < full; i += 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j) p[j] = perm[lo + i + j];
    D3 v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = load(pts, p[j]);
#pragma unroll
    for (int j = 0; j < 8; ++j) r[j] = add(r[j], v[j]);
  }
  D3 s = add(add(add(r[0], r[1]), add(r[2], r[3])), add(add(r[4], r[5]), add(r[6], r[7])));
  for (int64_t i = full; i < n; ++i) s = add(s, load(pts, perm[lo + i]));
  return s;
}

// numpy's pairwise_sum of the n values at sorted rows lo .. lo + n - 1, in
// one lane: the tree walked in order, each leaf by lane_leaf, the left
// halves' sums on a stack while their right halves are summed
__device__ D3 lane_pairwise(const float* __restrict__ pts, const int64_t* __restrict__ perm,
                            int64_t lo, int64_t n) {
  int64_t rlo[kDepth], rn[kDepth];
  D3 left[kDepth];
  bool summed[kDepth];  // the left half's sum is on the stack
  int sp = 0;
  for (;;) {
    while (n > kLeaf) {  // descend to the leftmost leaf, pushing the right halves
      int64_t n2 = n / 2;
      n2 -= n2 % 8;
      rlo[sp] = lo + n2;
      rn[sp] = n - n2;
      summed[sp] = false;
      ++sp;
      n = n2;
    }
    D3 acc = lane_leaf(pts, perm, lo, n);
    while (sp > 0 && summed[sp - 1]) {  // acc is a right half: add it to its left
      acc = add(left[sp - 1], acc);
      --sp;
    }
    if (sp == 0) return acc;
    left[sp - 1] = acc;  // acc is a left half: keep it, do the right
    summed[sp - 1] = true;
    lo = rlo[sp - 1];
    n = rn[sp - 1];
  }
}

__global__ void __launch_bounds__(kThreads)
ingest_voxel_grid_reduce_kernel(const float* __restrict__ pts,       // [N,3]
                                const int64_t* __restrict__ perm,    // [>= V]
                                const int64_t* __restrict__ starts,  // [>= R]
                                const int64_t* __restrict__ counts,  // [>= R]
                                const int32_t* __restrict__ status,  // K7s's: V, R, ...
                                float* __restrict__ cent) {          // [>= R,3]
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= (int64_t)status[1]) return;
  const int64_t st = starts[r], n = counts[r];
  // the first point, plus the pairwise sum of the rest (np.add.reduceat)
  const D3 s = add(load(pts, perm[st]), lane_pairwise(pts, perm, st + 1, n - 1));
  const double c = (double)n;
  cent[3 * r + 0] = (float)(s.x / c);
  cent[3 * r + 1] = (float)(s.y / c);
  cent[3 * r + 2] = (float)(s.z / c);
}

}  // namespace

// Launch K7v's key kernel on ``stream``: N >= 1 points, the anchor cell (ax,
// ay, az), K7s's one-scan window of ``radius`` cells.  Returns
// cudaGetLastError().
extern "C" int la3dm_ingest_voxel_grid_keys(const float* pts, long long N, float inv,
                                            long long ax, long long ay, long long az,
                                            int radius, int64_t* keys, void* stream) {
  if (N <= 0 || N >= (1LL << 30) || radius < 0 || radius >= kFieldBias)
    return (int)cudaErrorInvalidValue;
  const long long grid = (N + kThreads - 1) / kThreads;
  ingest_voxel_grid_keys_kernel<<<(unsigned)grid, kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      pts, N, inv, ax, ay, az, radius, keys);
  return (int)cudaGetLastError();
}

// Launch K7v's reduce on ``stream`` over the runs of a K7s sort of N >= 1
// keys (perm, starts and counts its output rows, status its status words,
// read on the card).  Returns cudaGetLastError().
extern "C" int la3dm_ingest_voxel_grid_reduce(const float* pts, const int64_t* perm,
                                              const int64_t* starts, const int64_t* counts,
                                              const int32_t* status, long long N, float* cent,
                                              void* stream) {
  if (N <= 0 || N >= (1LL << 30)) return (int)cudaErrorInvalidValue;
  const long long grid = (N + kThreads - 1) / kThreads;
  ingest_voxel_grid_reduce_kernel<<<(unsigned)grid, kThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
      pts, perm, starts, counts, status, cent);
  return (int)cudaGetLastError();
}
