// K4 — the GP heavy pass, hand-written for Hopper (sm_90a).
//
// Replaces la3dm_tpu/models/gp.py::_gp_heavy (lines 61-116) with
// kernels/gp.py::gp_train_core / gp_predict_core and
// kernels/math.py::cov_matern32: a chunked lax.scan over models padded to S
// points, with a batched XLA Cholesky and triangular solves.
//
// Every block model m with c = counts[m] training points (pts/lab from
// starts[m]) is an exact GP on K = Matern32(d) + noise * I, d = |x_i*s -
// x_j*s| by per-axis subtraction summed x, y, z (kernels/math.py::
// pairwise_dist), s = float32(1.73205 / ell).  For each slot g it serves
// (0 <= nb_rows[m, g] < Tp) and each of the Vall all-level node centres of
// that test block, with Ks_i = Matern32 at |x_i*s - (node + centre)*s|:
//   mean = Ks . alpha = v . z,   var = sf2 - v . v,
//   v = W Ks, z = W y, W = L^-1, K = L L^T,
// stored at row nb*G + g of acc_mean/acc_var [Tp*G, Vall], present = 1.
// Distinct models never share a target row, so plain stores, no atomics.
//
// A tier call runs two phases over all of its models, in chunks whose
// workspace (sum of cp^2 elements: L in f32, W in f64 and W's f32 copy)
// stays under a cap.  Models are padded to cp points (16-multiples up to 64,
// one tile; 64-multiples above) with identity rows, which keeps L and W
// block-diagonal, as the JAX step's far-staggered padding does.
//
// 1. Factor.  The Gram and the query kernel values are f32, as the plain
//    version's; L is stored in f32; every sum runs in f64, and W stays f64.
//    - gp_factor_small (models of at most 32 points): one warp a model,
//      lane i holding row i in registers, shuffles for barriers;
//    - else 64 x 64 tiles, one CTA of 256 threads a tile, one launch a step,
//      so one model's tile work spreads over CTAs:
//      gp_factor_diag (step k): the Gram tile K_kk - sum_l L_kl L_kl^T,
//        factored right-looking in f64 in shared memory, one barrier a
//        column; a pivot that is not > 0 (or NaN) fails the model (mfail,
//        ``failed`` += 1; all its outputs NaN), as LAPACK's test; L_kk
//        rounded to f32, then W_kk = L_kk^-1 in f64, one barrier a row;
//      gp_factor_panel (step k): L_ik = (K_ik - sum_l L_il L_kl^T) W_kk^T;
//      gp_factor_winv (step i): W_ij = -W_ii sum_{k=j}^{i-1} L_ik W_kj;
//      gp_factor_z (one CTA a model): z = W y.
//    The factor's tile products run on the tensor cores as mma.sync m8n8k4 f64
//    (DMMA: 34 TFLOP/s on an H100, half of the f64 tensor peak).  W tiles
//    rounded to f32 inside this recursion lost 5x in the means on real
//    blocks (tools/k4_sum_precision.py --dispatch-every), so W is kept in
//    f64 and only the predict reads an f32 copy.
//    The pivot test thus runs in f64 on the f32 Gram, in every tier, where
//    the plain version and the JAX step factor in f32: a Gram that is
//    singular in f32 fails in both, but one whose f32 factor breaks down
//    on rounding alone (a pivot within f32 rounding of 0) factors here
//    (tests/test_torch_cuda.py::test_gp_heavy_kernel_near_singular_gram).
// 2. Predict, persistent grids over work units taken from an atomic counter
//    (largest models first), each unit over the slots its model serves;
//    V = W Ks by mma.sync m16n8k4 f64 (the full 67 TFLOP/s) on operands
//    converted from f32, each warp's task 16 rows x 16 nodes (row pair P
//    reads W's rows 16P.. over k < 16P + 16: W is lower triangular).
//    - gp_heavy_kernel_warp (a base tier, models of at most 128 points): one
//      warp a unit (model, 16 nodes), Ks [c16 x 16] in its shared memory, no
//      barrier but the warp's; sums over the row pairs in registers;
//    - gp_heavy_kernel (larger): one CTA a unit (model, nq nodes), 8 warps
//      (16 once the chunk's largest model has 256 points), Ks [c16 x nq]
//      in shared memory (a global workspace where 16 nodes do not fit),
//      partial sums per virtual warp in shared memory.
//
// Summation order is fixed: each DMMA chain runs over k in order; a node's
// sums of v^2 and v z take, in each lane, its rows of the row pairs in
// increasing order (in the CTA kernel the row pairs of one virtual warp,
// (P + node group) % 16), then the 8 row lanes in a fixed shuffle tree (then
// the 16 virtual warps in order).  The work counter only decides which CTA
// or warp runs a unit, so two launches give bit-equal tables.
//
// What bounds it on an H100: the predict's f64 tile products, c^2 per query
// column summed over the served slots (flops() in kernels/gp_heavy.py).
// With 16 nodes a task, W (f32) streams from L2 at 1/8 byte a flop (8 TB/s
// at the f64 tensor peak, more than L2 delivers), and each product takes
// f32 -> f64 conversions (16 a clock an SM).  Small models are bound by
// latency instead: per-unit chains of loads and shuffles, and the factor's
// sequential columns.  No TF32 and no Gram-expansion matmul: the BCM
// weights 1/var need the tight parity.  Built with --fmad=false and
// full-precision sqrtf/expf/division.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;  // factor tile edge
constexpr int LD = 68;    // shared row stride of a tile (f32 and f64): conflict-free fragments
constexpr int NTH = 256;  // threads per CTA, every kernel (8 warps: 8 rows each of a tile)
constexpr int SMALL_C = 32;    // models padded to at most this take gp_factor_small
constexpr int SMALL_WARPS = 2;  // warps (models) a CTA of gp_factor_small
constexpr int WIDE_C16 = 256;  // predict units of models this large take 16 warps

__device__ __forceinline__ float matern32(float d, float sf2) {
  return (1.0f + d) * expf(-d) * sf2;
}

__device__ __forceinline__ float dist3(float ax, float ay, float az, float bx,
                                       float by, float bz) {
  const float dx = ax - bx;
  const float dy = ay - by;
  const float dz = az - bz;
  float d2 = dx * dx;
  d2 = d2 + dy * dy;
  d2 = d2 + dz * dz;
  return sqrtf(d2);
}

// d += a * b on one 8 x 8 x 4 f64 tile: lane (g = lane/4, q = lane%4) holds
// A[g][q], B[q][g] and D[g][2q], D[g][2q + 1].  Half of Hopper's f64 tensor
// rate (34 of 67 TFLOP/s on an H100); the factor's tile products use it.
__device__ __forceinline__ void dmma(double (&d)[2], double a, double b) {
  asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};"
      : "+d"(d[0]), "+d"(d[1])
      : "d"(a), "d"(b));
}

// d += a * b on one 16 x 8 x 4 f64 tile (sm_90, the full f64 tensor rate):
// lane (g, q) holds A[g][q], A[g + 8][q] (a0, a1), B[q][g] and D[g][2q],
// D[g][2q + 1], D[g + 8][2q], D[g + 8][2q + 1].
__device__ __forceinline__ void dmma16(double (&d)[4], double a0, double a1, double b) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// acc += A B over one 64-deep tile pair in shared memory (row stride LD):
// warp w owns rows 8w..8w+7, all 64 columns as 8 fragments; acc[t][e] is
// (row 8w + g, column 8t + 2q + e).  B(k, n) = Bs[n][k] when BT, else
// Bs[k][n].
template <bool BT, typename TA, typename TBs>
__device__ __forceinline__ void mma64(double (&acc)[8][2], const TA* As, const TBs* Bs) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, g = lane >> 2, q = lane & 3;
  const TA* ar = As + (8 * w + g) * LD + q;
#pragma unroll 4
  for (int ks = 0; ks < TILE; ks += 4) {
    const double a = (double)ar[ks];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const double b = BT ? (double)Bs[(8 * t + g) * LD + ks + q]
                          : (double)Bs[(ks + q) * LD + 8 * t + g];
      dmma(acc[t], a, b);
    }
  }
}

// the 64 x 64 f32 tile at src (row stride cp) into shared T (row stride LD)
__device__ __forceinline__ void load_tile(float* T, const float* __restrict__ src, int cp) {
  for (int idx = threadIdx.x; idx < TILE * TILE / 4; idx += NTH) {
    const int r = idx >> 4, c4 = (idx & 15) * 4;
    *reinterpret_cast<float4*>(T + r * LD + c4) =
        __ldg(reinterpret_cast<const float4*>(src + (size_t)r * cp + c4));
  }
}

// the 64 x 64 f64 tile at src (row stride cp) into shared T (row stride LD)
__device__ __forceinline__ void load_tile(double* T, const double* __restrict__ src, int cp) {
  for (int idx = threadIdx.x; idx < TILE * TILE / 2; idx += NTH) {
    const int r = idx >> 5, c2 = (idx & 31) * 2;
    *reinterpret_cast<double2*>(T + r * LD + c2) =
        __ldg(reinterpret_cast<const double2*>(src + (size_t)r * cp + c2));
  }
}

// one element of W in f64 (the factor's) and f32 (the predict's copy)
__device__ __forceinline__ void store_w(double* __restrict__ Wd, float* __restrict__ Wf,
                                        size_t at, double v) {
  Wd[at] = v;
  Wf[at] = (float)v;
}

struct Model {
  int m, cp;
  size_t woff, zoff;
};

__device__ __forceinline__ Model model_of(const int32_t* __restrict__ minfo, int lm) {
  const int32_t* mi = minfo + 4 * lm;
  return {mi[0], mi[1], (size_t)(uint32_t)mi[2], (size_t)(uint32_t)mi[3]};
}

// scaled coordinates of points [first, first + n) of model (st, c) into p*
__device__ __forceinline__ void load_points(const float* __restrict__ pts, int st, int c,
                                            int first, int n, float s, float* px,
                                            float* py, float* pz) {
  for (int i = threadIdx.x; i < n; i += NTH) {
    const int gi = first + i;
    if (gi < c) {
      px[i] = pts[3 * (size_t)(st + gi) + 0] * s;
      py[i] = pts[3 * (size_t)(st + gi) + 1] * s;
      pz[i] = pts[3 * (size_t)(st + gi) + 2] * s;
    }
  }
}

// x summed over the 8 row lanes (g) of a fragment column, in a fixed tree:
// every lane of the column gets the same bits (a + b == b + a)
__device__ __forceinline__ double reduce_rows(double x) {
  x = x + __shfl_xor_sync(0xffffffffu, x, 4);
  x = x + __shfl_xor_sync(0xffffffffu, x, 8);
  return x + __shfl_xor_sync(0xffffffffu, x, 16);
}

// ---------------------------------------------------------------- factor

__global__ void __launch_bounds__(NTH)
    gp_factor_diag(const float* __restrict__ pts, const int32_t* __restrict__ starts,
                   const int32_t* __restrict__ counts, const int32_t* __restrict__ minfo,
                   int k, const float* __restrict__ Lw, double* __restrict__ Wd,
                   float* __restrict__ Wf,
                   int32_t* __restrict__ mfail, int32_t* __restrict__ failed, float s,
                   float sf2, float noise) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* A = reinterpret_cast<double*>(smem);         // [TILE][LD] f64
  float* T = reinterpret_cast<float*>(A + TILE * LD);  // [TILE][LD] f32
  __shared__ float px[TILE], py[TILE], pz[TILE];
  const int tid = threadIdx.x;
  const int lm = blockIdx.x;  // the models of more than k tiles, a prefix
  if (mfail[lm]) return;
  const Model md = model_of(minfo, lm);
  const int c = counts[md.m], st = starts[md.m], cp = md.cp;
  const int n = min(TILE, cp);  // the tile edge (cp itself for a one-tile model)
  const int r0 = TILE * k;
  load_points(pts, st, c, r0, n, s, px, py, pz);
  __syncthreads();
  // 16 x 16 threads over the tile's lower triangle (no division by n)
  const int ty = tid >> 4, tx = tid & 15;
  for (int i = ty; i < n; i += 16) {
    for (int j = tx; j <= i; j += 16) {
      double v = (i == j) ? 1.0 : 0.0;  // identity on the padding
      if (r0 + i < c && r0 + j < c) {
        float kv = matern32(dist3(px[i], py[i], pz[i], px[j], py[j], pz[j]), sf2);
        if (i == j) kv = kv + noise;
        v = (double)kv;
      }
      A[i * LD + j] = v;
    }
  }
  if (k > 0) {  // n == TILE: subtract sum_l L_kl L_kl^T
    double acc[8][2] = {};
    for (int l = 0; l < k; ++l) {
      __syncthreads();
      load_tile(T, Lw + md.woff + (size_t)r0 * cp + TILE * l, cp);
      __syncthreads();
      mma64<true>(acc, T, T);
    }
    const int lane = tid & 31, w = tid >> 5, g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int t = 0; t < 8; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        double* a = A + (8 * w + g) * LD + 8 * t + 2 * q + e;
        *a = *a - acc[t][e];
      }
  }
  __syncthreads();
  // right-looking Cholesky of the tile in f64, one barrier a column: step j
  // applies column j (final) to the trailing matrix, and the threads that
  // finish column j + 1 scale it at once by its pivot, which every thread
  // computes alike from the values before the step; the diagonal goes to
  // dia[] (the trailing A[j+1][j+1] is read by all during the step)
  // (scaled by the pivot's reciprocal: a division would sit on every
  // step's critical path)
  __shared__ double dia[TILE], rdia[TILE];
  bool ok = true;
  {
    const double piv = A[0];
    ok = piv > 0.0;  // uniform: every thread read the same value (NaN fails)
    if (ok) {
      const double d = sqrt(piv), rd = 1.0 / d;
      for (int i = 1 + tid; i < n; i += NTH) A[i * LD] = A[i * LD] * rd;
      if (tid == 0) dia[0] = d;
    }
    __syncthreads();
  }
  for (int j = 0; ok && j + 1 < n; ++j) {
    const double lj = A[(j + 1) * LD + j];
    const double piv = A[(j + 1) * LD + j + 1] - lj * lj;
    if (!(piv > 0.0)) {
      ok = false;
      break;
    }
    const double d = sqrt(piv), rd = 1.0 / d;
    for (int i = j + 1 + ty; i < n; i += 16)
      for (int q2 = j + 1 + tx; q2 <= i; q2 += 16) {
        double a = A[i * LD + q2] - A[i * LD + j] * A[q2 * LD + j];
        if (q2 == j + 1) {
          if (i == j + 1) {
            dia[i] = d;
            continue;
          }
          a = a * rd;
        }
        A[i * LD + q2] = a;
      }
    __syncthreads();
  }
  if (!ok) {
    if (tid == 0) {
      mfail[lm] = 1;
      atomicAdd(failed, 1);
    }
    return;
  }
  // L_kk rounded to f32 (zeros above the diagonal); A becomes the identity
  for (int i = ty; i < n; i += 16)
    for (int j = tx; j < n; j += 16) {
      T[i * LD + j] = j < i ? (float)A[i * LD + j] : j == i ? (float)dia[i] : 0.0f;
      A[i * LD + j] = j == i ? 1.0 : 0.0;
    }
  for (int i = tid; i < n; i += NTH) rdia[i] = 1.0 / (double)(float)dia[i];
  __syncthreads();
  // W_kk = L_kk^-1 in f64, right-looking over the rows of A, one barrier a
  // row: step j subtracts L_ij W_j from the rows below, and the threads
  // that finish row j + 1 scale it by 1 / L_(j+1)(j+1) at once (each W_iq
  // sums its terms in increasing order of the column of L)
  if (tid == 0) A[0] = rdia[0];
  __syncthreads();
  for (int j = 0; j + 1 < n; ++j) {
    for (int i = j + 1 + ty; i < n; i += 16)
      for (int q2 = tx; q2 <= j; q2 += 16) {
        double a = A[i * LD + q2] - (double)T[i * LD + j] * A[j * LD + q2];
        if (i == j + 1) a = a * rdia[i];
        A[i * LD + q2] = a;
      }
    if (tid == 0) A[(j + 1) * LD + j + 1] = rdia[j + 1];
    __syncthreads();
  }
  const size_t at = md.woff + (size_t)r0 * cp + r0;
  for (int i = ty; i < n; i += 16)
    for (int j = tx; j < n; j += 16)
      store_w(Wd, Wf, at + (size_t)i * cp + j, j <= i ? A[i * LD + j] : 0.0);
}

__global__ void __launch_bounds__(NTH)
    gp_factor_panel(const float* __restrict__ pts, const int32_t* __restrict__ starts,
                    const int32_t* __restrict__ counts, const int32_t* __restrict__ minfo,
                    const int32_t* __restrict__ items, int k, float* __restrict__ Lw,
                    const double* __restrict__ Wd, const int32_t* __restrict__ mfail,
                    float s, float sf2) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* A = reinterpret_cast<double*>(smem);          // [TILE][LD] f64
  float* T1 = reinterpret_cast<float*>(A + TILE * LD);  // [TILE][LD] f32
  float* T2 = T1 + TILE * LD;                           // [TILE][LD] f32
  __shared__ float px[TILE], py[TILE], pz[TILE], qx[TILE], qy[TILE], qz[TILE];
  const int tid = threadIdx.x;
  const int lm = items[2 * blockIdx.x], ti = items[2 * blockIdx.x + 1];
  if (mfail[lm]) return;
  const Model md = model_of(minfo, lm);
  const int c = counts[md.m], st = starts[md.m], cp = md.cp;
  const int r0 = TILE * ti, c0 = TILE * k;
  load_points(pts, st, c, r0, TILE, s, px, py, pz);
  load_points(pts, st, c, c0, TILE, s, qx, qy, qz);
  __syncthreads();
  for (int idx = tid; idx < TILE * TILE; idx += NTH) {
    const int i = idx >> 6, j = idx & 63;
    double v = 0.0;
    if (r0 + i < c && c0 + j < c)
      v = (double)matern32(dist3(px[i], py[i], pz[i], qx[j], qy[j], qz[j]), sf2);
    A[i * LD + j] = v;
  }
  double acc[8][2] = {};
  for (int l = 0; l < k; ++l) {  // sum_l L_il L_kl^T
    __syncthreads();
    load_tile(T1, Lw + md.woff + (size_t)r0 * cp + TILE * l, cp);
    load_tile(T2, Lw + md.woff + (size_t)c0 * cp + TILE * l, cp);
    __syncthreads();
    mma64<true>(acc, T1, T2);
  }
  __syncthreads();
  const int lane = tid & 31, w = tid >> 5, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      double* a = A + (8 * w + g) * LD + 8 * t + 2 * q + e;
      *a = *a - acc[t][e];
    }
  double* TW = reinterpret_cast<double*>(T1);  // T1 and T2 hold one f64 tile
  load_tile(TW, Wd + md.woff + (size_t)c0 * cp + c0, cp);  // W_kk
  __syncthreads();
  double out[8][2] = {};
  mma64<true>(out, A, TW);  // R W_kk^T
  float* Ld = Lw + md.woff + (size_t)(r0 + 8 * w + g) * cp + c0;
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 2; ++e) Ld[8 * t + 2 * q + e] = (float)out[t][e];
}

__global__ void __launch_bounds__(NTH)
    gp_factor_winv(const int32_t* __restrict__ minfo, int ti, const float* __restrict__ Lw,
                   double* __restrict__ Wd,
                   float* __restrict__ Wf, const int32_t* __restrict__ mfail) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* A = reinterpret_cast<double*>(smem);  // [TILE][LD] f64
  double* T2 = A + TILE * LD;                   // [TILE][LD] f64: W_kj, then W_ii
  float* T1 = reinterpret_cast<float*>(T2 + TILE * LD);  // [TILE][LD] f32: L_ik
  const int tid = threadIdx.x;
  const int lm = blockIdx.x / ti, tj = blockIdx.x - (blockIdx.x / ti) * ti;
  if (mfail[lm]) return;
  const Model md = model_of(minfo, lm);
  const int cp = md.cp;
  const int r0 = TILE * ti, c0 = TILE * tj;
  double acc[8][2] = {};
  for (int kk = tj; kk < ti; ++kk) {  // sum_k L_ik W_kj
    __syncthreads();
    load_tile(T1, Lw + md.woff + (size_t)r0 * cp + TILE * kk, cp);
    load_tile(T2, Wd + md.woff + (size_t)(TILE * kk) * cp + c0, cp);
    __syncthreads();
    mma64<false>(acc, T1, T2);
  }
  __syncthreads();
  const int lane = tid & 31, w = tid >> 5, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 2; ++e) A[(8 * w + g) * LD + 8 * t + 2 * q + e] = acc[t][e];
  load_tile(T2, Wd + md.woff + (size_t)r0 * cp + r0, cp);  // W_ii
  __syncthreads();
  double out[8][2] = {};
  mma64<false>(out, T2, A);
  const size_t at = md.woff + (size_t)(r0 + 8 * w + g) * cp + c0;
#pragma unroll
  for (int t = 0; t < 8; ++t)
#pragma unroll
    for (int e = 0; e < 2; ++e) store_w(Wd, Wf, at + 8 * t + 2 * q + e, -out[t][e]);
}

__global__ void __launch_bounds__(NTH)
    gp_factor_z(const float* __restrict__ lab, const int32_t* __restrict__ starts,
                const int32_t* __restrict__ counts, const int32_t* __restrict__ minfo,
                const double* __restrict__ Wd, double* __restrict__ zw,
                const int32_t* __restrict__ mfail) {
  const int lm = blockIdx.x;  // one CTA a model, over its row tiles
  if (mfail[lm]) return;
  const Model md = model_of(minfo, lm);
  const int c = counts[md.m], st = starts[md.m], cp = md.cp;
  for (int ti = 0; TILE * ti < cp; ++ti) {
    const int r = threadIdx.x >> 2, part = threadIdx.x & 3, row = TILE * ti + r;
    double sum = 0.0;
    if (row < cp) {
      const double* wr = Wd + md.woff + (size_t)row * cp;
      const int end = min(min(TILE * (ti + 1), cp), c);
      for (int j = part; j < end; j += 4) sum = sum + wr[j] * (double)lab[st + j];
    }
    sum = sum + __shfl_xor_sync(0xffffffffu, sum, 1);
    sum = sum + __shfl_xor_sync(0xffffffffu, sum, 2);
    if (part == 0 && row < cp) zw[md.zoff + row] = sum;
  }
}

// A model of at most SMALL_C points whole in one warp's registers: lane i
// holds row i of the Gram, of L and of W.  The same steps as gp_factor_diag
// (right-looking factor in f64 scaled by the pivot's reciprocal, L rounded
// to f32, W = L^-1 row by row in f64) and gp_factor_z (z = W y, four
// interleaved partial sums), with shuffles for barriers.  CTAs of
// SMALL_WARPS warps: a warp holds about 144 registers a thread.
__global__ void __launch_bounds__(32 * SMALL_WARPS)
    gp_factor_small(const float* __restrict__ pts, const float* __restrict__ lab,
                    const int32_t* __restrict__ starts, const int32_t* __restrict__ counts,
                    const int32_t* __restrict__ minfo, int first, int n_models,
                    double* __restrict__ Wd, float* __restrict__ Wf, double* __restrict__ zw,
                    int32_t* __restrict__ mfail, int32_t* __restrict__ failed, float s,
                    float sf2, float noise) {
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * SMALL_WARPS + (threadIdx.x >> 5);
  if (item >= n_models) return;
  const int lm = first + item;  // the small models, a suffix
  const Model md = model_of(minfo, lm);
  const int c = counts[md.m], st = starts[md.m], n = md.cp;  // n <= SMALL_C
  const unsigned full = 0xffffffffu;
  float px = 0.0f, py = 0.0f, pz = 0.0f;
  if (lane < c) {
    px = pts[3 * (size_t)(st + lane) + 0] * s;
    py = pts[3 * (size_t)(st + lane) + 1] * s;
    pz = pts[3 * (size_t)(st + lane) + 2] * s;
  }
  double a[SMALL_C];
#pragma unroll
  for (int j = 0; j < SMALL_C; ++j) {
    const float qx = __shfl_sync(full, px, j), qy = __shfl_sync(full, py, j),
                qz = __shfl_sync(full, pz, j);
    double v = lane == j ? 1.0 : 0.0;  // identity on the padding
    if (lane < c && j < c && j <= lane) {
      float kv = matern32(dist3(px, py, pz, qx, qy, qz), sf2);
      if (lane == j) kv = kv + noise;
      v = (double)kv;
    }
    a[j] = v;
  }
  bool ok = true;
#pragma unroll
  for (int j = 0; j < SMALL_C; ++j) {
    if (j >= n) break;
    const double piv = __shfl_sync(full, a[j], j);
    if (!(piv > 0.0)) {  // uniform: the same value in every lane
      ok = false;
      break;
    }
    const double d = sqrt(piv), rd = 1.0 / d;
    const double l = lane > j ? a[j] * rd : lane == j ? d : 0.0;
    a[j] = l;
#pragma unroll
    for (int q = j + 1; q < SMALL_C; ++q) {
      const double lq = __shfl_sync(full, l, q);
      a[q] = a[q] - l * lq;
    }
  }
  if (!ok) {
    if (lane == 0) {
      mfail[lm] = 1;
      atomicAdd(failed, 1);
    }
    return;
  }
  // L rounded to f32; W = L^-1 by rows: step j subtracts L_ij W_j from the
  // rows below and row j + 1 is then scaled by 1 / L_(j+1)(j+1)
  float t[SMALL_C];
  double w[SMALL_C];
#pragma unroll
  for (int q = 0; q < SMALL_C; ++q) {
    t[q] = q <= lane ? (float)a[q] : 0.0f;
    w[q] = q == lane ? 1.0 : 0.0;
  }
  double rdia = 1.0;
#pragma unroll
  for (int q = 0; q < SMALL_C; ++q)
    if (q == lane) rdia = 1.0 / (double)t[q];
  if (lane == 0) w[0] = rdia;
#pragma unroll
  for (int j = 0; j + 1 < SMALL_C; ++j) {
    if (j + 1 >= n) break;
#pragma unroll
    for (int q = 0; q <= j; ++q) {
      const double wjq = __shfl_sync(full, w[q], j);
      if (lane > j) {
        double v = w[q] - (double)t[j] * wjq;
        if (lane == j + 1) v = v * rdia;
        w[q] = v;
      }
    }
    if (lane == j + 1) w[j + 1] = rdia;
  }
  // W (zeros above the diagonal) and z = W y
  const size_t at = md.woff + (size_t)lane * n;
  double zs[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
  for (int q = 0; q < SMALL_C; ++q) {
    if (q >= n) break;
    const double wq = q <= lane ? w[q] : 0.0;
    if (lane < n) store_w(Wd, Wf, at + q, wq);
    if (q < c) zs[q & 3] = zs[q & 3] + wq * (double)lab[st + q];
  }
  if (lane < n) zw[md.zoff + lane] = (zs[0] + zs[1]) + (zs[2] + zs[3]);
}

// --------------------------------------------------------------- predict

// virtual warps of the predict's partial sums: the summation order of a
// node's sums depends on this count only, not on the CTA's warps
constexpr int VW = 16;

// A unit's Ks [c16 x nq] is stored in fragment order: float4 slot
// (group * ntq + t) * 32 + lane, lane = g * 4 + q, element e holds row
// i = 16 * group + 4 * q + e, column n = 8 * t + g — the B operand of DMMA e
// over the group's k = 16 * group + 4 * q + e.  A warp's 32 threads write
// 32 consecutive floats.
template <bool KS_SHARED, int NWP>
__global__ void __launch_bounds__(32 * NWP)
    gp_heavy_kernel(const float* __restrict__ pts, const int32_t* __restrict__ starts,
                    const int32_t* __restrict__ counts, const int32_t* __restrict__ nb_rows,
                    const float* __restrict__ centers, const float* __restrict__ all_nodes,
                    const int32_t* __restrict__ minfo, const float* __restrict__ Ww,
                    const double* __restrict__ zw, const int32_t* __restrict__ mfail,
                    int32_t* __restrict__ queue, float* __restrict__ ks_ws,
                    float* __restrict__ acc_mean, float* __restrict__ acc_var,
                    uint8_t* __restrict__ present, int Tp, int G, int Vall, int nq,
                    int n_tiles, int n_models, int c16max, float s, float sf2) {
  constexpr int nth = 32 * NWP;
  extern __shared__ __align__(16) unsigned char smem[];
  double* part = reinterpret_cast<double*>(smem);  // [2][VW][nq]: sum v^2, sum v z
  float* zq = reinterpret_cast<float*>(part + 2 * VW * nq);  // [3][nq] query coordinates
  float* ks = KS_SHARED ? zq + 3 * nq : ks_ws + (size_t)blockIdx.x * c16max * nq;
  const float4* ks4 = reinterpret_cast<const float4*>(ks);
  __shared__ int s_unit[2];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5, g = lane >> 2, q = lane & 3;
  const int ntq = nq >> 3, ng = nq >> 4;
  const int total = n_models * n_tiles;
  const float nan = __int_as_float(0x7fc00000);
  if (tid == 0) s_unit[0] = atomicAdd(queue, 1);
  __syncthreads();
  for (int it = 0, u = s_unit[0]; u < total; ++it) {
    int next = 0;
    if (tid == 0) next = atomicAdd(queue, 1);  // in flight while this unit runs
    const int lm = u / n_tiles, tile = u - (u / n_tiles) * n_tiles;
    const Model md = model_of(minfo, lm);
    const bool failed_m = mfail[lm] != 0;
    const int c = counts[md.m], st = starts[md.m], cp = md.cp;
    const int c16 = (c + 15) & ~15, n_rp = c16 >> 4;
    const int n0 = tile * nq, nn = min(nq, Vall - n0);
    for (int slot = 0; slot < G; ++slot) {
      const int nb = nb_rows[(size_t)md.m * G + slot];
      if (nb < 0 || nb >= Tp) continue;  // the slot serves no test block
      const size_t row = (size_t)nb * G + slot;
      if (tid == 0 && tile == 0) present[row] = 1;
      if (failed_m) {
        for (int n = tid; n < nn; n += nth) {
          acc_mean[row * Vall + n0 + n] = nan;
          acc_var[row * Vall + n0 + n] = nan;
        }
        continue;
      }
      for (int n = tid; n < nq; n += nth) {
        const int v = n0 + min(n, nn - 1);
        zq[n] = (all_nodes[3 * v + 0] + centers[3 * (size_t)nb + 0]) * s;
        zq[nq + n] = (all_nodes[3 * v + 1] + centers[3 * (size_t)nb + 1]) * s;
        zq[2 * nq + n] = (all_nodes[3 * v + 2] + centers[3 * (size_t)nb + 2]) * s;
      }
      for (int idx = tid; idx < 2 * VW * nq; idx += nth) part[idx] = 0.0;
      __syncthreads();
      for (int idx = tid; idx < c16 * nq; idx += nth) {
        const int f = idx >> 2, fo = f >> 5, fl = f & 31;
        const int grp = fo / ntq;
        const int i = 16 * grp + 4 * (fl & 3) + (idx & 3);
        const int n = 8 * (fo - grp * ntq) + (fl >> 2);
        float v = 0.0f;
        if (i < c) {
          const float px = pts[3 * (size_t)(st + i) + 0] * s;
          const float py = pts[3 * (size_t)(st + i) + 1] * s;
          const float pz = pts[3 * (size_t)(st + i) + 2] * s;
          v = matern32(dist3(px, py, pz, zq[n], zq[nq + n], zq[2 * nq + n]), sf2);
        }
        ks[idx] = v;
      }
      __syncthreads();
      // V = W Ks in tasks (row pair P, column group J): task on virtual warp
      // v = (P + jg) % VW, jg = J's group of 16 nodes in the node list, run
      // by warp v % NWP; a virtual warp takes its rows in increasing P, so
      // each node's sums run in one order whatever nq, the chunk, the grid
      // or NWP
      for (int J = 0; J < ng; ++J) {
        const int jg = (n0 >> 4) + J;
        for (int v = w; v < VW; v += NWP) {
          // this lane's rows' v^2 and v z, then one shuffle tree over rows
          double ts[2][2] = {}, tm[2][2] = {};
          for (int P = (v - jg % VW + VW) % VW; P < n_rp; P += VW) {
            const float* w0 = Ww + md.woff + (size_t)(16 * P + g) * cp + 4 * q;
            const float* w1 = w0 + (size_t)8 * cp;
            const double z0 = zw[md.zoff + 16 * P + g], z1 = zw[md.zoff + 16 * P + 8 + g];
            double acc[2][4] = {};  // column tile nt: rows g (0, 1) and g + 8 (2, 3)
            // W's rows, two 16-column groups ahead of the products
            float4 a0 = __ldg(reinterpret_cast<const float4*>(w0));
            float4 a1 = __ldg(reinterpret_cast<const float4*>(w1));
            float4 n0a = a0, n1a = a1;
            if (P >= 1) {
              n0a = __ldg(reinterpret_cast<const float4*>(w0 + 16));
              n1a = __ldg(reinterpret_cast<const float4*>(w1 + 16));
            }
            for (int grp = 0; grp <= P; ++grp) {
              float4 f0 = n0a, f1 = n1a;
              if (grp + 2 <= P) {
                f0 = __ldg(reinterpret_cast<const float4*>(w0 + 16 * (grp + 2)));
                f1 = __ldg(reinterpret_cast<const float4*>(w1 + 16 * (grp + 2)));
              }
              const float4 b0 = ks4[(grp * ntq + 2 * J) * 32 + lane];
              const float4 b1 = ks4[(grp * ntq + 2 * J + 1) * 32 + lane];
              const float av0[4] = {a0.x, a0.y, a0.z, a0.w};
              const float av1[4] = {a1.x, a1.y, a1.z, a1.w};
              const float bv0[4] = {b0.x, b0.y, b0.z, b0.w};
              const float bv1[4] = {b1.x, b1.y, b1.z, b1.w};
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const double x0 = av0[e], x1 = av1[e];
                dmma16(acc[0], x0, x1, (double)bv0[e]);
                dmma16(acc[1], x0, x1, (double)bv1[e]);
              }
              a0 = n0a;
              a1 = n1a;
              n0a = f0;
              n1a = f1;
            }
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const double v0 = acc[nt][e], v1 = acc[nt][2 + e];
                ts[nt][e] = ts[nt][e] + (v0 * v0 + v1 * v1);
                tm[nt][e] = tm[nt][e] + (v0 * z0 + v1 * z1);
              }
          }
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const double ss = reduce_rows(ts[nt][e]), sm = reduce_rows(tm[nt][e]);
              if (g == 0) {
                const int col = 16 * J + 8 * nt + 2 * q + e;
                part[v * nq + col] = ss;
                part[VW * nq + v * nq + col] = sm;
              }
            }
        }
      }
      __syncthreads();
      for (int n = tid; n < nn; n += nth) {
        double ss = 0.0, sm = 0.0;
#pragma unroll
        for (int vv = 0; vv < VW; ++vv) {
          ss = ss + part[vv * nq + n];
          sm = sm + part[VW * nq + vv * nq + n];
        }
        acc_mean[row * Vall + n0 + n] = (float)sm;
        acc_var[row * Vall + n0 + n] = (float)((double)sf2 - ss);
      }
      __syncthreads();
    }
    // the next unit, double-buffered: one barrier a unit
    if (tid == 0) s_unit[(it + 1) & 1] = next;
    __syncthreads();
    u = s_unit[(it + 1) & 1];
  }
}

// The predict for a base tier (models of at most 128 points): one warp a
// work unit (model, tile of 16 query nodes), over the slots the model
// serves, with no barrier but the warp's own.  The warp keeps Ks [c16 x 16]
// in its part of shared memory (fragment order, two column tiles), runs V
// = W Ks row pair by row pair, and sums each node's v^2 and v z over the
// row pairs in increasing order in registers (each lane its rows, then one
// shuffle tree).  At most 85 registers a thread, for three CTAs an SM.
__global__ void __launch_bounds__(NTH, 3)
    gp_heavy_kernel_warp(const float* __restrict__ pts, const int32_t* __restrict__ starts,
                         const int32_t* __restrict__ counts,
                         const int32_t* __restrict__ nb_rows,
                         const float* __restrict__ centers,
                         const float* __restrict__ all_nodes,
                         const int32_t* __restrict__ minfo, const float* __restrict__ Ww,
                         const double* __restrict__ zw, const int32_t* __restrict__ mfail,
                         int32_t* __restrict__ queue, float* __restrict__ acc_mean,
                         float* __restrict__ acc_var, uint8_t* __restrict__ present, int Tp,
                         int G, int Vall, int n_tiles, int n_models, int c16max, float s,
                         float sf2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, g = lane >> 2, q = lane & 3;
  float* ks = reinterpret_cast<float*>(smem) + (size_t)w * (c16max * 16 + 48);
  float* zq = ks + c16max * 16;  // [3][16] query coordinates
  const float4* ks4 = reinterpret_cast<const float4*>(ks);
  const int total = n_models * n_tiles;
  const float nan = __int_as_float(0x7fc00000);
  int u = 0;
  if (lane == 0) u = atomicAdd(queue, 1);
  u = __shfl_sync(0xffffffffu, u, 0);
  while (u < total) {
    int next = 0;
    if (lane == 0) next = atomicAdd(queue, 1);  // in flight while this unit runs
    const int lm = u / n_tiles, tile = u - (u / n_tiles) * n_tiles;
    const Model md = model_of(minfo, lm);
    const bool failed_m = mfail[lm] != 0;
    const int c = counts[md.m], st = starts[md.m], cp = md.cp;
    const int c16 = (c + 15) & ~15, n_rp = c16 >> 4;
    const int n0 = 16 * tile, nn = min(16, Vall - n0);
    for (int slot = 0; slot < G; ++slot) {
      const int nb = nb_rows[(size_t)md.m * G + slot];
      if (nb < 0 || nb >= Tp) continue;  // the slot serves no test block
      const size_t row = (size_t)nb * G + slot;
      if (lane == 0 && tile == 0) present[row] = 1;
      if (failed_m) {
        if (lane < nn) {
          acc_mean[row * Vall + n0 + lane] = nan;
          acc_var[row * Vall + n0 + lane] = nan;
        }
        continue;
      }
      if (lane < 16) {
        const int v = n0 + min(lane, nn - 1);
        zq[lane] = (all_nodes[3 * v + 0] + centers[3 * (size_t)nb + 0]) * s;
        zq[16 + lane] = (all_nodes[3 * v + 1] + centers[3 * (size_t)nb + 1]) * s;
        zq[32 + lane] = (all_nodes[3 * v + 2] + centers[3 * (size_t)nb + 2]) * s;
      }
      __syncwarp();
      for (int idx = lane; idx < c16 * 16; idx += 32) {
        const int f = idx >> 2, fo = f >> 5, fl = f & 31;
        const int i = 16 * (fo >> 1) + 4 * (fl & 3) + (idx & 3);
        const int n = 8 * (fo & 1) + (fl >> 2);
        float v = 0.0f;
        if (i < c) {
          const float px = pts[3 * (size_t)(st + i) + 0] * s;
          const float py = pts[3 * (size_t)(st + i) + 1] * s;
          const float pz = pts[3 * (size_t)(st + i) + 2] * s;
          v = matern32(dist3(px, py, pz, zq[n], zq[16 + n], zq[32 + n]), sf2);
        }
        ks[idx] = v;
      }
      __syncwarp();
      double ts[2][2] = {}, tm[2][2] = {};
      for (int P = 0; P < n_rp; ++P) {
        const float* w0 = Ww + md.woff + (size_t)(16 * P + g) * cp + 4 * q;
        const float* w1 = w0 + (size_t)8 * cp;
        const double z0 = zw[md.zoff + 16 * P + g], z1 = zw[md.zoff + 16 * P + 8 + g];
        double acc[2][4] = {};
        for (int grp = 0; grp <= P; ++grp) {
          const float4 a0 = __ldg(reinterpret_cast<const float4*>(w0 + 16 * grp));
          const float4 a1 = __ldg(reinterpret_cast<const float4*>(w1 + 16 * grp));
          const float4 b0 = ks4[(2 * grp) * 32 + lane];
          const float4 b1 = ks4[(2 * grp + 1) * 32 + lane];
          const float av0[4] = {a0.x, a0.y, a0.z, a0.w};
          const float av1[4] = {a1.x, a1.y, a1.z, a1.w};
          const float bv0[4] = {b0.x, b0.y, b0.z, b0.w};
          const float bv1[4] = {b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const double x0 = av0[e], x1 = av1[e];
            dmma16(acc[0], x0, x1, (double)bv0[e]);
            dmma16(acc[1], x0, x1, (double)bv1[e]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const double v0 = acc[nt][e], v1 = acc[nt][2 + e];
            ts[nt][e] = ts[nt][e] + (v0 * v0 + v1 * v1);
            tm[nt][e] = tm[nt][e] + (v0 * z0 + v1 * z1);
          }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const double ss = reduce_rows(ts[nt][e]), sm = reduce_rows(tm[nt][e]);
          const int col = 8 * nt + 2 * q + e;
          if (g == 0 && col < nn) {
            acc_mean[row * Vall + n0 + col] = (float)sm;
            acc_var[row * Vall + n0 + col] = (float)((double)sf2 - ss);
          }
        }
      __syncwarp();  // the next slot rewrites Ks
    }
    u = __shfl_sync(0xffffffffu, next, 0);
  }
}

template <bool KS_SHARED, int NWP>
cudaError_t launch_predict(size_t smem, int grid_cap, cudaStream_t st, const float* pts,
                           const int32_t* starts, const int32_t* counts,
                           const int32_t* nb_rows, const float* centers,
                           const float* all_nodes, const int32_t* minfo, const float* Ww,
                           const double* zw, const int32_t* mfail, int32_t* queue,
                           float* ks_ws, float* acc_mean, float* acc_var, uint8_t* present,
                           int Tp, int G, int Vall, int nq, int n_tiles, int n_models,
                           int c16max, float s, float sf2) {
  auto fn = gp_heavy_kernel<KS_SHARED, NWP>;
  cudaError_t err =
      cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, 32 * NWP, smem)) !=
      cudaSuccess)
    return err;
  if (per_sm <= 0) return cudaErrorInvalidConfiguration;
  const int grid = per_sm * sms < grid_cap ? per_sm * sms : grid_cap;
  fn<<<grid, 32 * NWP, smem, st>>>(pts, starts, counts, nb_rows, centers, all_nodes, minfo,
                                   Ww, zw, mfail, queue, ks_ws, acc_mean, acc_var, present,
                                   Tp, G, Vall, nq, n_tiles, n_models, c16max, s, sf2);
  return cudaGetLastError();
}

constexpr size_t SMEM_DIAG = TILE * LD * (sizeof(double) + sizeof(float));
constexpr size_t SMEM_PANEL = TILE * LD * (sizeof(double) + 2 * sizeof(float));
constexpr size_t SMEM_WINV = TILE * LD * (2 * sizeof(double) + sizeof(float));

}  // namespace

// K4 for one chunk of one size tier on ``stream``.  ``minfo`` [n_models, 4]
// per model of the chunk (tier index, padded size cp, L/W offset, z
// offset), largest first; ``steps`` (host memory) [n_steps, 4] (phase,
// step, first, count) in launch order, as kernels/gp_heavy.py::
// factor_items makes them, with ``items`` [n, 2] (chunk model, row tile) of
// the panel launches; ``queue``
// one int of scratch.  The predict runs n_models * n_tiles units: with
// ``warp_units`` (a base tier; nq 16) one warp a unit, else one CTA a unit.
// ``ks_ws`` null: each predict CTA keeps its Ks in shared memory (c16max *
// nq floats); else in ks_ws, c16max * nq floats for each of at most
// ``grid_cap`` CTAs.  Returns a CUDA error code (0 on success).
extern "C" int la3dm_gp_heavy(const float* pts, const float* lab, const int32_t* starts,
                              const int32_t* counts, const int32_t* nb_rows,
                              const float* centers, const float* all_nodes,
                              const int32_t* minfo, const int32_t* items,
                              const int32_t* steps, int n_steps, float* Lw, double* Wd,
                              float* Wf, double* zw, int32_t* mfail, int32_t* queue,
                              float* ks_ws,
                              float* acc_mean, float* acc_var, uint8_t* present,
                              int32_t* failed, int Tp, int G, int Vall, int nq, int n_tiles,
                              int n_models, int c16max, int grid_cap, int warp_units, float s,
                              float sf2, float noise, void* stream) {
  if (G <= 0 || Vall <= 0 || nq <= 0 || nq % 16 != 0 || n_tiles <= 0 || n_models <= 0 ||
      c16max <= 0 || c16max % 16 != 0 || grid_cap <= 0 || n_steps < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  err = cudaFuncSetAttribute(gp_factor_diag, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM_DIAG);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(gp_factor_panel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM_PANEL);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(gp_factor_winv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM_WINV);
  if (err != cudaSuccess) return (int)err;
  for (int i = 0; i < n_steps; ++i) {
    const int phase = steps[4 * i], step = steps[4 * i + 1], first = steps[4 * i + 2],
              count = steps[4 * i + 3];
    if (count <= 0) return (int)cudaErrorInvalidValue;
    switch (phase) {
      case 0:
        gp_factor_diag<<<count, NTH, SMEM_DIAG, st>>>(pts, starts, counts, minfo, step, Lw, Wd,
                                                      Wf, mfail, failed, s, sf2, noise);
        break;
      case 1:
        gp_factor_panel<<<count, NTH, SMEM_PANEL, st>>>(pts, starts, counts, minfo,
                                                        items + 2 * (size_t)first, step, Lw,
                                                        Wd, mfail, s, sf2);
        break;
      case 2:
        gp_factor_winv<<<count, NTH, SMEM_WINV, st>>>(minfo, step, Lw, Wd, Wf, mfail);
        break;
      case 3:
        gp_factor_z<<<count, NTH, 0, st>>>(lab, starts, counts, minfo, Wd, zw, mfail);
        break;
      case 4:
        gp_factor_small<<<(count + SMALL_WARPS - 1) / SMALL_WARPS, 32 * SMALL_WARPS, 0, st>>>(
            pts, lab, starts, counts, minfo, first, count, Wd, Wf, zw, mfail, failed, s, sf2,
            noise);
        break;
      default:
        return (int)cudaErrorInvalidValue;
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  err = cudaMemsetAsync(queue, 0, sizeof(int32_t), st);
  if (err != cudaSuccess) return (int)err;
  if (warp_units) {  // a base tier: nq == 16, one warp a unit
    const size_t smem = (size_t)NTH / 32 * (c16max * 16 + 48) * sizeof(float);
    err = cudaFuncSetAttribute(gp_heavy_kernel_warp,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
        cudaSuccess)
      return (int)err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gp_heavy_kernel_warp,
                                                             NTH, smem)) != cudaSuccess)
      return (int)err;
    if (per_sm <= 0 || nq != 16) return (int)cudaErrorInvalidConfiguration;
    const int grid = per_sm * sms < grid_cap ? per_sm * sms : grid_cap;
    gp_heavy_kernel_warp<<<grid, NTH, smem, st>>>(pts, starts, counts, nb_rows, centers,
                                                  all_nodes, minfo, Wf, zw, mfail, queue,
                                                  acc_mean, acc_var, present, Tp, G, Vall,
                                                  n_tiles, n_models, c16max, s, sf2);
    return (int)cudaGetLastError();
  }
  const bool shared = ks_ws == nullptr;
  const size_t smem = (size_t)nq * (2 * VW * sizeof(double) + 3 * sizeof(float)) +
                      (shared ? (size_t)c16max * nq * sizeof(float) : 0);
  // 16 warps for large models: with 8, a scheduler's two warps wait on W
  // from L2
  const bool wide = c16max >= WIDE_C16;
  decltype(&launch_predict<true, 8>) launch =
      shared ? (wide ? launch_predict<true, 16> : launch_predict<true, 8>)
             : (wide ? launch_predict<false, 16> : launch_predict<false, 8>);
  return (int)launch(smem, grid_cap, st, pts, starts, counts, nb_rows, centers, all_nodes,
                     minfo, Wf, zw, mfail, queue, ks_ws, acc_mean, acc_var, present, Tp, G,
                     Vall, nq, n_tiles, n_models, c16max, s, sf2);
}
