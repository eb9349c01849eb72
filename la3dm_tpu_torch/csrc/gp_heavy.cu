// K4 — the GP heavy pass, hand-written for Hopper (sm_90a).
//
// Replaces la3dm_tpu/models/gp.py::_gp_heavy (lines 61-116) with
// kernels/gp.py::gp_train_core / gp_predict_core and
// kernels/math.py::cov_matern32: a chunked lax.scan over models padded to S
// points, with a batched XLA Cholesky and triangular solves.
//
// For each block model m with c = counts[m] training points (pts/lab from
// starts[m]), one CTA:
// * scales the points by s = float32(1.73205 / ell) and builds the lower
//   triangle of K = Matern32(d) + noise * I, d = |x_i*s - x_j*s| by per-axis
//   subtraction summed x, y, z (kernels/math.py::pairwise_dist);
// * factors K = L L^T in place (right-looking, column by column); a pivot
//   <= 0 or NaN fails the model: its outputs are NaN, as JAX's Cholesky makes
//   the whole factor NaN, and ``failed`` counts it;
// * solves L z = y, L^T alpha = z;
// * for each of the G slots it serves (nb_rows[m, g] < Tp) and each of the
//   Vall all-level node centres q of that test block: Ks_i = Matern32 at
//   |x_i*s - (node + centre)*s|, mean = sum_i Ks_i alpha_i and
//   var = sf2 - sum_i v_i^2 with v = L^-1 Ks by forward substitution, one
//   query column per thread; and stores them at row nb*G + g of
//   acc_mean/acc_var [Tp*G, Vall], present[nb*G + g] = 1.  Distinct models
//   never share a target row, so plain stores, no atomics.
//
// Padding: JAX pads every model to S with far-staggered points, which makes
// the padded Gram block-diagonal and the padded Ks rows exactly 0; factoring
// only the leading c x c block computes the same numbers, so the kernel works
// on the true c.
//
// Tiers and memory: memory is sized by cmax, the largest c of the launch.
// With cmax <= 128 (the base tier) the factor L [c, c] and the threads' v
// columns [c, blockDim] live in dynamic shared memory (at most 128 KB) and
// the grid is one CTA per model.  Larger cmax (the overflow tier) keeps them
// in a global workspace of ``ws_stride`` floats per CTA (allocated by the
// wrapper), and a grid of at most ``grid`` CTAs walks the models.
//
// Accumulation: the base tier sums in f32 (the sums run over <= 128
// terms).  The overflow tier keeps L and v in f32 but carries the solves
// (alpha in place) and each query's sums (the substitution r, the mean,
// sum v^2) in f64: those sums run over up to c terms, and in f32 they
// part from the exact result by more than the f32 cuSOLVER path does at a
// few thousand points (block_depth 5 models reach about 2,100); the
// factor's own f32 rounding is the smaller part.  The tier is bound by
// its v traffic, not by the f64 arithmetic.
//
// What bounds it: FP32 arithmetic on the CUDA cores — the Gram (c^2/2
// Matern evaluations), the factor (c^3/3 multiply-adds), the two solves
// (c^2) and the predict (Q * (c Matern evaluations + c^2/2 multiply-adds)
// for Q = G * Vall queries).  No tensor cores: neither TF32 nor a
// Gram-expansion matmul keeps the tight parity the BCM weights 1/var need.
// Built with --fmad=false and full-precision sqrtf/expf/division.  This
// first design is simple: the factor and the forward substitutions read L
// from shared (base tier) or global memory once per multiply-add.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <typename Acc>  // float (base tier) or double (overflow tier)
__global__ void gp_heavy_kernel(const float* __restrict__ pts,       // [N,3]
                                const float* __restrict__ lab,       // [N]
                                const int32_t* __restrict__ starts,  // [M]
                                const int32_t* __restrict__ counts,  // [M]
                                const int32_t* __restrict__ nb_rows, // [M,G]
                                const float* __restrict__ centers,   // [Tp,3]
                                const float* __restrict__ all_nodes, // [Vall,3]
                                float* __restrict__ ws,  // null: shared memory
                                size_t ws_stride, int M, int Tp, int G, int Vall,
                                int cmax, float s, float sf2, float noise,
                                float* __restrict__ acc_mean,        // [Tp*G,Vall]
                                float* __restrict__ acc_var,         // [Tp*G,Vall]
                                uint8_t* __restrict__ present,       // [Tp*G]
                                int32_t* __restrict__ failed) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_fail;
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  Acc* a = reinterpret_cast<Acc*>(smem);  // in place: y -> z -> alpha
  float* px = reinterpret_cast<float*>(a + cmax);  // scaled training points
  float* py = px + cmax;
  float* pz = py + cmax;
  float* Lm = ws != nullptr ? ws + (size_t)blockIdx.x * ws_stride : pz + cmax;
  const float nan = __int_as_float(0x7fc00000);
  const int Q = G * Vall;

  for (int m = blockIdx.x; m < M; m += gridDim.x) {
    const int c = counts[m];
    const int st = starts[m];
    float* Vw = Lm + (size_t)c * c;  // thread tid's v column: Vw[k * nt + tid]
    __syncthreads();  // the previous model is done with the shared arrays
    for (int i = tid; i < c; i += nt) {
      px[i] = pts[3 * (size_t)(st + i) + 0] * s;
      py[i] = pts[3 * (size_t)(st + i) + 1] * s;
      pz[i] = pts[3 * (size_t)(st + i) + 2] * s;
      a[i] = lab[st + i];
    }
    if (tid == 0) s_fail = 0;
    __syncthreads();

    // Gram, lower triangle with the diagonal
    for (int idx = tid; idx < c * c; idx += nt) {
      const int i = idx / c, j = idx % c;
      if (j > i) continue;
      float k = matern32(dist3(px[i], py[i], pz[i], px[j], py[j], pz[j]), sf2);
      if (i == j) k = k + noise;
      Lm[(size_t)i * c + j] = k;
    }
    __syncthreads();

    // Cholesky in place, column k: pivot, scale, trailing update
    for (int k = 0; k < c; ++k) {
      if (tid == 0) {
        const float piv = Lm[(size_t)k * c + k];
        if (!(piv > 0.0f)) {
          s_fail = 1;
        } else {
          Lm[(size_t)k * c + k] = sqrtf(piv);
        }
      }
      __syncthreads();
      if (s_fail) break;  // uniform over the CTA
      const float dkk = Lm[(size_t)k * c + k];
      for (int i = k + 1 + tid; i < c; i += nt)
        Lm[(size_t)i * c + k] = Lm[(size_t)i * c + k] / dkk;
      __syncthreads();
      const int r = c - k - 1;
      for (int idx = tid; idx < r * r; idx += nt) {
        const int i = k + 1 + idx / r, j = k + 1 + idx % r;
        if (j > i) continue;
        Lm[(size_t)i * c + j] =
            Lm[(size_t)i * c + j] - Lm[(size_t)i * c + k] * Lm[(size_t)j * c + k];
      }
      __syncthreads();
    }
    const bool ok = s_fail == 0;
    if (!ok && tid == 0) atomicAdd(failed, 1);

    if (ok) {
      // forward L z = y, then back L^T alpha = z, in place in a[]
      for (int k = 0; k < c; ++k) {
        if (tid == 0) a[k] = a[k] / (Acc)Lm[(size_t)k * c + k];
        __syncthreads();
        const Acc zk = a[k];
        for (int i = k + 1 + tid; i < c; i += nt)
          a[i] = a[i] - (Acc)Lm[(size_t)i * c + k] * zk;
        __syncthreads();
      }
      for (int k = c - 1; k >= 0; --k) {
        if (tid == 0) a[k] = a[k] / (Acc)Lm[(size_t)k * c + k];
        __syncthreads();
        const Acc ak = a[k];
        for (int i = tid; i < k; i += nt)
          a[i] = a[i] - (Acc)Lm[(size_t)k * c + i] * ak;
        __syncthreads();
      }
    }

    // predict: one query column (slot g, node v) per thread
    for (int q = tid; q < Q; q += nt) {
      const int g = q / Vall, v = q % Vall;
      const int nb = nb_rows[(size_t)m * G + g];
      if (nb < 0 || nb >= Tp) continue;  // the slot serves no test block
      float mean = nan, var = nan;
      if (ok) {
        const float zx = (all_nodes[3 * v + 0] + centers[3 * (size_t)nb + 0]) * s;
        const float zy = (all_nodes[3 * v + 1] + centers[3 * (size_t)nb + 1]) * s;
        const float zz = (all_nodes[3 * v + 2] + centers[3 * (size_t)nb + 2]) * s;
        Acc mu = 0, ss = 0;
        for (int i = 0; i < c; ++i) {
          const float ks = matern32(dist3(px[i], py[i], pz[i], zx, zy, zz), sf2);
          mu = mu + (Acc)ks * a[i];
          const float* Li = Lm + (size_t)i * c;
          Acc r = ks;
          for (int k = 0; k < i; ++k) r = r - (Acc)Li[k] * (Acc)Vw[(size_t)k * nt + tid];
          const float vi = (float)(r / (Acc)Li[i]);
          Vw[(size_t)i * nt + tid] = vi;
          ss = ss + (Acc)vi * (Acc)vi;
        }
        mean = (float)mu;
        var = (float)((Acc)sf2 - ss);
      }
      const size_t row = (size_t)nb * G + g;
      acc_mean[row * Vall + v] = mean;
      acc_var[row * Vall + v] = var;
      if (v == 0) present[row] = 1;
    }
  }
}

}  // namespace

// Launch K4 for one size tier on ``stream``; every count is <= cmax.  CTAs
// of ``threads`` threads (the caller sizes ``ws`` with the same count).
// ``ws`` null (the base tier, cmax <= 128): one CTA per model, L and v in
// dynamic shared memory.  Otherwise ``grid`` CTAs walk the models, each with
// cmax*cmax + cmax*threads floats of ``ws``.  Returns a CUDA error code (0 on
// success).
extern "C" int la3dm_gp_heavy(const float* pts, const float* lab, const int32_t* starts,
                              const int32_t* counts, const int32_t* nb_rows,
                              const float* centers, const float* all_nodes, float* ws,
                              float* acc_mean, float* acc_var, uint8_t* present,
                              int32_t* failed, int M, int Tp, int G, int Vall, int cmax,
                              int grid, int threads, float s, float sf2, float noise,
                              void* stream) {
  if (M <= 0 || cmax <= 0 || Vall <= 0 || G <= 0 || threads <= 0 || threads > 1024 ||
      threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool shared = ws == nullptr;
  const int nt = threads;
  cudaError_t err;
  if (shared) {
    // alpha, the points, then L and the v columns, all f32
    const size_t smem =
        (4 * (size_t)cmax + (size_t)cmax * cmax + (size_t)cmax * nt) * sizeof(float);
    err = cudaFuncSetAttribute(gp_heavy_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    gp_heavy_kernel<float><<<M, nt, smem, st>>>(pts, lab, starts, counts, nb_rows,
                                                centers, all_nodes, nullptr, 0, M, Tp, G,
                                                Vall, cmax, s, sf2, noise, acc_mean,
                                                acc_var, present, failed);
  } else {
    if (grid <= 0) return (int)cudaErrorInvalidValue;
    // alpha in f64 and the points in shared memory; L and v in ws
    const size_t smem = (size_t)cmax * sizeof(double) + 3 * (size_t)cmax * sizeof(float);
    err = cudaFuncSetAttribute(gp_heavy_kernel<double>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const size_t stride = (size_t)cmax * cmax + (size_t)cmax * nt;
    gp_heavy_kernel<double><<<grid, nt, smem, st>>>(pts, lab, starts, counts, nb_rows,
                                                    centers, all_nodes, ws, stride, M, Tp,
                                                    G, Vall, cmax, s, sf2, noise, acc_mean,
                                                    acc_var, present, failed);
  }
  return (int)cudaGetLastError();
}
