// The f64 tensor-core rate of the mma.sync shapes, and of the f32 -> f64
// conversion, on one card: the numbers behind K4's choice of m16n8k4 for
// its predict (csrc/gp_heavy.cu).  Each kernel keeps independent
// accumulators busy with no memory traffic; the rate counts 2 flops a
// multiply-add (one conversion an op for cvt).  Build it outside the
// repository and run it on a machine with the card:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o "$TMPDIR/dmma_rate" tools/dmma_rate.cu
//   "$TMPDIR/dmma_rate"

#include <cstdio>
#include <cuda_runtime.h>
#define ITERS 2048
__global__ void k_m8n8k4(double* out, double seed) {
  double acc[8][2]; double a = seed + threadIdx.x, b = seed * 2;
  for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = 0;
  for (int it = 0; it < ITERS; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};" : "+d"(acc[i][0]), "+d"(acc[i][1]) : "d"(a), "d"(b));
  }
  double s = 0; for (int i = 0; i < 8; ++i) s += acc[i][0] + acc[i][1];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
__global__ void k_m16n8k4(double* out, double seed) {
  double acc[8][4]; double a0 = seed + threadIdx.x, a1 = seed * 3, b = seed * 2;
  for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0;
  for (int it = 0; it < ITERS; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};" : "+d"(acc[i][0]), "+d"(acc[i][1]), "+d"(acc[i][2]), "+d"(acc[i][3]) : "d"(a0), "d"(a1), "d"(b));
  }
  double s = 0; for (int i = 0; i < 8; ++i) s += acc[i][0] + acc[i][1] + acc[i][2] + acc[i][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
__global__ void k_m16n8k8(double* out, double seed) {
  double acc[8][4]; double a0 = seed + threadIdx.x, a1 = seed * 3, a2 = seed*5, a3 = seed*7, b0 = seed * 2, b1 = seed*4;
  for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0;
  for (int it = 0; it < ITERS; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};" : "+d"(acc[i][0]), "+d"(acc[i][1]), "+d"(acc[i][2]), "+d"(acc[i][3]) : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
  }
  double s = 0; for (int i = 0; i < 8; ++i) s += acc[i][0] + acc[i][1] + acc[i][2] + acc[i][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
__global__ void k_m16n8k16(double* out, double seed) {
  double acc[4][4]; double a[8], b[4];
  for (int i = 0; i < 8; ++i) a[i] = seed + i + threadIdx.x;
  for (int i = 0; i < 4; ++i) b[i] = seed * (i + 2);
  for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0;
  for (int it = 0; it < ITERS; ++it) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};" : "+d"(acc[i][0]), "+d"(acc[i][1]), "+d"(acc[i][2]), "+d"(acc[i][3]) : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
  }
  double s = 0; for (int i = 0; i < 4; ++i) s += acc[i][0] + acc[i][1] + acc[i][2] + acc[i][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
__global__ void k_cvt(double* out, float seed) {
  float x[8]; double s[8];
  for (int i = 0; i < 8; ++i) { x[i] = seed + i + threadIdx.x; s[i] = 0; }
  for (int it = 0; it < ITERS; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) { double d; asm volatile("cvt.f64.f32 %0, %1;" : "=d"(d) : "f"(x[i])); s[i] += d; x[i] += 1.0f; }
  }
  double t = 0; for (int i = 0; i < 8; ++i) t += s[i];
  out[blockIdx.x * blockDim.x + threadIdx.x] = t;
}
template <class F> void run(const char* name, F k, double flops_per_thread_iter, int threads) {
  double* out; cudaMalloc(&out, 132 * 16 * 1024 * sizeof(double));
  int grid = 132 * (2048 / threads);
  k<<<grid, threads>>>(out, 1.0); cudaDeviceSynchronize();
  cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
  cudaEventRecord(a); for (int r = 0; r < 5; ++r) k<<<grid, threads>>>(out, 1.0); cudaEventRecord(b);
  cudaEventSynchronize(b); float ms; cudaEventElapsedTime(&ms, a, b); ms /= 5;
  double total = flops_per_thread_iter * ITERS * (double)grid * threads;
  printf("%-12s threads %4d: %.3f ms, %.2f T(FL)OP/s  err=%s\n", name, threads, ms, total / ms / 1e9, cudaGetErrorString(cudaGetLastError()));
  cudaFree(out);
}
int main() {
  // per thread and iteration: 8 mma (4 of m16n8k16); an m8n8k4 is 512 flops a warp
  run("m8n8k4", k_m8n8k4, 8 * 16.0, 256);
  run("m16n8k4", k_m16n8k4, 8 * 32.0, 256);
  run("m16n8k8", k_m16n8k8, 8 * 64.0, 256);
  run("m16n8k16", k_m16n8k16, 4 * 128.0, 256);
  run("cvt f32->f64", k_cvt, 8.0, 256);
  return 0;
}
