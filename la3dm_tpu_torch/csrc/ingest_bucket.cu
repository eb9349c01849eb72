// K7t — the bucket tail of device scan ingest, hand-written for Hopper
// (sm_90a).
//
// Replaces the tail of la3dm_tpu/geometry/device_ingest.py::_bucket_align
// (lines 298-389): the payload columns in block order (its second lax.sort)
// and the slot maps nb_row / tb_u (its one-hot equality matmuls, lines
// 357-385).  From K7s's sort of the membership keys (perm, and rid, the run
// of each sorted row) and its sort of the candidate keys (tkey), one launch
// writes, thread by thread over three ranges:
//   row i < M       e = mrow[perm[i]] (K7c's rows): ent_s[i] = ent[e], lab_s[i] = lab[e],
//                   ent_rel[i] = ent[e] - (coord in f32) * bs per axis (the
//                   coordinate of the row's block, ukey[rid[i]]; D = 3 or 6,
//                   both ends of a segment);
//   (u, g) < U G    nb_row[u, g] = the position of ukey[u] - off[g] in tkey;
//   (t, g) < T G    tb_u[t, g] = the position of tkey[t] + off[g] in ukey, or
//                   U where it is none,
// each lookup a binary search (lower bound) over the sorted int64 keys, as
// torch.searchsorted's left side.
// What bounds it: bytes (the gathered columns; the searches read a few
// cached lines each).

#include <cuda_runtime.h>
#include <stdint.h>

#include "ingest_keys.cuh"

namespace {

// the first position of sorted[0, n) not below x (n where none)
__device__ __forceinline__ int64_t lower_bound(const int64_t* __restrict__ sorted, int64_t n,
                                               int64_t x) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (sorted[mid] < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void ingest_bucket_kernel(const int64_t* __restrict__ perm,    // [M]
                                     const int32_t* __restrict__ rid,     // [M]
                                     const int32_t* __restrict__ mrow,    // [>= M]
                                     const float* __restrict__ ent,       // [E, D]
                                     const float* __restrict__ lab,       // [E]
                                     const int64_t* __restrict__ ukey,    // [U]
                                     const int64_t* __restrict__ tkey,    // [T]
                                     const int64_t* __restrict__ off,     // [G]
                                     const int32_t* __restrict__ anchors, // [K, 3]
                                     int64_t M, int64_t U, int64_t T, int G, int D, float bs,
                                     float* __restrict__ ent_s, float* __restrict__ ent_rel,
                                     float* __restrict__ lab_s, int64_t* __restrict__ nb_row,
                                     int64_t* __restrict__ tb_u) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < M) {
    const int64_t p = perm[i];
    const int64_t e = mrow[p];
    const int64_t key = ukey[rid[i]];
    const int32_t* anchor = anchors + 3 * (int)(key >> 48);
    float ctr[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) ctr[a] = (float)key_coord(key, a, anchor) * bs;
    for (int k = 0; k < D; ++k) {
      const float v = ent[e * D + k];
      ent_s[i * D + k] = v;
      ent_rel[i * D + k] = v - ctr[k % 3];
    }
    lab_s[i] = lab[e];
    return;
  }
  i -= M;
  if (i < U * G) {
    const int64_t u = i / G, g = i % G;
    nb_row[i] = lower_bound(tkey, T, ukey[u] - off[g]);
    return;
  }
  i -= U * G;
  if (i < T * G) {
    const int64_t t = i / G, g = i % G;
    const int64_t want = tkey[t] + off[g];
    const int64_t pos = lower_bound(ukey, U, want);
    tb_u[i] = ukey[pos < U - 1 ? pos : U - 1] == want ? pos : U;
  }
}

constexpr int kThreads = 256;

}  // namespace

// Launch K7t on ``stream``: one thread a row, an (entry block, slot) and a
// (test block, slot).  Returns cudaGetLastError().
extern "C" int la3dm_ingest_bucket(const int64_t* perm, const int32_t* rid,
                                   const int32_t* mrow, const float* ent, const float* lab,
                                   const int64_t* ukey, const int64_t* tkey,
                                   const int64_t* off, const int32_t* anchors, long long M,
                                   long long U, long long T, int G, int D, float bs,
                                   float* ent_s, float* ent_rel, float* lab_s,
                                   int64_t* nb_row, int64_t* tb_u, void* stream) {
  if (M < 0 || U <= 0 || T <= 0 || G <= 0 || (D != 3 && D != 6))
    return (int)cudaErrorInvalidValue;
  const long long n = M + U * G + T * G;
  const long long grid = (n + kThreads - 1) / kThreads;
  ingest_bucket_kernel<<<(unsigned)grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      perm, rid, mrow, ent, lab, ukey, tkey, off, anchors, M, U, T, G, D, bs, ent_s, ent_rel,
      lab_s, nb_row, tb_u);
  return (int)cudaGetLastError();
}
