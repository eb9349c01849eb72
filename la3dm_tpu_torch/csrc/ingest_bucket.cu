// K7t — the bucket tail of device scan ingest, hand-written for Hopper
// (sm_90a).
//
// Replaces the tail of la3dm_tpu/geometry/device_ingest.py::_bucket_align
// (lines 298-389): the payload columns in block order (its second lax.sort)
// and the slot maps nb_row / tb_u (its one-hot equality matmuls, lines
// 351-385).  It reads K7s's sort of the membership keys (perm, and rid, the
// run of each sorted row) and K7s's sort of the candidate keys ukey[u] +
// off[g'] (cperm, each sorted candidate's index p = u G + g', and the runs
// cstart / ccount: run t holds the candidates whose key is test block t).
// One launch, two CTA ranges:
//   rows        a warp takes 64 consecutive sorted rows i, e = mrow[perm[i]]
//               (K7c's rows): ent_s[i] = ent[e], lab_s[i] = lab[e],
//               ent_rel[i] = ent[e] - (coord in f32) * bs per axis (the
//               coordinate of the row's block, ukey[rid[i]]; D = 3 or 6, both
//               ends of a segment).  The first lane of each run in a group of
//               32 rows unpacks its block's centre, the others take it by a
//               shuffle; the warp's ent loads are issued before its stores,
//               and the slabs of ent_s and ent_rel leave as contiguous floats
//               (lane l writes float l, l + 32, ...).
//   slot maps   a CTA takes 256 test blocks t and walks their candidate rows
//               (contiguous in cperm), each member p = u G + g' once:
//               nb_row[u, mirror(g')] = t and tb_u[t, mirror(g')] = u, where
//               off[mirror(g)] = -off[g] (the offsets are symmetric).  Every
//               candidate sits in one run, so every (u, g) has one writer; a
//               test block's row of tb_u is built in shared memory (U where no
//               member) and leaves coalesced.
// No search: the candidate sort has already matched every key u + off_g to
// its test block.  Every output is an integer or the plain version's f32
// operation, so the kernel equals both plain versions (the searchsorted one
// and the one read off the runs) bit for bit.
// What bounds it: bytes (the gathered entry rows, the slabs written, the
// scattered nb_row).

#include <cuda_runtime.h>
#include <stdint.h>

#include "ingest_keys.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = 2;                  // groups of 32 rows a warp
constexpr int kWarpRows = 32 * kGroups;     // rows a warp
constexpr int kCtaRows = kWarps * kWarpRows;
constexpr int kCtaTests = kThreads;         // test blocks a CTA
constexpr unsigned kAll = 0xffffffffu;

struct RowSmem {
  int32_t e[kWarps][kWarpRows];          // each row's entry
  float ctr[kWarps][kWarpRows][3];       // its block's centre
};

template <int G>
struct SlotSmem {
  int32_t tb[kCtaTests * G];             // the CTA's rows of tb_u
  uint8_t owner[kCtaTests * G];          // each candidate row's test block, in the CTA
  int32_t mirror[G];
  int base, end;                         // the CTA's candidate rows
};

// the shared memory of a CTA of either range
template <int G>
struct Smem {
  static constexpr size_t bytes =
      sizeof(SlotSmem<G>) > sizeof(RowSmem) ? sizeof(SlotSmem<G>) : sizeof(RowSmem);
};

template <int D>
__device__ __forceinline__ void rows_part(int cta, const int64_t* __restrict__ perm,
                                          const int32_t* __restrict__ rid,
                                          const int32_t* __restrict__ mrow,
                                          const float* __restrict__ ent,
                                          const float* __restrict__ lab,
                                          const int64_t* __restrict__ ukey,
                                          const int32_t* __restrict__ anchors, int M, float bs,
                                          float* __restrict__ ent_s,
                                          float* __restrict__ ent_rel,
                                          float* __restrict__ lab_s, RowSmem& sm) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int r0 = cta * kCtaRows + w * kWarpRows;  // the warp's first row
  if (r0 >= M) return;
  const int nrows = M - r0 < kWarpRows ? M - r0 : kWarpRows;
  int e[kGroups], u[kGroups];
  float lb[kGroups];
#pragma unroll
  for (int h = 0; h < kGroups; ++h) {
    const int i = r0 + 32 * h + lane;
    u[h] = i < M ? rid[i] : -1;
    e[h] = i < M ? mrow[perm[i]] : 0;
  }
#pragma unroll
  for (int h = 0; h < kGroups; ++h) {
    const int i = r0 + 32 * h + lane;
    lb[h] = i < M ? lab[e[h]] : 0.0f;
    // the first lane of each run in the group unpacks its centre
    const int prev = __shfl_up_sync(kAll, u[h], 1);
    const bool head = lane == 0 || u[h] != prev;
    const unsigned heads = __ballot_sync(kAll, head);
    float c[3] = {0.0f, 0.0f, 0.0f};
    if (head && i < M) {
      const int64_t key = ukey[u[h]];
      const int32_t* anchor = anchors + 3 * (int)(key >> 48);
#pragma unroll
      for (int a = 0; a < 3; ++a) c[a] = (float)key_coord(key, a, anchor) * bs;
    }
    const int src = 31 - __clz(heads & (kAll >> (31 - lane)));
#pragma unroll
    for (int a = 0; a < 3; ++a) sm.ctr[w][32 * h + lane][a] = __shfl_sync(kAll, c[a], src);
    sm.e[w][32 * h + lane] = e[h];
  }
  __syncwarp();
  // the warp's slab of nrows * D floats, float f = 32 k + lane
  constexpr int kPer = kWarpRows * D / 32;
  float v[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int f = 32 * k + lane, r = f / D;
    v[k] = r < nrows ? ent[(int64_t)sm.e[w][r] * D + (f - r * D)] : 0.0f;
  }
  const int64_t base = (int64_t)r0 * D;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int f = 32 * k + lane, r = f / D;
    if (r < nrows) {
      ent_s[base + f] = v[k];
      ent_rel[base + f] = v[k] - sm.ctr[w][r][(f - r * D) % 3];
    }
  }
#pragma unroll
  for (int h = 0; h < kGroups; ++h) {
    const int i = r0 + 32 * h + lane;
    if (i < M) lab_s[i] = lb[h];
  }
}

template <int G>
__device__ __forceinline__ void slot_part(int cta, const int64_t* __restrict__ cperm,
                                          const int64_t* __restrict__ cstart,
                                          const int64_t* __restrict__ ccount,
                                          const int32_t* __restrict__ mirror, int U, int T,
                                          int64_t* __restrict__ nb_row,
                                          int64_t* __restrict__ tb_u, SlotSmem<G>& sm) {
  const int tid = threadIdx.x;
  const int t0 = cta * kCtaTests;
  const int nt = T - t0 < kCtaTests ? T - t0 : kCtaTests;
  int st = 0, cn = 0;
  if (tid < nt) {
    st = (int)cstart[t0 + tid];
    cn = (int)ccount[t0 + tid];
    if (tid == 0) sm.base = st;
    if (tid == nt - 1) sm.end = st + cn;
  }
  if (tid < G) sm.mirror[tid] = mirror[tid];
  for (int i = tid; i < nt * G; i += kThreads) sm.tb[i] = U;
  __syncthreads();
  const int base = sm.base, rows = sm.end - base;
  for (int j = 0; j < cn; ++j) sm.owner[st - base + j] = (uint8_t)tid;
  __syncthreads();
  for (int q = tid; q < rows; q += kThreads) {
    const int p = (int)cperm[base + q];  // u G + g'
    const int o = sm.owner[q];
    const int u = p / G, g = sm.mirror[p - u * G];
    nb_row[(int64_t)u * G + g] = t0 + o;
    sm.tb[o * G + g] = u;
  }
  __syncthreads();
  for (int i = tid; i < nt * G; i += kThreads) tb_u[(int64_t)t0 * G + i] = sm.tb[i];
}

template <int G, int D>
__global__ void __launch_bounds__(kThreads)
ingest_bucket_kernel(const int64_t* __restrict__ perm,     // [M]
                     const int32_t* __restrict__ rid,      // [M]
                     const int32_t* __restrict__ mrow,     // [>= M]
                     const float* __restrict__ ent,        // [E, D]
                     const float* __restrict__ lab,        // [E]
                     const int64_t* __restrict__ ukey,     // [U]
                     const int64_t* __restrict__ cperm,    // [U G]
                     const int64_t* __restrict__ cstart,   // [T]
                     const int64_t* __restrict__ ccount,   // [T]
                     const int32_t* __restrict__ mirror,   // [G]
                     const int32_t* __restrict__ anchors,  // [K, 3]
                     int M, int U, int T, float bs, int row_ctas,
                     float* __restrict__ ent_s, float* __restrict__ ent_rel,
                     float* __restrict__ lab_s, int64_t* __restrict__ nb_row,
                     int64_t* __restrict__ tb_u) {
  __shared__ __align__(16) unsigned char smem[Smem<G>::bytes];
  if ((int)blockIdx.x < row_ctas) {
    rows_part<D>((int)blockIdx.x, perm, rid, mrow, ent, lab, ukey, anchors, M, bs, ent_s,
                 ent_rel, lab_s, *reinterpret_cast<RowSmem*>(smem));
  } else {
    slot_part<G>((int)blockIdx.x - row_ctas, cperm, cstart, ccount, mirror, U, T, nb_row, tb_u,
                 *reinterpret_cast<SlotSmem<G>*>(smem));
  }
}

template <int G, int D>
void launch(const int64_t* perm, const int32_t* rid, const int32_t* mrow, const float* ent,
            const float* lab, const int64_t* ukey, const int64_t* cperm, const int64_t* cstart,
            const int64_t* ccount, const int32_t* mirror, const int32_t* anchors, int M, int U,
            int T, float bs, float* ent_s, float* ent_rel, float* lab_s, int64_t* nb_row,
            int64_t* tb_u, cudaStream_t s) {
  const int row_ctas = (M + kCtaRows - 1) / kCtaRows;
  const int slot_ctas = (T + kCtaTests - 1) / kCtaTests;
  ingest_bucket_kernel<G, D><<<row_ctas + slot_ctas, kThreads, 0, s>>>(
      perm, rid, mrow, ent, lab, ukey, cperm, cstart, ccount, mirror, anchors, M, U, T, bs,
      row_ctas, ent_s, ent_rel, lab_s, nb_row, tb_u);
}

}  // namespace

// Launch K7t on ``stream``: ceil(M / 512) CTAs of rows, then ceil(T / 256)
// CTAs of test blocks; G is 7 or 27, D 3 or 6, M < 2^30, U G < 2^30.
// Returns cudaGetLastError().
extern "C" int la3dm_ingest_bucket(const int64_t* perm, const int32_t* rid,
                                   const int32_t* mrow, const float* ent, const float* lab,
                                   const int64_t* ukey, const int64_t* cperm,
                                   const int64_t* cstart, const int64_t* ccount,
                                   const int32_t* mirror, const int32_t* anchors, long long M,
                                   long long U, long long T, int G, int D, float bs,
                                   float* ent_s, float* ent_rel, float* lab_s,
                                   int64_t* nb_row, int64_t* tb_u, void* stream) {
  if (M < 0 || M >= (1LL << 30) || U <= 0 || T <= 0 || T > U * G || U * G >= (1LL << 30) ||
      (G != 7 && G != 27) || (D != 3 && D != 6))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = (int)M, u = (int)U, t = (int)T;
  if (G == 7 && D == 3)
    launch<7, 3>(perm, rid, mrow, ent, lab, ukey, cperm, cstart, ccount, mirror, anchors, m, u,
                 t, bs, ent_s, ent_rel, lab_s, nb_row, tb_u, s);
  else if (G == 7)
    launch<7, 6>(perm, rid, mrow, ent, lab, ukey, cperm, cstart, ccount, mirror, anchors, m, u,
                 t, bs, ent_s, ent_rel, lab_s, nb_row, tb_u, s);
  else if (D == 3)
    launch<27, 3>(perm, rid, mrow, ent, lab, ukey, cperm, cstart, ccount, mirror, anchors, m,
                  u, t, bs, ent_s, ent_rel, lab_s, nb_row, tb_u, s);
  else
    launch<27, 6>(perm, rid, mrow, ent, lab, ukey, cperm, cstart, ccount, mirror, anchors, m,
                  u, t, bs, ent_s, ent_rel, lab_s, nb_row, tb_u, s);
  return (int)cudaGetLastError();
}
