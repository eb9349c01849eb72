// K1 — the BGK heavy pass, hand-written for Hopper (sm_90a), for point
// entries (BGK) and segment entries (BGKL).
//
// Replaces the heavy half of la3dm_tpu/models/bgk.py::_bgk_seq_step
// (lines 106-138: a chunked lax.scan of cov_sparse, or of
// cov_sparse_segment(lv=False) for segments (lines 121-122), times
// _slot_rhs, scattered into acc[Tp, Vall, 2G] at row_block).
//
// For each test block t and each of its rows of <= 64 merged neighbour
// entries, the sparse kernel k(node, entry) between the block's all-level
// node centres (all_nodes + centre[t]) and the row's entries is accumulated
// per neighbour slot g of the entry:  ybar[g] += k * y,  kbar[g] += k.
// row_block is non-decreasing, so block t's rows are the contiguous range
// [block_rows[t], block_rows[t+1]) (torch.searchsorted in the wrapper).
// Each (block, node) output has one writer: no atomics, deterministic.
// Each row is summed on its own and then added in, as the plain version
// adds its per-row products.
//
// Design, one for both branches (bgk_heavy_kernel: points,
// bgk_heavy_seg_kernel: segments; both run heavy_unit):
// * One warp per (test block, 32 nodes) work unit, four units a CTA, all
//   in parallel: Tp * ceil(Vall / 32) warps (3 a block at block_depth 3,
//   147 at block_depth 5), no barrier between them.  Lane i owns node
//   node_order[32 * w + i]; the wrapper orders the nodes along a Morton
//   curve so that a warp's nodes are compact.
// * Each lane loads one or two of the row's entries: a point's coordinates
//   divided by ell, or a segment and its terms (u, u.u, |u|;
//   segment_dist.cuh).
// * Exact culling (cull.cuh): the warp's box over the f32 values
//   all_nodes[v] + centre[t] of its live lanes, padded by r_c * ell and the
//   margin m = 1e-4 * (1 + |box|).  An entry whose segment misses it (a
//   point: lies outside it) is skipped by the warp.
//   Segments: every node lies farther than r_c * ell from the segment, and
//   sparse_kernel_r returns exactly 0 for every f32 r >= r_c (r_c = 1: a
//   scan of every f32 value in [1, 2) on the card,
//   kernels/bgk_heavy.py::R_CULL; above 2 the formula is negative).
//   Points, in world coordinates (|x| up to the large maps' 30 m and any
//   farther): the kernel evaluates sqrtf(dist2(x/ell - e/ell)).  A culled
//   point e lies on some axis outside [lo - P, hi + P] rounded, with
//   P = fl(ell + m); so on that axis every node x of the warp has
//   delta = |e - x| >= (ell + m)(1 - 2^-23) - 2^-24 B, B = max(|lo|, |hi|)
//   >= |x|.  The two divisions round by 2^-24 each, so the exact difference
//   of the rounded quotients is at least (delta (1 - 2^-24) - 2^-23 |x|) /
//   ell; that is >= 1 whenever m (1 - 2^-22) >= 2^-22 ell + 2^-22 B, which
//   m = 1e-4 (1 + B) meets for every B and every ell below 200 m (the
//   margin grows with |x|, so no map extent breaks it).  The rounded
//   difference is then >= 1 too (rounding is monotone and 1 exact), so
//   dx*dx >= 1, d2 >= dx*dx (adding squares never rounds below an addend),
//   r = sqrtf(d2) >= 1 and the kernel is exactly 0.
//   tests/test_torch_cull.py holds the plain predicate
//   (kernels/bgk_heavy.py::bgk_heavy_cull) to never cull a pair with a
//   non-zero plain kernel value, at centres up to 100 m out, on the padded
//   box faces and at the support.
// * The plain version's sum order, bit for bit, without G-way selects: the
//   slot of the first surviving entry of the row, then all of that slot's
//   surviving entries in row order (lanes of the first half, then the
//   second) into one running sum, added to the slot's block sum; then the
//   next slot.  A culled pair adds exactly +0 in the plain version (k = 0,
//   labels 0 or 1), and adding +0 leaves a sum unchanged, so skipping it
//   changes no bit; a slot with no survivor in a row adds nothing, as its
//   +0 row sum would.
// * Output: the block sums sit in shared memory, a row of 2G + 1 floats a
//   lane (no bank conflicts), and are written out node by node by the
//   whole warp, coalesced.
// * ``culled`` (or null) counts the (warp, entry) pairs skipped, one atomic
//   a unit.
//
// What bounds both: FP32 arithmetic on the CUDA cores — about 50
// operations per point evaluation and 85 per segment evaluation, sinf/cosf
// included — on the pairs the culling keeps.  Tensor cores are out: the
// distances feed a clamp whose sign is decided in the last ulp (the k-bar
// > 0 update gate), so parity rules out TF32 and a Gram expansion.  Built
// with --fmad=false and without fast-math: every expression rounds as the
// plain PyTorch version's separate ops round.
//
// Parity with la3dm_tpu/kernels/math.py: per-axis direct subtraction,
// d2 = ((dx*dx) + dy*dy) + dz*dz, both operands divided by ell (no
// reciprocal), node + centre added before the division, and
// TWO_PI = float32(2 * 3.1415926) (sparse_kernel.cuh).  Segments: the
// distance of segment_dist.cuh between the node (node + centre) and the
// segment, then r = d / ell (a division) into the kernel clamped at 0.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "cull.cuh"
#include "segment_dist.cuh"
#include "sparse_kernel.cuh"

namespace {

constexpr int kW = 64;          // entry-row width (_ROW_W)
constexpr int kWarps = 4;       // work units (warps) per CTA
constexpr unsigned kAll = 0xffffffffu;

// A point entry as the point branch evaluates it: coordinates / ell, label.
struct Pt {
  float x, y, z, lab;
};

// Entry ``id`` into ``p`` unless the warp culls it (it lies outside the box).
__device__ __forceinline__ bool load_entry(const float* __restrict__ entries,
                                           const float* __restrict__ labels, int id, float ell,
                                           const float plo[3], const float phi[3], Pt& p) {
  const float* e = entries + (size_t)3 * id;
  const float a[3] = {e[0], e[1], e[2]};
  if (point_misses_box(a, plo, phi)) return false;
  p = Pt{a[0] / ell, a[1] / ell, a[2] / ell, labels[id]};
  return true;
}

// Segment ``id`` into ``s`` unless the warp culls it (it misses the box).
__device__ __forceinline__ bool load_entry(const float* __restrict__ entries,
                                           const float* __restrict__ labels, int id, float,
                                           const float plo[3], const float phi[3], Seg& s) {
  s = seg_load(entries + (size_t)6 * id, labels[id]);
  return !segment_misses_box(s.a, s.u, plo, phi);
}

__device__ __forceinline__ Pt entry_shfl(const Pt& p, int src) {
  return Pt{__shfl_sync(kAll, p.x, src), __shfl_sync(kAll, p.y, src),
            __shfl_sync(kAll, p.z, src), __shfl_sync(kAll, p.lab, src)};
}

__device__ __forceinline__ Seg entry_shfl(const Seg& s, int src) { return seg_shfl(s, src); }

// The kernel value at this lane's node: ``n`` is node / ell for a point,
// the node itself for a segment.
__device__ __forceinline__ float kernel_at(const Pt& p, const float n[3], float sf2, float) {
  return sparse_kernel_d2(dist2(n[0] - p.x, n[1] - p.y, n[2] - p.z), sf2);
}

__device__ __forceinline__ float kernel_at(const Seg& s, const float n[3], float sf2,
                                           float ell) {
  return sparse_kernel_r(seg_dist(n[0], n[1], n[2], s) / ell, sf2);
}

// The entries of ``sel`` (lanes holding ``mine``), in lane order, into the
// running slot sums ry, rk.
template <class E>
__device__ __forceinline__ void sum_slot(unsigned sel, const E& mine, const float n[3],
                                         float sf2, float ell, float& ry, float& rk) {
  while (sel) {
    const int src = __ffs(sel) - 1;
    sel &= sel - 1;
    const E e = entry_shfl(mine, src);
    const float k = kernel_at(e, n, sf2, ell);
    const float ky = k * e.lab;
    ry += ky;
    rk += k;
  }
}

// One (test block, 32 nodes) work unit; D = 3 points, D = 6 segments.
template <int G, int D>
__device__ __forceinline__ void heavy_unit(const float* __restrict__ entries,
                                           const float* __restrict__ labels,
                                           const int32_t* __restrict__ ids,
                                           const int8_t* __restrict__ gslot,
                                           const int32_t* __restrict__ row_start,
                                           const int32_t* __restrict__ row_count,
                                           const int64_t* __restrict__ block_rows,
                                           const float* __restrict__ centers,
                                           const float* __restrict__ all_nodes,
                                           const int32_t* __restrict__ node_order,
                                           unsigned long long* __restrict__ culled,
                                           int64_t n_units, int Vall, float sf2, float ell,
                                           float reach, float* __restrict__ acc,
                                           float (*s_acc)[32 * (2 * G + 1)]) {
  using E = typename std::conditional<D == 3, Pt, Seg>::type;
  constexpr int S = 2 * G + 1;  // a lane's row of block sums, padded
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const int64_t unit = (int64_t)blockIdx.x * kWarps + wib;
  if (unit >= n_units) return;  // uniform over the warp
  const int wpb = (Vall + 31) / 32;
  const int64_t t = unit / wpb;
  const int i0 = (int)(unit % wpb) * 32;
  const bool live = i0 + lane < Vall;
  const int node = live ? node_order[i0 + lane] : 0;
  float n[3] = {all_nodes[3 * node + 0] + centers[3 * t + 0],
                all_nodes[3 * node + 1] + centers[3 * t + 1],
                all_nodes[3 * node + 2] + centers[3 * t + 2]};
  float plo[3], phi[3];
  warp_box(live, n[0], n[1], n[2], reach, plo, phi);
  if (D == 3) {
#pragma unroll
    for (int ax = 0; ax < 3; ++ax) n[ax] = n[ax] / ell;
  }

  float* mine_acc = s_acc[wib] + lane * S;
#pragma unroll
  for (int q = 0; q < 2 * G; ++q) mine_acc[q] = 0.f;
  unsigned long long n_culled = 0;

  for (int64_t r = block_rows[t]; r < block_rows[t + 1]; ++r) {
    const int st = row_start[r];
    const int cnt = min(row_count[r], kW);
    // lane i holds entries i and 32 + i of the row
    E e0{}, e1{};
    int g0 = -1, g1 = -1;
    bool k0 = false, k1 = false;
    if (lane < cnt) {
      k0 = load_entry(entries, labels, ids[st + lane], ell, plo, phi, e0);
      g0 = gslot[st + lane];
    }
    if (32 + lane < cnt) {
      k1 = load_entry(entries, labels, ids[st + 32 + lane], ell, plo, phi, e1);
      g1 = gslot[st + 32 + lane];
    }
    unsigned m0 = __ballot_sync(kAll, k0), m1 = __ballot_sync(kAll, k1);
    n_culled += (unsigned)(cnt - __popc(m0) - __popc(m1));
    while (m0 | m1) {
      // the slot of the first surviving entry, then all of that slot's
      // surviving entries in row order: each slot's running sum takes its
      // entries in row order
      const int g = m0 ? __shfl_sync(kAll, g0, __ffs(m0) - 1)
                       : __shfl_sync(kAll, g1, __ffs(m1) - 1);
      const unsigned s0 = __ballot_sync(kAll, g0 == g) & m0;
      const unsigned s1 = __ballot_sync(kAll, g1 == g) & m1;
      m0 &= ~s0;
      m1 &= ~s1;
      float ry = 0.f, rk = 0.f;
      sum_slot(s0, e0, n, sf2, ell, ry, rk);
      sum_slot(s1, e1, n, sf2, ell, ry, rk);
      mine_acc[g] += ry;
      mine_acc[G + g] += rk;
    }
  }
  if (culled != nullptr && lane == 0) atomicAdd(culled, n_culled);
  __syncwarp();
  // the warp's nodes, one 2G row each, written by the whole warp
  const float* rows = s_acc[wib];
  for (int j = 0; j < 32 && i0 + j < Vall; ++j) {
    const int nj = __shfl_sync(kAll, node, j);
    float* out = acc + ((size_t)t * Vall + nj) * (2 * G);
    for (int q = lane; q < 2 * G; q += 32) out[q] = rows[j * S + q];
  }
}

#define LA3DM_K1_PARAMS                                                                       \
  const float *__restrict__ entries, const float *__restrict__ labels,                        \
      const int32_t *__restrict__ ids, const int8_t *__restrict__ gslot,                      \
      const int32_t *__restrict__ row_start, const int32_t *__restrict__ row_count,           \
      const int64_t *__restrict__ block_rows, const float *__restrict__ centers,              \
      const float *__restrict__ all_nodes, const int32_t *__restrict__ node_order,            \
      unsigned long long *__restrict__ culled, int64_t n_units, int Vall, float sf2,          \
      float ell, float reach, float *__restrict__ acc
#define LA3DM_K1_ARGS                                                                         \
  entries, labels, ids, gslot, row_start, row_count, block_rows, centers, all_nodes,          \
      node_order, culled, n_units, Vall, sf2, ell, reach, acc

// Points (BGK): entries [N,3].
template <int G>
__global__ void __launch_bounds__(32 * kWarps) bgk_heavy_kernel(LA3DM_K1_PARAMS) {
  __shared__ float s_acc[kWarps][32 * (2 * G + 1)];
  heavy_unit<G, 3>(LA3DM_K1_ARGS, s_acc);
}

// Segments (BGKL): entries [N,6], start and end.
template <int G>
__global__ void __launch_bounds__(32 * kWarps) bgk_heavy_seg_kernel(LA3DM_K1_PARAMS) {
  __shared__ float s_acc[kWarps][32 * (2 * G + 1)];
  heavy_unit<G, 6>(LA3DM_K1_ARGS, s_acc);
}

// The sparse kernel of every r, as K1's segment branch evaluates it.
__global__ void sparse_kernel_scan_kernel(const float* __restrict__ r, float* __restrict__ out,
                                          long long n, float sf2) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = sparse_kernel_r(r[i], sf2);
}

}  // namespace

// Launch K1 on ``stream``: Tp * ceil(Vall / 32) warp units, four a CTA;
// entries of width D (3: points, 6: segments); ``node_order`` a
// permutation of the Vall nodes, ``reach`` = r_c * ell, ``culled`` (or null)
// counts the (warp, entry) pairs skipped.  Returns cudaGetLastError().
extern "C" int la3dm_bgk_heavy(const float* entries, const float* labels, const int32_t* ids,
                               const int8_t* gslot, const int32_t* row_start,
                               const int32_t* row_count, const int64_t* block_rows,
                               const float* centers, const float* all_nodes,
                               const int32_t* node_order, unsigned long long* culled, int Tp,
                               int Vall, int G, int D, float sf2, float ell, float reach,
                               float* acc, void* stream) {
  if (Tp <= 0 || Vall <= 0) return (int)cudaErrorInvalidValue;
  const int64_t n_units = (int64_t)Tp * ((Vall + 31) / 32);
  const unsigned blocks = (unsigned)((n_units + kWarps - 1) / kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LA3DM_K1(KERNEL, GG) KERNEL<GG><<<blocks, 32 * kWarps, 0, s>>>(LA3DM_K1_ARGS)
  if (D == 3 && G == 7) {
    LA3DM_K1(bgk_heavy_kernel, 7);
  } else if (D == 3 && G == 27) {
    LA3DM_K1(bgk_heavy_kernel, 27);
  } else if (D == 6 && G == 7) {
    LA3DM_K1(bgk_heavy_seg_kernel, 7);
  } else if (D == 6 && G == 27) {
    LA3DM_K1(bgk_heavy_seg_kernel, 27);
  } else {
    return (int)cudaErrorInvalidValue;
  }
#undef LA3DM_K1
  return (int)cudaGetLastError();
}

// sparse_kernel_r of each of the n values r on ``stream`` (the r_c scan).
extern "C" int la3dm_sparse_kernel_scan(const float* r, float* out, long long n, float sf2,
                                        void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sparse_kernel_scan_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(r, out, n, sf2);
  return (int)cudaGetLastError();
}
