// K7w — the test blocks' world keys and pool-slot gather of device ingest,
// hand-written for Hopper (sm_90a).
//
// Replaces no JAX step: the JAX map resolves its test blocks' pool slots on
// the host, one test block at a time (la3dm_tpu/models/ingest.py), and so did
// the port.  Two kernels around one K7s sort (kernels/ingest_slots.py):
//   world   one thread a test block: its scan-local key (ingest_keys.cuh)
//           becomes a world key, K7s's layout with scan 0 and the axes
//           swapped (bits 32-47 x, 16-31 y, 0-15 z, each the coordinate minus
//           the dispatch's base plus 32768), so that K7s's one-scan code
//           orders the keys x-major as geometry/blocks.py::pack_key does; a
//           field outside 16 bits gives the sentinel.  The first CTA also
//           writes each scan's count of test blocks, by binary search of the
//           scan-sorted keys (a scan's keys start at scan << 48).
//   gather  one thread a sorted row j: test block perm[j] takes the slot of
//           its run rid[j], and (GP) its centre from the run's world key,
//           rounded as geometry/blocks.py::block_center rounds it:
//           (float)((double)c * (double)(float)bs).
// What bounds both: bytes, under 3 MB a launch at a benchmark dispatch (88k
// test blocks), so their time is the launch's.  The gather reads rid and the
// run arrays in sorted order (coalesced) and scatters 4 (16) bytes a row.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ingest_keys.cuh"

namespace {

constexpr int kThreads = 256;

// the first row of the sorted keys[0, n) that is >= v
__device__ __forceinline__ int64_t lower_bound(const int64_t* __restrict__ keys, int64_t n,
                                               int64_t v) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (keys[mid] < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__device__ __forceinline__ int64_t world_field(int c, int base, bool* ok) {
  const int f = c - base + kFieldBias;
  *ok = *ok && f >= 0 && f <= 0xFFFF;
  return (int64_t)f;
}

__global__ void __launch_bounds__(kThreads)
ingest_slots_world_kernel(const int64_t* __restrict__ tkey,     // [T], sorted
                          const int32_t* __restrict__ anchors,  // [K,3]
                          int64_t T, int K, int bx, int by, int bz,
                          int64_t* __restrict__ wkey,           // [T]
                          int32_t* __restrict__ scan_count) {   // [K]
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < T) {
    const int64_t key = tkey[i];
    const int32_t* a = anchors + 3 * (int)(key >> 48);
    bool ok = true;
    const int64_t fx = world_field(key_coord(key, 0, a), bx, &ok);
    const int64_t fy = world_field(key_coord(key, 1, a), by, &ok);
    const int64_t fz = world_field(key_coord(key, 2, a), bz, &ok);
    wkey[i] = ok ? (fx << 32) | (fy << 16) | fz : kSentinel;
  }
  if (blockIdx.x == 0) {
    for (int s = threadIdx.x; s < K; s += blockDim.x) {
      const int64_t lo = lower_bound(tkey, T, (int64_t)s << 48);
      const int64_t hi = lower_bound(tkey, T, (int64_t)(s + 1) << 48);
      scan_count[s] = (int32_t)(hi - lo);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
ingest_slots_gather_kernel(const int64_t* __restrict__ perm,    // [T]
                           const int32_t* __restrict__ rid,     // [T]
                           const int32_t* __restrict__ uslots,  // [D]
                           const int64_t* __restrict__ ukey,    // [D]
                           int64_t T, int bx, int by, int bz, float bs,
                           int32_t* __restrict__ slots,         // [T]
                           float* __restrict__ centres) {       // [T,3] or null
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= T) return;
  const int64_t i = perm[j];
  const int r = rid[j];
  slots[i] = uslots[r];
  if (centres != nullptr) {
    const int64_t k = ukey[r];
    const double b = (double)bs;
    const int x = (int)((k >> 32) & 0xFFFF) - kFieldBias + bx;
    const int y = (int)((k >> 16) & 0xFFFF) - kFieldBias + by;
    const int z = (int)(k & 0xFFFF) - kFieldBias + bz;
    centres[3 * i + 0] = (float)((double)x * b);
    centres[3 * i + 1] = (float)((double)y * b);
    centres[3 * i + 2] = (float)((double)z * b);
  }
}

}  // namespace

// Launch K7w's world-key kernel on ``stream``: T >= 1 sorted scan-local
// test-block keys, K scans.  Returns cudaGetLastError().
extern "C" int la3dm_ingest_slots_world(const int64_t* tkey, const int32_t* anchors,
                                        long long T, int K, int bx, int by, int bz,
                                        int64_t* wkey, int32_t* scan_count, void* stream) {
  if (T <= 0 || T >= (1LL << 31) || K < 1) return (int)cudaErrorInvalidValue;
  const long long grid = (T + kThreads - 1) / kThreads;
  ingest_slots_world_kernel<<<(unsigned)grid, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      tkey, anchors, T, K, bx, by, bz, wkey, scan_count);
  return (int)cudaGetLastError();
}

// Launch K7w's gather on ``stream``: T >= 1 sorted rows; ``centres`` null
// for no centres.  Returns cudaGetLastError().
extern "C" int la3dm_ingest_slots_gather(const int64_t* perm, const int32_t* rid,
                                         const int32_t* uslots, const int64_t* ukey,
                                         long long T, int bx, int by, int bz, float bs,
                                         int32_t* slots, float* centres, void* stream) {
  if (T <= 0 || T >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const long long grid = (T + kThreads - 1) / kThreads;
  ingest_slots_gather_kernel<<<(unsigned)grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      perm, rid, uslots, ukey, T, bx, by, bz, bs, slots, centres);
  return (int)cudaGetLastError();
}
