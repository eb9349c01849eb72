// K7c — the closed-box membership expansion of device scan ingest,
// hand-written for Hopper (sm_90a).
//
// Replaces la3dm_tpu/geometry/device_ingest.py::_closed_box_memberships
// (lines 256-283) and the key packing of _local_keys (lines 286-295).  For
// each training entry e of scan s (one thread), per axis:
//   base = floor(e / bs + 0.5), and the closed-box test
//   ctr - half <= e <= ctr + half with ctr = c * bs, for c = base, base+1,
//   base-1 (all in f32); at most two of the three pass, so the second
//   candidate is base+1 if it passes, else base-1.
// Candidate j (bits (j>>2, j>>1, j) & 1 on x, y, z, the JAX meshgrid order)
// takes base where its bit is 0 and the second candidate where it is 1; it
// is a membership iff each axis's test passes and the entry is valid.  Its
// block key (ingest_keys.cuh) or the sentinel goes to mkey[8e + j]: the
// entry-major order the stable sort by key then turns into per-block runs.
// What bounds it: bytes (16 bytes in, 64 out per entry).

#include <cuda_runtime.h>
#include <stdint.h>

#include "ingest_keys.cuh"

namespace {

__global__ void ingest_members_kernel(const float* __restrict__ ent,       // [E,3]
                                      const int32_t* __restrict__ scan,    // [E]
                                      const bool* __restrict__ evalid,     // [E]
                                      const int32_t* __restrict__ anchors, // [K,3]
                                      int64_t E, float bs, float half,
                                      int64_t* __restrict__ mkey) {        // [E*8]
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  int base[3], second[3];
  bool base_ok[3], sec_ok[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float v = ent[3 * e + a];
    const int b = (int)floorf(v / bs + 0.5f);
    bool ok[3];  // base, base + 1, base - 1
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float ctr = (float)(b + (c == 0 ? 0 : (c == 1 ? 1 : -1))) * bs;
      ok[c] = (ctr - half <= v) && (v <= ctr + half);
    }
    base[a] = b;
    base_ok[a] = ok[0];
    second[a] = ok[1] ? b + 1 : b - 1;
    sec_ok[a] = ok[1] || ok[2];
  }
  const bool valid = evalid[e];
  const int s = scan[e];
  const int32_t* anchor = anchors + 3 * s;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int bx = (j >> 2) & 1, by = (j >> 1) & 1, bz = j & 1;
    const bool ok = valid && (bx ? sec_ok[0] : base_ok[0]) && (by ? sec_ok[1] : base_ok[1])
                    && (bz ? sec_ok[2] : base_ok[2]);
    mkey[8 * e + j] = ok ? pack_key(s, bx ? second[0] : base[0], by ? second[1] : base[1],
                                    bz ? second[2] : base[2], anchor)
                         : kSentinel;
  }
}

constexpr int kThreads = 256;

}  // namespace

// Launch K7c on ``stream``: one thread per entry.  Returns cudaGetLastError().
extern "C" int la3dm_ingest_members(const float* ent, const int32_t* scan,
                                    const bool* evalid, const int32_t* anchors,
                                    long long E, float bs, float half, int64_t* mkey,
                                    void* stream) {
  if (E <= 0) return (int)cudaErrorInvalidValue;
  const long long grid = (E + kThreads - 1) / kThreads;
  ingest_members_kernel<<<(unsigned)grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      ent, scan, evalid, anchors, E, bs, half, mkey);
  return (int)cudaGetLastError();
}
