// Scan-local packed keys of the device ingest (K7a, K7b, K7c), the CUDA twin
// of la3dm_tpu_torch/kernels/ingest_keys.py.
//
// key = scan << 48 | fz << 32 | fy << 16 | fx, with each field the cell (or
// block) coordinate minus the scan's anchor plus 32768, clamped to 16 bits;
// invalid rows carry the sentinel INT64_MAX, which sorts last.  Sorting the
// keys orders rows by scan, then z, y, x: the JAX package's z-major order.
#pragma once

#include <stdint.h>

constexpr int64_t kSentinel = 0x7FFFFFFFFFFFFFFFLL;
constexpr int kFieldBias = 32768;

__device__ __forceinline__ int64_t key_field(int c, int anchor) {
  int f = c - anchor + kFieldBias;
  f = f < 0 ? 0 : (f > 0xFFFF ? 0xFFFF : f);
  return (int64_t)f;
}

__device__ __forceinline__ int64_t pack_key(int scan, int x, int y, int z,
                                            const int32_t* anchor) {
  return ((int64_t)scan << 48) | (key_field(z, anchor[2]) << 32)
         | (key_field(y, anchor[1]) << 16) | key_field(x, anchor[0]);
}

// the coordinate on ``axis`` (0 = x) of a valid key, given its scan's anchor
__device__ __forceinline__ int key_coord(int64_t key, int axis, const int32_t* anchor) {
  return (int)((key >> (16 * axis)) & 0xFFFF) - kFieldBias + anchor[axis];
}
