// The bottom-up raster prune of one block in shared memory, shared by the
// light-pass kernels K2 (csrc/bgk_light.cu) and K5 (csrc/gp_light.cu).
//
// The port of la3dm_tpu/models/pruning.py::prune_blocks for one block held
// by one CTA, one thread per voxel v (raster, x fastest; V = n^3 <= 1024).
// The caller fills the shared arrays — two float fields f0/f1, touched, eff
// and each voxel's state under its family's rules — and every thread calls
// raster_prune.  Levels L = 1..max_level: a 2^L-aligned group collapses iff
// every voxel in it has eff == L-1, every voxel has the same state, and that
// state is not UNKNOWN; the minimum-corner voxel's f0, f1, touched and state
// are copied to the group and eff is set to L.  On return the arrays hold
// the pruned block and every thread has passed a __syncthreads().

#pragma once

#include <stdint.h>

namespace la3dm {

constexpr int kMaxV = 1024;
constexpr int8_t kFree = 0, kOccupied = 1, kUnknown = 2;

static __device__ __forceinline__ void raster_prune(float* f0, float* f1,
                                                    uint8_t* sT, int8_t* sE,
                                                    int8_t* sS, int v, int n,
                                                    int max_level) {
  __syncthreads();  // every voxel's inputs are in shared memory
  const int x = v % n, y = (v / n) % n, z = v / (n * n);
  for (int L = 1; L <= max_level; ++L) {
    const int m = 1 << L;
    const int bx = x & ~(m - 1), by = y & ~(m - 1), bz = z & ~(m - 1);
    const int c = bx + by * n + bz * n * n;  // minimum corner of the group
    const int8_t st = sS[c];
    bool ok = st != kUnknown;
    for (int dz = 0; dz < m && ok; ++dz)
      for (int dy = 0; dy < m && ok; ++dy)
        for (int dx = 0; dx < m && ok; ++dx) {
          const int u = (bx + dx) + (by + dy) * n + (bz + dz) * n * n;
          ok = sE[u] == L - 1 && sS[u] == st;
        }
    const float c0 = f0[c], c1 = f1[c];
    const uint8_t cT = sT[c];
    __syncthreads();  // every thread has read the level's inputs
    if (ok) {
      f0[v] = c0;
      f1[v] = c1;
      sT[v] = cT;
      sS[v] = st;
      sE[v] = (int8_t)L;
    }
    __syncthreads();
  }
}

}  // namespace la3dm
