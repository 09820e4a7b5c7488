// Shared device helpers for the SVC kernels: the splitmix32 mixer and the
// u01 conversion, bit-identical to repro/core/hashing.py (Prop. 2 needs the
// CUDA, torch and JAX hashes to agree bit for bit).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace svc {

constexpr int32_t SENTINEL_KEY = 0x7FFFFFFF;

__device__ __forceinline__ uint32_t splitmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// uint32 → f32 rounds to nearest, as XLA's convert does; hashes within
// about 128 of 2^32 become u = 1.0.
__device__ __forceinline__ float u01(uint32_t h) {
  return __uint2float_rn(h) * 0x1p-32f;
}

// Up to four int32 key columns of a composite key, passed by value.
struct KeyCols {
  const int32_t* c[4];
};

// Grid for a grid-stride loop: enough blocks to fill 132 SMs, no more.
inline int grid_for(int64_t n, int block) {
  int64_t g = (n + block - 1) / block;
  const int64_t cap = 132 * 16;
  if (g < 1) g = 1;
  if (g > cap) g = cap;
  return static_cast<int>(g);
}

}  // namespace svc
