// Shared device helpers for the SVC kernels: the splitmix32 mixer and the
// u01 conversion, bit-identical to repro/core/hashing.py (Prop. 2 needs the
// CUDA, torch and JAX hashes to agree bit for bit).
#pragma once

#include <atomic>
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

// The card this host thread launches on.  The Python wrappers make the
// card that holds a call's tensors current before they call an entry point.
inline int current_device() {
  int d = 0;
  cudaGetDevice(&d);
  return d;
}

constexpr int kMaxDevices = 64;

// A launch fact that belongs to one card: its SM count and occupancy, a
// kernel's dynamic shared memory granted by cudaFuncSetAttribute (which
// acts on the current device only).  A function-scope static of this type
// keeps one slot per card, so every entry point is right on any card.
template <typename T>
class PerDevice {
 public:
  // The current card's slot, or nullptr past kMaxDevices cards.
  T* slot() {
    const int d = current_device();
    return d >= 0 && d < kMaxDevices ? &value_[d] : nullptr;
  }

  // The current card's value: make(device) on the card's first call.
  template <typename F>
  T get(F&& make) {
    const int d = current_device();
    if (d < 0 || d >= kMaxDevices) return make(d);
    if (!ready_[d].load(std::memory_order_acquire)) {
      value_[d] = make(d);
      ready_[d].store(true, std::memory_order_release);
    }
    return value_[d];
  }

 private:
  T value_[kMaxDevices] = {};
  std::atomic<bool> ready_[kMaxDevices] = {};
};

// cudaFuncSetAttribute(kernel, MaxDynamicSharedMemorySize, bytes) once on
// each card: ``cards`` is the call site's static table.
template <typename K>
cudaError_t allow_smem(PerDevice<cudaError_t>& cards, K kernel, int bytes) {
  return cards.get([&](int) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  });
}

}  // namespace svc
