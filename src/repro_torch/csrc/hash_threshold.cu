// η_{a,m} hash-threshold mask (SVC §4.4).
//
// Replaces the Pallas kernel src/repro/kernels/hash_threshold/kernel.py:
// hash_threshold_tiles (body _hash_threshold_kernel).  The TPU version tiles
// key columns as (64, 128) VMEM blocks; here each thread hashes one row in a
// grid-stride loop.
//
// Bound: device memory.  Per row it reads 4 bytes per key column and writes
// one byte, with ~10 integer operations per column in between, far below
// the card's integer rate.  The design keeps the mixer in registers and
// makes every access a coalesced 4-byte (or 1-byte) stream, so the kernel
// moves only those (4n + 1) bytes per row.
//
// The threshold arrives as the float32 value of m: the JAX package compares
// u < f32(m), and comparing against a double would flip hashes that land
// just under the threshold.
#include "svc_common.cuh"

template <int N>
__global__ void hash_threshold_kernel(svc::KeyCols cols, int64_t n, uint32_t seed_mix,
                                      float thresh, uint8_t* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    uint32_t h = seed_mix;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      h = svc::splitmix32(h ^ svc::splitmix32(static_cast<uint32_t>(__ldg(cols.c[j] + i))));
    }
    out[i] = svc::u01(h) < thresh ? 1 : 0;
  }
}

extern "C" int svc_hash_threshold(const int32_t* c0, const int32_t* c1, const int32_t* c2,
                                  const int32_t* c3, int ncols, int64_t n, uint32_t seed_mix,
                                  float thresh, uint8_t* out, void* stream) {
  svc::KeyCols cols{{c0, c1, c2, c3}};
  const int block = 256;
  const int grid = svc::grid_for(n, block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ncols) {
    case 1: hash_threshold_kernel<1><<<grid, block, 0, s>>>(cols, n, seed_mix, thresh, out); break;
    case 2: hash_threshold_kernel<2><<<grid, block, 0, s>>>(cols, n, seed_mix, thresh, out); break;
    case 3: hash_threshold_kernel<3><<<grid, block, 0, s>>>(cols, n, seed_mix, thresh, out); break;
    case 4: hash_threshold_kernel<4><<<grid, block, 0, s>>>(cols, n, seed_mix, thresh, out); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
