// Fused η hash-threshold + outlier-index membership (SVC §6.2).
//
// Replaces the Pallas kernel src/repro/kernels/outlier_member/kernel.py:
// outlier_member_tiles (body _outlier_member_kernel).  The TPU version
// broadcast-compares each row tile against the whole (2, Kp) digest table in
// VMEM and falls back to XLA beyond 2048 keys.  Here each thread takes one
// probe row, folds every key column through one splitmix32 pass that feeds
// three hashes (η, and the hi/lo lanes of the 64-bit digest), and binary-
// searches the lexicographically sorted digest table.  One kernel serves
// every K: a table of at most 2048 keys (16 KiB) is staged in shared memory
// per block; a larger one is searched in device memory, where its upper
// levels stay in L1/L2.
//
// Bound: device memory for the probe stream (4 bytes per key column in,
// 4 bytes of code out per row); the log2 K search steps hit shared memory
// or cache.  Code bit 0 = keep (η ∨ member), bit 1 = member.  A row whose
// first key is SENTINEL_KEY is never a member.
#include "svc_common.cuh"

constexpr int64_t kSmemKeys = 2048;

__device__ __forceinline__ bool digest_member(const uint32_t* khi, const uint32_t* klo,
                                              int64_t k, uint32_t hi, uint32_t lo) {
  int64_t a = 0, b = k;  // first index whose (hi, lo) ≥ the probe digest
  while (a < b) {
    const int64_t mid = (a + b) >> 1;
    const uint32_t mh = khi[mid], ml = klo[mid];
    if (mh < hi || (mh == hi && ml < lo)) {
      a = mid + 1;
    } else {
      b = mid;
    }
  }
  return a < k && khi[a] == hi && klo[a] == lo;
}

template <int N, bool SMEM>
__global__ void outlier_member_kernel(svc::KeyCols cols, int64_t rows,
                                      const uint32_t* __restrict__ khi,
                                      const uint32_t* __restrict__ klo, int64_t k,
                                      uint32_t seed_eta, uint32_t seed_hi, uint32_t seed_lo,
                                      float thresh, int32_t* __restrict__ out) {
  extern __shared__ uint32_t table[];
  const uint32_t* thi = khi;
  const uint32_t* tlo = klo;
  if (SMEM) {
    for (int64_t j = threadIdx.x; j < k; j += blockDim.x) {
      table[j] = khi[j];
      table[k + j] = klo[j];
    }
    __syncthreads();
    thi = table;
    tlo = table + k;
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < rows;
       i += stride) {
    uint32_t he = seed_eta, hh = seed_hi, hl = seed_lo;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const uint32_t mc = svc::splitmix32(static_cast<uint32_t>(cols.c[j][i]));
      he = svc::splitmix32(he ^ mc);
      hh = svc::splitmix32(hh ^ mc);
      hl = svc::splitmix32(hl ^ mc);
    }
    const bool eta = svc::u01(he) < thresh;
    const bool member = cols.c[0][i] != svc::SENTINEL_KEY && digest_member(thi, tlo, k, hh, hl);
    out[i] = static_cast<int32_t>(eta || member) | (static_cast<int32_t>(member) << 1);
  }
}

template <int N>
static void launch(bool smem, int grid, int block, cudaStream_t s, svc::KeyCols cols,
                   int64_t rows, const uint32_t* khi, const uint32_t* klo, int64_t k,
                   uint32_t se, uint32_t sh, uint32_t sl, float thresh, int32_t* out) {
  if (smem) {
    const size_t bytes = static_cast<size_t>(2 * k) * sizeof(uint32_t);
    outlier_member_kernel<N, true><<<grid, block, bytes, s>>>(cols, rows, khi, klo, k, se, sh,
                                                              sl, thresh, out);
  } else {
    outlier_member_kernel<N, false><<<grid, block, 0, s>>>(cols, rows, khi, klo, k, se, sh, sl,
                                                           thresh, out);
  }
}

extern "C" int svc_outlier_member(const int32_t* c0, const int32_t* c1, const int32_t* c2,
                                  const int32_t* c3, int ncols, int64_t rows,
                                  const uint32_t* khi, const uint32_t* klo, int64_t k,
                                  uint32_t seed_eta, uint32_t seed_hi, uint32_t seed_lo,
                                  float thresh, int32_t* out, void* stream) {
  svc::KeyCols cols{{c0, c1, c2, c3}};
  const int block = 256;
  const int grid = svc::grid_for(rows, block);
  const bool smem = k <= kSmemKeys;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ncols) {
    case 1: launch<1>(smem, grid, block, s, cols, rows, khi, klo, k, seed_eta, seed_hi, seed_lo, thresh, out); break;
    case 2: launch<2>(smem, grid, block, s, cols, rows, khi, klo, k, seed_eta, seed_hi, seed_lo, thresh, out); break;
    case 3: launch<3>(smem, grid, block, s, cols, rows, khi, klo, k, seed_eta, seed_hi, seed_lo, thresh, out); break;
    case 4: launch<4>(smem, grid, block, s, cols, rows, khi, klo, k, seed_eta, seed_hi, seed_lo, thresh, out); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
