// Fused SVC+CORR moments: (Σd, Σd², Σmask) for d = (t_new − t_old)·mask
// over the correspondence-joined row space (Def. 4 with the §5.2.1
// moments), in one pass without materialising the diff column.
//
// Replaces the Pallas kernel src/repro/kernels/corr_diff/kernel.py:
// corr_diff_tiles (body _corr_diff_kernel).  The TPU version reshapes the
// inputs to (R, 128) tiles and adds each tile's three sums into one (8, 128)
// accumulator block that the sequential grid revisits.  Blocks on a GPU run
// in no order, so each block reduces its chunk of rows in a fixed order
// (per-thread strided sums, warp shuffles, warps in index order) into its
// own three partials, and a second launch sums the partials in a fixed
// shared-memory tree: the same bits on every run.  Per-row d and d² round
// in float32 as the plain version's do; the sums are carried in float64,
// so the result differs from a float32 sum in any order only by that sum's
// own rounding.  The mask may be bool or int8 (one byte; its value
// converts to float, as astype(float32) does).
//
// Bound: device memory.  Each row is read once (9 bytes); the arithmetic
// is 5 flops per row.
#include "svc_common.cuh"

namespace {

constexpr int kMoments = 3;
constexpr int kBlock = 256;

__device__ __forceinline__ double warp_sum(double x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

__global__ void __launch_bounds__(kBlock)
corr_diff_partials(const float* __restrict__ t_new, const float* __restrict__ t_old,
                   const int8_t* __restrict__ mask, int64_t rows, int rows_per_block,
                   double* __restrict__ partials) {
  __shared__ double red[kBlock / 32][kMoments];
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t r1 = r0 + rows_per_block < rows ? r0 + rows_per_block : rows;
  double acc[kMoments] = {0.0, 0.0, 0.0};
  for (int64_t r = r0 + threadIdx.x; r < r1; r += kBlock) {
    const float m = static_cast<float>(mask[r]);
    const float d = __fmul_rn(__fsub_rn(t_new[r], t_old[r]), m);
    acc[0] += static_cast<double>(d);
    acc[1] += static_cast<double>(__fmul_rn(d, d));
    acc[2] += static_cast<double>(m);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kMoments; ++k) {
    const double s = warp_sum(acc[k]);
    if (lane == 0) red[warp][k] = s;
  }
  __syncthreads();
  if (threadIdx.x < kMoments) {
    double s = 0.0;
    for (int w = 0; w < kBlock / 32; ++w) s += red[w][threadIdx.x];
    partials[static_cast<int64_t>(blockIdx.x) * kMoments + threadIdx.x] = s;
  }
}

// out[k] = Σ_c partials[c, k]: each thread sums a strided subset of the
// chunks, then a fixed shared-memory tree.
__global__ void __launch_bounds__(kBlock)
corr_diff_finish(const double* __restrict__ partials, int chunks, float* __restrict__ out) {
  __shared__ double red[kBlock];
  for (int k = 0; k < kMoments; ++k) {
    double s = 0.0;
    for (int c = threadIdx.x; c < chunks; c += kBlock) s += partials[c * kMoments + k];
    red[threadIdx.x] = s;
    __syncthreads();
    for (int width = kBlock / 2; width > 0; width >>= 1) {
      if (threadIdx.x < width) red[threadIdx.x] += red[threadIdx.x + width];
      __syncthreads();
    }
    if (threadIdx.x == 0) out[k] = static_cast<float>(red[0]);
    __syncthreads();
  }
}

}  // namespace

extern "C" int svc_corr_diff(const float* t_new, const float* t_old, const int8_t* mask,
                             int64_t rows, int rows_per_block, double* partials, float* out,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t chunks = (rows + rows_per_block - 1) / rows_per_block;
  if (chunks < 1) chunks = 1;
  corr_diff_partials<<<static_cast<unsigned>(chunks), kBlock, 0, s>>>(
      t_new, t_old, mask, rows, rows_per_block, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  corr_diff_finish<<<1, kBlock, 0, s>>>(partials, static_cast<int>(chunks), out);
  return static_cast<int>(cudaGetLastError());
}
