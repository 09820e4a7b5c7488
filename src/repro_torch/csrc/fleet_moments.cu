// Batched fleet moment pass: N̂, S1, S2, HT_AQP and HT_CORR of every view's
// canonical query from one scan of the stacked fleet panel (the planner's
// per-epoch moment snapshot, §5.2.2).
//
// Replaces the Pallas kernel src/repro/kernels/fleet_moments/kernel.py:
// fleet_moments_tiles (body _fleet_moments_kernel).  The TPU version
// transposes the eight (V, R) channel panels so that views lie on lanes
// and carries a (8, V) accumulator across the sequential row grid.  Here
// the host's (V, R) layout stays — one view's rows are contiguous — and
// the grid is (row chunk, view): each block reduces its chunk's five
// moments in a fixed order (per-thread strided sums, warp shuffles, warps
// in index order) into per-chunk partials, and a second launch sums the
// partials of each view in a fixed tree.  The result is the same from run
// to run.  Per-row products round in float32 as in the plain version; the
// sums are carried in float64, so the result differs from a float32 sum
// in any order only by that sum's own rounding.
//
// Bound: device memory.  Each of the 8 × V × R float32 channel values is
// read once (the fleet panel at 16 views × 2^21 rows is 1.07 GB); the
// arithmetic is ~20 flops per row.
#include "svc_common.cuh"

namespace {

constexpr int kMoments = 5;
constexpr int kBlock = 256;

struct Panels {
  const float* xn;
  const float* vn;
  const float* wn;
  const float* on;
  const float* xo;
  const float* vo;
  const float* wo;
  const float* oo;
};

__device__ __forceinline__ double warp_sum(double x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

__global__ void __launch_bounds__(kBlock)
fleet_moments_partials(Panels p, int64_t rows, int64_t view_stride, int rows_per_block,
                       double* __restrict__ partials) {
  __shared__ double red[kBlock / 32][kMoments];
  const int64_t v = blockIdx.y;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t r1 = r0 + rows_per_block < rows ? r0 + rows_per_block : rows;
  const int64_t base = v * view_stride;
  double acc[kMoments] = {0.0, 0.0, 0.0, 0.0, 0.0};
  for (int64_t r = r0 + threadIdx.x; r < r1; r += kBlock) {
    const int64_t i = base + r;
    const float xn = p.xn[i], vn = p.vn[i], wn = p.wn[i], on = p.on[i];
    const float t_new = __fmul_rn(__fmul_rn(wn, xn), vn);
    const float t_old = __fmul_rn(__fmul_rn(p.wo[i], p.xo[i]), p.vo[i]);
    const float d = __fsub_rn(t_new, t_old);
    acc[0] += static_cast<double>(__fmul_rn(vn, wn));
    acc[1] += static_cast<double>(t_new);
    acc[2] += static_cast<double>(__fmul_rn(t_new, xn));
    acc[3] += static_cast<double>(__fmul_rn(__fmul_rn(on, t_new), t_new));
    acc[4] += static_cast<double>(__fmul_rn(__fmul_rn(fminf(on, p.oo[i]), d), d));
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
    partials[(v * gridDim.x + blockIdx.x) * kMoments + threadIdx.x] = s;
  }
}

// out[v, k] = Σ_c partials[v, c, k]: one block per view, each thread sums a
// strided subset of the chunks, then a fixed shared-memory tree.
__global__ void __launch_bounds__(kBlock)
fleet_moments_finish(const double* __restrict__ partials, int chunks, float* __restrict__ out) {
  __shared__ double red[kBlock];
  const int64_t v = blockIdx.x;
  for (int k = 0; k < kMoments; ++k) {
    double s = 0.0;
    for (int c = threadIdx.x; c < chunks; c += kBlock) s += partials[(v * chunks + c) * kMoments + k];
    red[threadIdx.x] = s;
    __syncthreads();
    for (int width = kBlock / 2; width > 0; width >>= 1) {
      if (threadIdx.x < width) red[threadIdx.x] += red[threadIdx.x + width];
      __syncthreads();
    }
    if (threadIdx.x == 0) out[v * kMoments + k] = static_cast<float>(red[0]);
    __syncthreads();
  }
}

}  // namespace

extern "C" int svc_fleet_moments(const float* xn, const float* vn, const float* wn,
                                 const float* on, const float* xo, const float* vo,
                                 const float* wo, const float* oo, int64_t views, int64_t rows,
                                 int64_t view_stride, int rows_per_block, double* partials,
                                 float* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Panels p{xn, vn, wn, on, xo, vo, wo, oo};
  int64_t chunks = (rows + rows_per_block - 1) / rows_per_block;
  if (chunks < 1) chunks = 1;
  const dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(views));
  fleet_moments_partials<<<grid, kBlock, 0, s>>>(p, rows, view_stride, rows_per_block, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fleet_moments_finish<<<static_cast<unsigned>(views), kBlock, 0, s>>>(
      partials, static_cast<int>(chunks), out);
  return static_cast<int>(cudaGetLastError());
}
