// Fused SVC+CORR moments: (Σd, Σd², Σmask) for d = (t_new − t_old)·mask
// over the correspondence-joined row space (Def. 4 with the §5.2.1
// moments), in one pass without materialising the diff column.
//
// Replaces the Pallas kernel src/repro/kernels/corr_diff/kernel.py:
// corr_diff_tiles (body _corr_diff_kernel).  The TPU version reshapes the
// inputs to (R, 128) tiles and adds each tile's three sums into one (8, 128)
// accumulator block that the sequential grid revisits.  Blocks on a GPU run
// in no order, so one launch does it in two steps:
//   * A persistent grid (as many blocks as fit, no more than the rows need)
//     strides over the rows.  On the vector route (t_new and t_old 16-byte
//     aligned, the mask 4-byte aligned) a lane loads four rows of each
//     stream as one 16-byte word (the mask as one 4-byte word), consecutive
//     lanes on consecutive words, kWords words of each stream in flight
//     before it adds any; block 0 takes the last n mod 4 rows.  The scalar
//     route (any alignment) loads one row of each stream a step, kWords
//     steps in flight.  Each block reduces its rows in a fixed order
//     (thread sums, warp shuffles, warps in index order) into three float64
//     partials in a persistent workspace.
//   * The last block to arrive (a __threadfence, then a ticket, which it
//     resets to 0 for the next launch) sums every partial in a fixed order
//     and writes the three outputs.
// The grid depends only on n, so a call gives the same bits every time.
// Per-row d and d² round in float32 as the plain version's do; the sums are
// carried in float64 and rounded once, so the result differs from a float32
// sum in any order only by that sum's own rounding.  Every row adds its
// terms, masked or not: an inf − inf or inf · 0 row makes the sums NaN, as
// in the reference.  The mask may be bool or int8 (one byte; its value
// converts to float, as astype(float32) does).
//
// Bound: device memory.  Each row is read once (9 bytes); the arithmetic
// is 5 flops per row.
#include "svc_common.cuh"

namespace {

constexpr int kMoments = 3;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWords = 4;  // words (vector) or rows (scalar) of each stream in flight

struct Params {
  const float* t_new;
  const float* t_old;
  const int8_t* mask;
  int64_t n;
  double* partials;  // (gridDim.x, 3)
  int* ticket;       // 0 between launches
  float* out;        // (3,)
};

__device__ __forceinline__ void add_row(double (&acc)[kMoments], float a, float b, int8_t mk) {
  const float m = static_cast<float>(mk);
  const float d = __fmul_rn(__fsub_rn(a, b), m);
  acc[0] += static_cast<double>(d);
  acc[1] += static_cast<double>(__fmul_rn(d, d));
  acc[2] += static_cast<double>(m);
}

__device__ __forceinline__ double warp_sum(double x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

// the block's three sums in a fixed order, on thread 0
__device__ __forceinline__ void block_sum(double (&acc)[kMoments], double (&red)[kWarps][kMoments]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < kMoments; ++k) {
    const double s = warp_sum(acc[k]);
    if (lane == 0) red[warp][k] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kMoments; ++k) {
      double s = 0.0;
      for (int w = 0; w < kWarps; ++w) s += red[w][k];
      acc[k] = s;
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads) corr_diff_kernel(Params p) {
  __shared__ double red[kWarps][kMoments];
  __shared__ bool last_block;
  double acc[kMoments] = {0.0, 0.0, 0.0};
  if (VEC) {
    const int64_t words = p.n >> 2;
    const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads * kWords;
    for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads * kWords + threadIdx.x;
         base < words; base += step) {
      float4 a[kWords], b[kWords];
      uint32_t m[kWords];
#pragma unroll
      for (int u = 0; u < kWords; ++u) {
        const int64_t w = base + static_cast<int64_t>(u) * kThreads;
        if (w < words) {
          a[u] = __ldg(reinterpret_cast<const float4*>(p.t_new) + w);
          b[u] = __ldg(reinterpret_cast<const float4*>(p.t_old) + w);
          m[u] = __ldg(reinterpret_cast<const uint32_t*>(p.mask) + w);
        }
      }
#pragma unroll
      for (int u = 0; u < kWords; ++u) {
        if (base + static_cast<int64_t>(u) * kThreads < words) {
          add_row(acc, a[u].x, b[u].x, static_cast<int8_t>(m[u]));
          add_row(acc, a[u].y, b[u].y, static_cast<int8_t>(m[u] >> 8));
          add_row(acc, a[u].z, b[u].z, static_cast<int8_t>(m[u] >> 16));
          add_row(acc, a[u].w, b[u].w, static_cast<int8_t>(m[u] >> 24));
        }
      }
    }
    if (blockIdx.x == 0 && threadIdx.x < (p.n & 3)) {
      const int64_t i = (words << 2) + threadIdx.x;
      add_row(acc, p.t_new[i], p.t_old[i], p.mask[i]);
    }
  } else {
    const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads * kWords;
    for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads * kWords + threadIdx.x;
         base < p.n; base += step) {
      float a[kWords], b[kWords];
      int8_t m[kWords];
#pragma unroll
      for (int u = 0; u < kWords; ++u) {
        const int64_t i = base + static_cast<int64_t>(u) * kThreads;
        if (i < p.n) {
          a[u] = __ldg(p.t_new + i);
          b[u] = __ldg(p.t_old + i);
          m[u] = __ldg(p.mask + i);
        }
      }
#pragma unroll
      for (int u = 0; u < kWords; ++u) {
        if (base + static_cast<int64_t>(u) * kThreads < p.n) add_row(acc, a[u], b[u], m[u]);
      }
    }
  }

  block_sum(acc, red);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kMoments; ++k) p.partials[blockIdx.x * kMoments + k] = acc[k];
    __threadfence();
    last_block = atomicAdd(p.ticket, 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!last_block) return;
  __threadfence();

  // the last block: every block's partials, thread t taking blocks t, t + 256, …
#pragma unroll
  for (int k = 0; k < kMoments; ++k) acc[k] = 0.0;
  for (int c = threadIdx.x; c < static_cast<int>(gridDim.x); c += kThreads) {
#pragma unroll
    for (int k = 0; k < kMoments; ++k) acc[k] += __ldcg(p.partials + c * kMoments + k);
  }
  block_sum(acc, red);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < kMoments; ++k) p.out[k] = __double2float_rn(acc[k]);
    *p.ticket = 0;
  }
}

template <bool VEC>
int launch(const Params& p, int max_blocks, cudaStream_t s) {
  static svc::PerDevice<int> cards;  // blocks each card holds at once
  const int resident = cards.get([](int dev) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, corr_diff_kernel<VEC>, kThreads, 0);
    return sms * (per_sm < 1 ? 1 : per_sm);
  });
  const int64_t chunk = static_cast<int64_t>(kThreads) * kWords * (VEC ? 4 : 1);
  int64_t grid = (p.n + chunk - 1) / chunk;
  if (grid > resident) grid = resident;
  if (grid > max_blocks) grid = max_blocks;
  if (grid < 1) grid = 1;
  corr_diff_kernel<VEC><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// partials: max_blocks·3 doubles and ticket: one int, both from the
// wrapper's persistent workspace (the ticket zeroed once); vec: 1 for the
// vector route (the wrapper checks its alignments), 0 for the scalar one.
extern "C" int svc_corr_diff(const float* t_new, const float* t_old, const int8_t* mask,
                             int64_t n, double* partials, int* ticket, int max_blocks, int vec,
                             float* out, void* stream) {
  if (n < 1 || max_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Params p{t_new, t_old, mask, n, partials, ticket, out};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec != 0 ? launch<true>(p, max_blocks, s) : launch<false>(p, max_blocks, s);
}
