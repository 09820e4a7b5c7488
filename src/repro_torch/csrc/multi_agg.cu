// Batched multi-query moment pass: one scan of the sample panel answers Q
// sum/count/avg queries (SVC §5, the batched query engine).
//
// Replaces the Pallas kernels src/repro/kernels/multi_agg/kernel.py:
// multi_agg_tiles_two (two-sided: clean ∥ stale ∥ diff) and
// multi_agg_tiles_one (one-sided).  The TPU version selects each query's
// value and predicate columns with one-hot matmuls on the MXU and carries a
// (16, Q) accumulator across the sequential row grid.  Here the wrapper
// turns each one-hot selector into a column index (−1 for an all-zero
// selector, read as 0.0), each block scans one chunk of rows, and each
// thread loops over the Q queries accumulating the 12 moments in registers:
//
//   K/S/SS/HT per side — count, Σt, Σt², Σ(1−π)t² of the §5.2.1 trans
//   value t; and of the diff d = t_new − t_old: K_D (joined valid rows,
//   query independent), Σd, Σd², HT_D = Σ min(1−π_new, 1−π_old)·d².
//
// A block reduces its moments in fixed order (warp shuffles, then the warps
// in index order) into per-block partials; a second small launch sums the
// partials over blocks in a fixed tree, so the result is deterministic.
//
// Bound: device memory.  The panel is read once from DRAM; the per-query
// re-reads of a block's chunk hit L1/L2.  The arithmetic is ~20 flops per
// row, query and side, far below the card's float32 rate.
#include "svc_common.cuh"

constexpr int kMoments = 12;
constexpr int kBlock = 256;

struct Side {
  const float* x;        // (R, C) row-major panel
  const uint8_t* valid;  // (R,) bool
  const float* w;        // (R,) 1/π weights
  const float* ompi;     // (R,) 1−π factors
};

__device__ __forceinline__ float column(const float* xrow, int idx) {
  return idx >= 0 ? xrow[idx] : 0.0f;
}

// §5.2.1 trans value t and row mask of one row for query q.
// sel: (1+P, Q) column indices; meta: (2+4P, Q) [is_count; is_avg; then
// (ge, gt, le, lt) per predicate term].
__device__ __forceinline__ void trans(const float* xrow, bool valid, float w,
                                      const int32_t* sel, const float* meta, int npred,
                                      int nq, int q, float& t, float& rowmask) {
  const bool is_count = meta[q] > 0.0f;
  const bool is_avg = meta[nq + q] > 0.0f;
  const float v = is_count ? 1.0f : column(xrow, sel[q]);
  bool cond = valid;
  for (int p = 0; p < npred; ++p) {
    const float tv = column(xrow, sel[(1 + p) * nq + q]);
    const float* b = meta + (2 + 4 * p) * nq + q;
    cond = cond && (tv >= b[0]) && (tv > b[nq]) && (tv <= b[2 * nq]) && (tv < b[3 * nq]);
  }
  const float w_eff = is_avg ? 1.0f : w;
  t = (cond ? v : 0.0f) * w_eff;
  rowmask = is_avg ? (cond ? 1.0f : 0.0f) : (valid ? 1.0f : 0.0f);
}

template <bool TWO>
__global__ void __launch_bounds__(kBlock)
multi_agg_partials(Side n, Side o, int64_t rows, int ncols, const int32_t* __restrict__ sel,
                   const float* __restrict__ meta, int npred, int nq, int64_t rows_per_block,
                   float* __restrict__ partials) {
  __shared__ float red[kBlock / 32][kMoments];
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t r1 = r0 + rows_per_block < rows ? r0 + rows_per_block : rows;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int q = 0; q < nq; ++q) {
    float acc[kMoments];
#pragma unroll
    for (int k = 0; k < kMoments; ++k) acc[k] = 0.0f;
    for (int64_t r = r0 + threadIdx.x; r < r1; r += kBlock) {
      float tn, mn;
      const bool vn = n.valid[r] != 0;
      trans(n.x + r * ncols, vn, n.w[r], sel, meta, npred, nq, q, tn, mn);
      const float on = n.ompi[r];
      acc[0] += mn;
      acc[1] += tn;
      acc[2] += tn * tn;
      acc[3] += on * tn * tn;
      if (TWO) {
        float to, mo;
        const bool vo = o.valid[r] != 0;
        trans(o.x + r * ncols, vo, o.w[r], sel, meta, npred, nq, q, to, mo);
        const float oo = o.ompi[r];
        acc[4] += mo;
        acc[5] += to;
        acc[6] += to * to;
        acc[7] += oo * to * to;
        const float d = tn - to;
        acc[8] += (vn || vo) ? 1.0f : 0.0f;
        acc[9] += d;
        acc[10] += d * d;
        acc[11] += fminf(on, oo) * d * d;
      }
    }
#pragma unroll
    for (int k = 0; k < kMoments; ++k) {
      for (int off = 16; off > 0; off >>= 1) acc[k] += __shfl_down_sync(0xffffffffu, acc[k], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kMoments; ++k) red[warp][k] = acc[k];
    }
    __syncthreads();
    if (threadIdx.x < kMoments) {
      float s = 0.0f;
      for (int w = 0; w < kBlock / 32; ++w) s += red[w][threadIdx.x];
      partials[(static_cast<int64_t>(blockIdx.x) * nq + q) * kMoments + threadIdx.x] = s;
    }
    __syncthreads();
  }
}

// out[k, q] = Σ_b partials[b, q, k]: one block per (k, q), each thread sums a
// strided subset of the blocks, then a fixed shared-memory tree.
__global__ void __launch_bounds__(kBlock)
multi_agg_finish(const float* __restrict__ partials, int nblocks, int nq,
                 float* __restrict__ out) {
  __shared__ float red[kBlock];
  const int i = blockIdx.x;
  const int k = i / nq, q = i % nq;
  float s = 0.0f;
  for (int b = threadIdx.x; b < nblocks; b += kBlock) {
    s += partials[(static_cast<int64_t>(b) * nq + q) * kMoments + k];
  }
  red[threadIdx.x] = s;
  __syncthreads();
  for (int width = kBlock / 2; width > 0; width >>= 1) {
    if (threadIdx.x < width) red[threadIdx.x] += red[threadIdx.x + width];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[i] = red[0];
}

extern "C" int svc_multi_agg(const float* xn, const uint8_t* vn, const float* wn,
                             const float* on, const float* xo, const uint8_t* vo,
                             const float* wo, const float* oo, int64_t rows, int ncols,
                             const int32_t* sel, const float* meta, int npred, int nq,
                             int64_t rows_per_block, int nblocks, float* partials, float* out,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Side n{xn, vn, wn, on};
  const Side o{xo, vo, wo, oo};
  if (xo != nullptr) {
    multi_agg_partials<true><<<nblocks, kBlock, 0, s>>>(n, o, rows, ncols, sel, meta, npred, nq,
                                                        rows_per_block, partials);
  } else {
    multi_agg_partials<false><<<nblocks, kBlock, 0, s>>>(n, o, rows, ncols, sel, meta, npred,
                                                         nq, rows_per_block, partials);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  multi_agg_finish<<<kMoments * nq, kBlock, 0, s>>>(partials, nblocks, nq, out);
  return static_cast<int>(cudaGetLastError());
}
