// Fused η-filter + group-by count/sum over delta rows (the SVC clean loop, §4.5).
//
// Replaces the Pallas kernel src/repro/kernels/fused_clean/kernel.py:
// fused_clean_tiles (body _fused_clean_kernel).  The TPU version folds the
// keep decision into a (rows × 128 groups) one-hot tile and accumulates
// onehotᵀ @ [1 | vals] on the MXU, revisiting each group tile across the
// sequential row grid.  Blocks on a GPU run in no order, and at the main
// path's 2^20 groups no per-block copy of the output fits in shared memory
// (2^20 × (1 + C) × 4 bytes), so each thread takes one delta row and adds
// [1 | vals] into the zeroed (G, 1 + C) output with float atomics.
//
// Bound: device memory for the row stream (gid, valid, pin: 6 bytes per
// row; vals only for kept rows) plus the atomic traffic of kept rows.
// Atomics to one address serialise: a Zipf-hot group that keeps millions of
// rows is the known cost of this design (a warp-aggregated or sorted,
// fixed-order reduction is later work).  Counts stay exact because every
// increment is 1.0 and a group's total stays below 2^24; sums depend on the
// order of the adds and so vary in their last bits from run to run.
#include "svc_common.cuh"

__global__ void fused_clean_kernel(const int32_t* __restrict__ gid,
                                   const uint8_t* __restrict__ valid,
                                   const uint8_t* __restrict__ pin,
                                   const float* __restrict__ vals, int64_t rows, int ncols,
                                   int64_t groups, uint32_t seed_mix, float thresh,
                                   float* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int width = ncols + 1;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < rows;
       i += stride) {
    if (!valid[i]) continue;
    const int32_t g = gid[i];
    if (g < 0 || static_cast<int64_t>(g) >= groups) continue;  // segment_sum drops these
    bool keep = svc::u01(svc::splitmix32(seed_mix ^ svc::splitmix32(static_cast<uint32_t>(g)))) <
                thresh;
    if (pin != nullptr) keep = keep || pin[i] != 0;
    if (!keep) continue;
    float* row = out + static_cast<int64_t>(g) * width;
    atomicAdd(row, 1.0f);
    for (int c = 0; c < ncols; ++c) atomicAdd(row + 1 + c, vals[i * ncols + c]);
  }
}

extern "C" int svc_fused_clean(const int32_t* gid, const uint8_t* valid, const uint8_t* pin,
                               const float* vals, int64_t rows, int ncols, int64_t groups,
                               uint32_t seed_mix, float thresh, float* out, void* stream) {
  const int block = 256;
  const int grid = svc::grid_for(rows, block);
  fused_clean_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      gid, valid, pin, vals, rows, ncols, groups, seed_mix, thresh, out);
  return static_cast<int>(cudaGetLastError());
}
