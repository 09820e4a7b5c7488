// Group-by partial aggregation: out[g, c] = Σ_{i : gid[i] == g} vals[i, c].
//
// Replaces the Pallas kernel src/repro/kernels/segment_aggsum/kernel.py:
// segment_sum_tiles (body _segsum_kernel).  The TPU version builds a
// (rows × 128 groups) one-hot tile and multiplies it into the values on the
// MXU, revisiting each group tile across the sequential row grid — O(R·G)
// work that only a matrix unit makes cheap.  Here each thread takes one
// (row, column) element, and the elements reach the zeroed (G, C) float32
// output through float atomics; rows whose gid lies outside [0, G) — the
// group-by's overflow slot G among them — are dropped, as
// jax.ops.segment_sum drops them.  No padding: lanes past the end carry
// nothing.
//
// Bound: device memory for the stream (4 bytes of gid per row, 4 bytes per
// in-range element, 4·G·C bytes of output).  Atomics to one address
// serialise, and the group-by hands its ids over sorted, so a Zipf-hot
// group's rows arrive as one long run.  Lanes of a warp therefore walk
// consecutive rows of one column, and a segmented inclusive scan over the
// warp (shuffles, in lane order) sums each run of equal gids; only the
// run's last lane adds into the output.  A warp of a hot run makes one
// atomic instead of 32.  Sums still depend on the order of the adds across
// warps and vary in their last bits from run to run; a column of ones
// counts exactly while a group holds fewer than 2^24 rows.
#include "svc_common.cuh"

__global__ void segment_sum_kernel(const int32_t* __restrict__ gid,
                                   const float* __restrict__ vals, int64_t rows, int ncols,
                                   int64_t groups, float* __restrict__ out) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int64_t n = rows * ncols;
  // warp-aligned grid-stride loop: every lane of a warp takes the same
  // number of steps, so the shuffles below always see the whole warp
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * blockDim.x + (threadIdx.x & ~31);
       base < n; base += stride) {
    // element e = c·rows + i: consecutive lanes, consecutive rows of one column
    const int64_t e = base + lane;
    int64_t key = -1;  // (group, column) of an in-range element, else -1
    float v = 0.0f;
    if (e < n) {
      const int64_t c = e / rows;
      const int64_t i = e - c * rows;
      const int32_t g = gid[i];
      if (g >= 0 && static_cast<int64_t>(g) < groups) {
        key = static_cast<int64_t>(g) * ncols + c;
        v = vals[i * ncols + c];
      }
    }
    const int64_t prev = __shfl_up_sync(full, key, 1);
    const int64_t next = __shfl_down_sync(full, key, 1);
    bool head = lane == 0 || prev != key;  // first lane of its run
    // segmented inclusive scan: v becomes the sum from the run's head to here
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(full, v, off);
      const bool up_head = __shfl_up_sync(full, static_cast<int>(head), off) != 0;
      if (lane >= off && !head) {
        v += up;
        head = up_head;
      }
    }
    if (key >= 0 && (lane == 31 || next != key)) atomicAdd(out + key, v);
  }
}

extern "C" int svc_segment_sum(const int32_t* gid, const float* vals, int64_t rows, int ncols,
                               int64_t groups, float* out, void* stream) {
  const int block = 256;
  const int grid = svc::grid_for(rows * ncols, block);
  segment_sum_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      gid, vals, rows, ncols, groups, out);
  return static_cast<int>(cudaGetLastError());
}
