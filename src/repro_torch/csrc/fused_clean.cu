// Fused η-filter + group-by count/sum over delta rows (the SVC clean loop, §4.5).
//
// Replaces the Pallas kernel src/repro/kernels/fused_clean/kernel.py:
// fused_clean_tiles (body _fused_clean_kernel).  The TPU version folds the
// keep decision into a (rows × 128 groups) one-hot tile and accumulates
// onehotᵀ @ [1 | vals] on the MXU, revisiting each group tile across the
// sequential row grid.  Blocks on a GPU run in no order, and at the main
// path's 2^20 groups no per-block copy of the output fits in shared memory
// (2^20 × (1 + C) × 4 bytes), so each block aggregates what it sees and adds
// it into the zeroed (G, 1 + C) output with float atomics.
//
// Bound: device memory for the row stream (gid, valid, pin: 6 bytes per
// row; vals only for kept rows).  The rows arrive in no key order and a few
// Zipf-hot groups hold a large share of them (visitView's delta: ~22% in one
// video), so one global atomic per kept row serialises millions of adds on
// a few addresses.  Here each block takes a contiguous chunk of rows and
// aggregates in two stages before it touches device memory:
//   1. in the warp: the lanes whose rows share a key (__match_any_sync) sum
//      their values onto the lowest such lane in log2(peers) shuffle rounds;
//   2. in the block: that lane adds the warp's partial into an
//      open-addressing table in shared memory (key, int count, float64
//      sums), probing at most PROBES slots.  A key that finds no slot adds
//      straight into device memory, so uniform keys over 2^20 groups stay
//      correct; the rows it carried are counted in *overflow when that
//      pointer is given.
// At the end of its chunk the block flushes each occupied slot with one
// float atomic per lane of [count | sums].  A hot group then costs one
// device atomic per block, not one per row, and its float32 sum one
// rounding per block instead of a chain of millions.  Counts stay exact
// below 2^24 (every partial is an integer).  The order in which blocks and
// warps add still varies, so sums may differ in their last bits between
// runs: the kernel is not deterministic.
//
// svc_fused_clean_fleet is the same routine for V views in one launch (the
// fleet refresh path, svc_refresh_many).  It replaces the offset-segment
// XLA pass of src/repro/kernels/fused_clean/ops.py:38-86
// (fused_clean_groupby_fleet): blockIdx.y is the view, so a chunk never
// straddles two views and the table is keyed on the group alone; each view
// has its own seed mix and threshold and writes out[v, g, :] of a zeroed
// (V, G, 1 + C) output.  No outlier pin: pinned views take the per-view
// path.
#include "svc_common.cuh"

namespace {

constexpr int NT = 256;                // threads per block
constexpr int CHUNK = 8192;            // rows per block
constexpr int MAX_SLOTS = 2048;        // shared table slots (a power of two)
constexpr int TABLE_BYTES = 47 * 1024; // under the 48 KB a block gets without opt-in
constexpr int PROBES = 8;
constexpr unsigned FULL = 0xffffffffu;

// Slots of the table for C value columns: the largest power of two up to
// MAX_SLOTS that fits TABLE_BYTES; 0 (every kept row straight to device
// memory) when fewer than 64 fit.
inline int table_slots(int ncols) {
  const int per_slot = 8 * ncols + 4 + 4;  // f64 sums, int key, int count
  int slots = MAX_SLOTS;
  while (slots >= 64 && slots * per_slot > TABLE_BYTES) slots >>= 1;
  return slots >= 64 ? slots : 0;
}

// Sum x over the lanes of one key group onto its lowest lane.  ``above``
// holds the group's lanes above this one, ``rank`` this lane's position in
// the group; every lane of the warp calls it (the loop's condition is
// warp-wide).  Each round the even ranks add the next live peer's partial
// and the odd ranks drop out: log2(group size) rounds.
__device__ __forceinline__ float peer_sum(float x, unsigned above, int rank) {
  while (__any_sync(FULL, above != 0)) {
    const int next = __ffs(above);
    const float t = __shfl_sync(FULL, x, (next - 1) & 31);
    if (!(rank & 1) && next) x += t;
    above &= __ballot_sync(FULL, !(rank & 1));
    rank >>= 1;
  }
  return x;
}

// One block: rows [r0, r1) of one view, into out (G, 1 + C) of that view.
__global__ void __launch_bounds__(NT)
    fused_clean_chunks(const int32_t* __restrict__ gid, const uint8_t* __restrict__ valid,
                       const uint8_t* __restrict__ pin, const float* __restrict__ vals,
                       int64_t rows, int ncols, int64_t groups, int slots,
                       const uint32_t* __restrict__ seed_mixes, const float* __restrict__ threshs,
                       uint32_t seed_mix, float thresh, float* __restrict__ out,
                       unsigned long long* __restrict__ overflow) {
  extern __shared__ double smem[];
  double* t_sum = smem;                                            // slots × C
  int* t_key = reinterpret_cast<int*>(t_sum + static_cast<int64_t>(slots) * ncols);
  int* t_cnt = t_key + slots;
  __shared__ unsigned long long spilled;

  const int view = blockIdx.y;
  if (seed_mixes != nullptr) {
    seed_mix = seed_mixes[view];
    thresh = threshs[view];
  }
  const int64_t base_row = static_cast<int64_t>(view) * rows;  // view-major (V, R)
  const int width = ncols + 1;
  float* vout = out + static_cast<int64_t>(view) * groups * width;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * CHUNK;
  const int64_t r1 = min(r0 + CHUNK, rows);

  for (int s = threadIdx.x; s < slots; s += NT) {
    t_key[s] = -1;
    t_cnt[s] = 0;
    for (int c = 0; c < ncols; ++c) t_sum[static_cast<int64_t>(s) * ncols + c] = 0.0;
  }
  if (threadIdx.x == 0) spilled = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // a warp walks 32 consecutive rows at a time; every lane takes the same
  // number of steps, so the warp-wide votes below see the whole warp
  for (int64_t w0 = r0 + warp * 32; w0 < r1; w0 += NT) {
    const int64_t i = w0 + lane;
    int key = -1;  // the row's group when it is kept, else -1
    if (i < r1 && valid[base_row + i]) {
      const int32_t g = gid[base_row + i];
      if (g >= 0 && static_cast<int64_t>(g) < groups) {
        bool keep = svc::u01(svc::splitmix32(seed_mix ^ svc::splitmix32(
                        static_cast<uint32_t>(g)))) < thresh;
        if (pin != nullptr) keep = keep || pin[base_row + i] != 0;
        if (keep) key = g;
      }
    }
    const unsigned peers = __match_any_sync(FULL, key);
    // the group's lanes above this one ((2u << 31) is 0: none above lane
    // 31); rows that are not kept need no sum
    const unsigned above = key >= 0 ? peers & ~((2u << lane) - 1u) : 0u;
    const int rank = __popc(peers & ((1u << lane) - 1u));
    const bool leader = key >= 0 && rank == 0;
    const int n = __popc(peers);

    // the leader probes for its slot; -1 when the probes find none
    int slot = -1;
    if (leader && slots > 0) {
      // Fibonacci hashing: the product's top log2(slots) bits
      unsigned h = (static_cast<unsigned>(key) * 2654435761u) >> (__clz(slots) + 1);
      for (int p = 0; p < PROBES; ++p, h = (h + 1) & (slots - 1)) {
        const int old = atomicCAS(t_key + h, -1, key);
        if (old == -1 || old == key) {
          slot = static_cast<int>(h);
          break;
        }
      }
    }
    if (leader) {
      if (slot >= 0) {
        atomicAdd(t_cnt + slot, n);
      } else {
        atomicAdd(vout + static_cast<int64_t>(key) * width, static_cast<float>(n));
        atomicAdd(&spilled, static_cast<unsigned long long>(n));
      }
    }
    for (int c = 0; c < ncols; ++c) {
      const float x = key >= 0 ? vals[(base_row + i) * ncols + c] : 0.0f;
      const float s = peer_sum(x, above, rank);
      if (leader) {
        if (slot >= 0)
          atomicAdd(t_sum + static_cast<int64_t>(slot) * ncols + c, static_cast<double>(s));
        else
          atomicAdd(vout + static_cast<int64_t>(key) * width + 1 + c, s);
      }
    }
  }
  __syncthreads();

  for (int s = threadIdx.x; s < slots; s += NT) {
    const int key = t_key[s];
    if (key < 0) continue;
    float* row = vout + static_cast<int64_t>(key) * width;
    atomicAdd(row, static_cast<float>(t_cnt[s]));
    for (int c = 0; c < ncols; ++c)
      atomicAdd(row + 1 + c, static_cast<float>(t_sum[static_cast<int64_t>(s) * ncols + c]));
  }
  if (threadIdx.x == 0 && overflow != nullptr && spilled != 0) atomicAdd(overflow, spilled);
}

cudaError_t launch(const int32_t* gid, const uint8_t* valid, const uint8_t* pin,
                   const float* vals, int64_t views, int64_t rows, int ncols, int64_t groups,
                   const uint32_t* seed_mixes, const float* threshs, uint32_t seed_mix,
                   float thresh, float* out, unsigned long long* overflow,
                   cudaStream_t stream) {
  if (rows <= 0 || views <= 0) return cudaSuccess;
  if (views > 65535) return cudaErrorInvalidValue;
  const int slots = table_slots(ncols);
  const size_t bytes = static_cast<size_t>(slots) * (8 * ncols + 8);
  const dim3 grid(static_cast<unsigned>((rows + CHUNK - 1) / CHUNK), static_cast<unsigned>(views));
  fused_clean_chunks<<<grid, NT, bytes, stream>>>(gid, valid, pin, vals, rows, ncols, groups,
                                                  slots, seed_mixes, threshs, seed_mix, thresh,
                                                  out, overflow);
  return cudaGetLastError();
}

}  // namespace

// overflow (nullable): a uint64 counter that gains the kept rows whose key
// found no slot in its block's shared table.
extern "C" int svc_fused_clean(const int32_t* gid, const uint8_t* valid, const uint8_t* pin,
                               const float* vals, int64_t rows, int ncols, int64_t groups,
                               uint32_t seed_mix, float thresh, float* out,
                               unsigned long long* overflow, void* stream) {
  return static_cast<int>(launch(gid, valid, pin, vals, 1, rows, ncols, groups, nullptr, nullptr,
                                 seed_mix, thresh, out, overflow,
                                 static_cast<cudaStream_t>(stream)));
}

extern "C" int svc_fused_clean_fleet(const int32_t* gid, const uint8_t* valid, const float* vals,
                                     int64_t views, int64_t rows, int ncols, int64_t groups,
                                     const uint32_t* seed_mix, const float* thresh, float* out,
                                     unsigned long long* overflow, void* stream) {
  return static_cast<int>(launch(gid, valid, nullptr, vals, views, rows, ncols, groups, seed_mix,
                                 thresh, 0u, 0.0f, out, overflow,
                                 static_cast<cudaStream_t>(stream)));
}
