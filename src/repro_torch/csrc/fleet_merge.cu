// Fleet-wide merge remainder: every view's dense delta groups upserted into
// its stale sample, `(stale + ins) − del` per aggregate, with the
// delta-only groups (delete-cancellation included) as new rows.
//
// Replaces the Pallas kernel src/repro/kernels/fleet_merge/kernel.py:
// fleet_merge_tiles (body _fleet_merge_kernel).  The TPU version cannot
// gather per lane, so it matches every stale key of a (256 rows, 128
// views) tile against each of 128 groups as one-hot masks — O(R·G) work.
// Group keys are dense ids in [0, G), so here the match is a direct
// gather: pass 1 gives one thread to each (view, stale row), which reads
// its group's insert and delete aggregates and marks the group present (a
// plain store of 1 to a zeroed byte, so concurrent marks are harmless);
// pass 2 gives one thread to each (view, group) and emits the delta-only
// row of every live group no valid stale row carries.  The stable per-view
// key sort that follows is torch glue in kernels/fleet_merge/ops.py.
//
// Bound: device memory — O(R + G) bytes per view, each read or written
// once (the gathers of delta aggregates are at most one per stale row).
//
// The result must equal the plain PyTorch version bit for bit: the add
// and the subtract are round-to-nearest intrinsics, so nvcc can neither
// reassociate nor contract them, and the zero substitutions are those of
// kernels/fleet_merge/ref.py.  SENTINEL keys and keys outside [0, G)
// never index.
#include "svc_common.cuh"

namespace {

__global__ void fleet_merge_stale(const int32_t* __restrict__ skeys,
                                  const uint8_t* __restrict__ svalid,
                                  const float* __restrict__ svals,
                                  const uint8_t* __restrict__ ivalid,
                                  const float* __restrict__ ivals,
                                  const uint8_t* __restrict__ dvalid,
                                  const float* __restrict__ dvals, int64_t views, int64_t rows,
                                  int64_t groups, int aggs, uint8_t* __restrict__ present,
                                  int32_t* __restrict__ out_keys, float* __restrict__ out_vals,
                                  uint8_t* __restrict__ out_valid) {
  const int64_t n = views * rows;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int64_t v = i / rows;
    const int64_t r = i - v * rows;
    const bool sv = svalid[i] != 0;
    const int32_t k = skeys[i];
    const bool in_range = sv && k >= 0 && static_cast<int64_t>(k) < groups;
    const int64_t g = v * groups + (in_range ? k : 0);
    const bool ih = in_range && ivalid[g] != 0;
    const bool dh = in_range && dvalid[g] != 0;
    const int64_t o = v * (rows + groups) + r;
    for (int a = 0; a < aggs; ++a) {
      const float base = sv ? svals[i * aggs + a] : 0.0f;
      const float add = ih ? ivals[g * aggs + a] : 0.0f;
      const float sub = dh ? dvals[g * aggs + a] : 0.0f;
      const float val = __fsub_rn(__fadd_rn(base, add), sub);
      out_vals[o * aggs + a] = sv ? val : 0.0f;
    }
    out_keys[o] = sv ? k : svc::SENTINEL_KEY;
    out_valid[o] = sv ? 1 : 0;
    if (in_range) present[g] = 1;
  }
}

__global__ void fleet_merge_delta_only(const uint8_t* __restrict__ ivalid,
                                       const float* __restrict__ ivals,
                                       const uint8_t* __restrict__ dvalid,
                                       const float* __restrict__ dvals, int64_t views,
                                       int64_t rows, int64_t groups, int aggs,
                                       const uint8_t* __restrict__ present,
                                       int32_t* __restrict__ out_keys,
                                       float* __restrict__ out_vals,
                                       uint8_t* __restrict__ out_valid) {
  const int64_t n = views * groups;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int64_t v = i / groups;
    const int64_t g = i - v * groups;
    const bool iv = ivalid[i] != 0;
    const bool dv = dvalid[i] != 0;
    const bool only = (iv || dv) && present[i] == 0;
    const int64_t o = v * (rows + groups) + rows + g;
    for (int a = 0; a < aggs; ++a) {
      const float add = iv ? ivals[i * aggs + a] : 0.0f;
      const float sub = dv ? dvals[i * aggs + a] : 0.0f;
      out_vals[o * aggs + a] = only ? __fsub_rn(add, sub) : 0.0f;
    }
    out_keys[o] = only ? static_cast<int32_t>(g) : svc::SENTINEL_KEY;
    out_valid[o] = only ? 1 : 0;
  }
}

}  // namespace

extern "C" int svc_fleet_merge(const int32_t* skeys, const uint8_t* svalid, const float* svals,
                               const uint8_t* ivalid, const float* ivals, const uint8_t* dvalid,
                               const float* dvals, int64_t views, int64_t rows, int64_t groups,
                               int aggs, uint8_t* present, int32_t* out_keys, float* out_vals,
                               uint8_t* out_valid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int block = 256;
  fleet_merge_stale<<<svc::grid_for(views * rows, block), block, 0, s>>>(
      skeys, svalid, svals, ivalid, ivals, dvalid, dvals, views, rows, groups, aggs, present,
      out_keys, out_vals, out_valid);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fleet_merge_delta_only<<<svc::grid_for(views * groups, block), block, 0, s>>>(
      ivalid, ivals, dvalid, dvals, views, rows, groups, aggs, present, out_keys, out_vals,
      out_valid);
  return static_cast<int>(cudaGetLastError());
}
