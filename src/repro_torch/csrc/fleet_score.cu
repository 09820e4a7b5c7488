// Fleet scorer: every view's {skip, clean, maintain, retune} scores, the
// §5.2.2 CORR_WINS flip and the recommended sampling ratio in one launch.
//
// Replaces the Pallas kernel src/repro/kernels/fleet_score/kernel.py:
// fleet_score_tiles (body _fleet_score_kernel).  The TPU version transposes
// the (V, 13) feature panel so that views lie on lanes and scores a
// (16, 512) tile with elementwise VPU math.  Here one thread scores one
// view from its 13 features, read straight from the row-major panel.
//
// Bound: launch latency.  A fleet is tens of views — 52 bytes in and 24
// out per view, ~40 flops — so the time is the launch itself.
//
// The scores must equal the plain PyTorch version bit for bit, because the
// planner's knapsack breaks ties on them.  Each torch op rounds once, so
// every multiply, add, divide and square root here is a round-to-nearest
// intrinsic (nvcc contracts a plain a * b + c into one fma by default),
// evaluated in the order of src/repro/kernels/fleet_score/kernel.py:67-92.
// min/max/clamp propagate NaN as torch.minimum/maximum/clamp do.
#include "svc_common.cuh"

namespace {

constexpr int kFeatures = 13;
constexpr int kScores = 6;
// feature columns (kernels/fleet_score/ref.py)
constexpr int F_N = 0, F_EX2 = 1, F_MEAN = 2, F_HT_AQP = 3, F_HT_CORR = 4, F_DRIFT_CLEAN = 5,
              F_DRIFT_IVM = 6, F_TRAFFIC = 7, F_COST_CLEAN = 8, F_COST_MAINTAIN = 9, F_M = 11,
              F_COST_RETUNE = 12;
constexpr float COST_EPS = 1e-6f, M_EPS = 1e-6f, M_REL_LO = 0.005f, M_REL_HI = 0.02f,
                M_STEP = 2.0f, M_MIN = 1.0f / 256.0f, M_MAX = 1.0f, TOTAL_EPS = 1e-9f;

__device__ __forceinline__ float min_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7FC00000) : fminf(a, b);
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7FC00000) : fmaxf(a, b);
}
// torch.clamp(x, min=lo) / clamp(x, max=hi): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) { return isnan(x) ? x : fmaxf(x, lo); }
__device__ __forceinline__ float clamp_max(float x, float hi) { return isnan(x) ? x : fminf(x, hi); }

__global__ void fleet_score_kernel(const float* __restrict__ feats, int64_t views,
                                   float* __restrict__ out) {
  const int64_t v = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (v >= views) return;
  const float* f = feats + v * kFeatures;
  const float n = f[F_N], ex2 = f[F_EX2], mean = f[F_MEAN];
  const float ht_aqp = f[F_HT_AQP], ht_corr = f[F_HT_CORR];
  const float d_clean = f[F_DRIFT_CLEAN], d_ivm = f[F_DRIFT_IVM];
  const float traffic = f[F_TRAFFIC];
  const float cost_c = f[F_COST_CLEAN], cost_m = f[F_COST_MAINTAIN], cost_r = f[F_COST_RETUNE];
  const float m = f[F_M];

  const float e_now = min_nan(ht_aqp, ht_corr);
  const float bias = __fmul_rn(d_clean, mean);
  const float e_skip =
      __fadd_rn(__fadd_rn(__fmul_rn(bias, bias), __fmul_rn(d_clean, ex2)), e_now);
  const float ht_corr_pred = __fmul_rn(
      __fmul_rn(__fdiv_rn(__fsub_rn(1.0f, m), clamp_min(m, M_EPS)), ex2), d_ivm);
  const float e_clean = min_nan(ht_aqp, ht_corr_pred);
  const float gain_clean = clamp_min(__fsub_rn(e_skip, e_clean), 0.0f);

  const float score_clean = __fdiv_rn(__fmul_rn(traffic, gain_clean), clamp_min(cost_c, COST_EPS));
  const float score_maintain = __fdiv_rn(__fmul_rn(traffic, e_skip), clamp_min(cost_m, COST_EPS));
  const float corr_wins = (ht_corr <= ht_aqp) ? 1.0f : 0.0f;
  const float rel_se = __fdiv_rn(__fsqrt_rn(clamp_min(ht_aqp, 0.0f)),
                                 clamp_min(fabsf(__fmul_rn(n, mean)), TOTAL_EPS));
  const float up = max_nan(clamp_max(__fmul_rn(m, M_STEP), M_MAX), m);
  const float down = min_nan(clamp_min(__fdiv_rn(m, M_STEP), M_MIN), m);
  float rec_m = (rel_se > M_REL_HI) ? up : (((rel_se < M_REL_LO) && (ht_aqp > 0.0f)) ? down : m);
  rec_m = (m > 0.0f) ? rec_m : 0.0f;
  const float r_rec = __fdiv_rn(__fsub_rn(1.0f, rec_m), clamp_min(rec_m, M_EPS));
  const float ht_aqp_pred = __fmul_rn(__fmul_rn(r_rec, n), ex2);
  const float ht_corr_pred_rec = __fmul_rn(__fmul_rn(r_rec, ex2), d_ivm);
  const float e_retune = min_nan(ht_aqp_pred, ht_corr_pred_rec);
  const float gain_retune = clamp_min(__fsub_rn(e_skip, e_retune), 0.0f);
  float score_retune = __fdiv_rn(__fmul_rn(traffic, gain_retune), clamp_min(cost_r, COST_EPS));
  score_retune = (rec_m != m && m > 0.0f) ? score_retune : 0.0f;

  float* o = out + v * kScores;
  o[0] = 0.0f;
  o[1] = score_clean;
  o[2] = score_maintain;
  o[3] = score_retune;
  o[4] = corr_wins;
  o[5] = rec_m;
}

}  // namespace

extern "C" int svc_fleet_score(const float* feats, int64_t views, float* out, void* stream) {
  const int block = 128;
  const int grid = static_cast<int>((views + block - 1) / block);
  fleet_score_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(feats, views, out);
  return static_cast<int>(cudaGetLastError());
}
