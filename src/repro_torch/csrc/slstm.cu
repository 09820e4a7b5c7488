// The sLSTM's recurrence over time (xLSTM, arXiv:2405.04517), forward and
// backward, one launch a time step; a C loop enqueues a whole sequence's
// steps from one call.
//
//   svc_slstm_fwd — for t = 0..S−1, launch t computes
//       g_t = wx_t + rec(h_{t−1}),   rec: gate block hd (z, i, f, o for
//             hd = 0..3) = h[:, hd·d/4:(hd+1)·d/4] @ R[hd]
//     and the exp-gated cell (JAX's order of operations):
//       z = tanh(g_z), o = σ(g_o), logf = log σ(g_f)
//       m_t = max(logf + m_{t−1}, g_i)
//       i' = exp(g_i − m_t), f' = exp(logf + m_{t−1} − m_t)
//       c_t = f'·c_{t−1} + i'·z,  n_t = f'·n_{t−1} + i',  h_t = o·c_t / max(n_t, 1)
//     writing h_t into hs[:, t] and (c, n, m) into running state buffers,
//     and, when the caller saves for the backward, g_t and (c_t, n_t, m_t).
//   svc_slstm_bwd — for t = S−1..0, launch t forms
//       dh_t = dhs_t + Σ_e dg_{t+1}[hd(u)·d + e] · R[hd(u), u mod d/4, e]
//     (no sum at t = S−1), runs the cell's backward with the carried dc,
//     dn, dm and writes dg_t (the gradient of wx_t) and the new carries.  At
//     max(logf + m, g_i) and max(n, 1) a tie sends half the gradient down
//     each branch, as jnp.maximum does.  dR = Σ_t h_{t−1}ᵀ·dg_t is not
//     computed here: the wrapper takes it as one batched product over all
//     steps after the loop, as JAX's scan transposes its einsum into a dot.
//
// Replaces no Pallas kernel: the body of XLA's lax.scan at
// src/repro/models/xlstm.py:242-256 (the einsum bhd,hde->bhe with R, then
// _slstm_cell at :213-225), and the VJP JAX's autodiff takes of it.  The
// plain PyTorch version (kernels/slstm/ref.py) makes ~30 launches a step
// forward and more backward.
//
// Bound: operations, 2·B·4·(d/4)·d a step for R·h (67 MFLOP at B = 8,
// d = 2,048) on the CUDA cores in float32; R (4 × d/4 × d float32, 16.8 MB
// at d = 2,048) is read by every step and stays in the 50 MB L2 between
// launches, so a step reads it from L2, not device memory.
//
// Design:
//   * A block owns kUnits = 16 units j of all four gates (R's columns j of
//     every gate) for kRows = 8 batch rows: d/16 × ⌈B/8⌉ blocks, 128 at
//     d = 2,048, B = 8, so R is spread over 128 SMs.  A half-warp reads 16
//     consecutive floats of a row of R (64 bytes, two full 32-byte sectors).
//   * Latency, not bandwidth, bounds a step: a block's thread first issues
//     the loads its cell reads (wx_t, the state), then the staging copies
//     16-byte words, eight in flight a thread, and the product loops are
//     unrolled so that each thread has 32 (forward) or 16 (backward) loads
//     of R in flight.
//   * Forward: h_{t−1} of the block's rows is staged in shared memory
//     (8·d floats, zero past B); each of 16 k-groups (a half-warp) sums its
//     k's of Σ_k h[b, hd·d/4 + k]·R[hd, k, j] for 4 gates × 8 rows in
//     registers, four k's a float4 of h; the 16 partials are added in group
//     order through shared memory by the thread of (row, unit), which then
//     runs the cell.
//   * Backward: dg_{t+1}'s head block of the block's rows (16 units share
//     one head: d/4 is a multiple of 16) is staged in shared memory; a warp
//     takes 4 units and half of e, its lanes consecutive e's of R's
//     contiguous rows; lane sums reduce by a fixed butterfly, the halves in
//     order; the thread of (row, unit) runs the cell's backward.
//   * No atomics, fixed summation orders, the same grid for a given shape:
//     two calls give the same bits.  The cell's arithmetic is the plain
//     version's order with every rounding pinned by an intrinsic
//     (__fadd_rn, __fmul_rn, __fdiv_rn: no multiply-add is contracted), IEEE
//     expf, tanhf and log1pf (the build has no fast math); the dot products
//     use fused multiply-adds in their own order, as cuBLAS does.
//   * Launches depend only on S: exactly S for each direction, whatever B
//     and d.  Every launch's shared memory is granted once per card.
#include <cuda_runtime.h>

#include "svc_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnits = 16;   // units of each gate a block owns
constexpr int kRows = 8;     // batch rows a block owns
constexpr int kGroups = 16;  // forward k-groups: 8 warps × 2 half-warps
constexpr int kBwdUnitsPerWarp = 4;
constexpr int kStageWords = 8;  // 16-byte words a thread has in flight while staging rows

// dst[r·d + k] = src[r·stride + k] for rows r < nb, 0 for nb ≤ r < kRows
// (and for every row when src is null): 16-byte words, kStageWords of
// them in flight a thread, where src and its rows are aligned to 16 bytes,
// else one float at a time.
__device__ __forceinline__ void stage_rows(float* dst, const float* src, long long stride, int nb,
                                           int d) {
  const int tid = threadIdx.x;
  if (src == nullptr || ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (stride & 3) == 0)) {
    const int row_words = d >> 2, words = kRows * row_words;
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (int base = tid; base < words; base += kThreads * kStageWords) {
      float4 v[kStageWords];
#pragma unroll
      for (int i = 0; i < kStageWords; ++i) {
        const int w = base + i * kThreads;
        const int r = w / row_words;
        v[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (src != nullptr && w < words && r < nb) {
          v[i] = __ldg(reinterpret_cast<const float4*>(src + r * stride) + (w - r * row_words));
        }
      }
#pragma unroll
      for (int i = 0; i < kStageWords; ++i) {
        const int w = base + i * kThreads;
        if (w < words) dst4[w] = v[i];
      }
    }
    return;
  }
  for (int r = 0; r < kRows; ++r) {
    for (int k = tid; k < d; k += kThreads) dst[r * d + k] = r < nb ? src[r * stride + k] : 0.0f;
  }
}

// torch.maximum: NaN when either is NaN, else the larger
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// the share of max(x, y)'s gradient that goes to x: 1, ½ at a tie, 0
__device__ __forceinline__ float tie_split(float x, float y) {
  return x > y ? 1.0f : (x == y ? 0.5f : 0.0f);
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// log σ(x) = −softplus(−x) = −(max(−x, 0) + log1p(exp(−|x|)))
__device__ __forceinline__ float log_sigmoid_f(float x) {
  return -__fadd_rn(max_nan(-x, 0.0f), log1pf(expf(-fabsf(x))));
}

struct FwdArgs {
  const float* wx;      // (B, S, 4d)
  const float* R;       // (4, d/4, d)
  const float* h_prev;  // row b of h_{t−1} at h_prev + b·h_stride; null: zeros
  long long h_stride;
  const float* c_prev;  // (B, d) each; null: zeros
  const float* n_prev;
  const float* m_prev;
  float* hs;            // (B, S, d): writes [:, t]
  float* c_out;         // (B, d) each: the state after step t
  float* n_out;
  float* m_out;
  float* g_save;        // (B, S, 4d) or null
  float* c_save;        // (B, S, d) each, or null
  float* n_save;
  float* m_save;
  int B, S, d, t;
};

__global__ void __launch_bounds__(kThreads) slstm_fwd_step(FwdArgs a) {
  extern __shared__ float4 smem4[];
  float* hsm = reinterpret_cast<float*>(smem4);  // [kRows][d]: h_{t−1}
  const int d = a.d, dh = d >> 2;
  float* part = hsm + kRows * d;                 // [kGroups][4][kRows][kUnits]
  const int j0 = blockIdx.x * kUnits;
  const int b0 = blockIdx.y * kRows;
  const int nb = min(kRows, a.B - b0);
  const int tid = threadIdx.x;
  // the cell's thread (row b, unit v) reads its inputs before the products
  const int b = tid / kUnits, v = tid % kUnits;
  const bool cell = tid < kRows * kUnits && b < nb;
  const long long row = static_cast<long long>(b0 + b);
  const int jj = j0 + v;
  const long long st = row * a.S + a.t;  // (b, t) in the (B, S, ·) tensors
  const long long si = row * d + jj;
  float wxv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float c_p = 0.0f, n_p = 0.0f, m_p = 0.0f;
  if (cell) {
#pragma unroll
    for (int gt = 0; gt < 4; ++gt) wxv[gt] = __ldg(a.wx + st * 4 * d + gt * d + jj);
    if (a.c_prev != nullptr) c_p = a.c_prev[si];
    if (a.n_prev != nullptr) n_p = a.n_prev[si];
    if (a.m_prev != nullptr) m_p = a.m_prev[si];
  }
  stage_rows(hsm, a.h_prev == nullptr ? nullptr : a.h_prev + b0 * a.h_stride, a.h_stride, nb, d);
  __syncthreads();

  const int lane = tid & 31;
  const int q = (tid >> 5) * 2 + (lane >> 4);  // this half-warp's k-group
  const int u = lane & 15;
  const int j = j0 + u;
  float acc[4][kRows];
#pragma unroll
  for (int gt = 0; gt < 4; ++gt) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[gt][r] = 0.0f;
  }
#pragma unroll 2
  for (int p = q; p < (dh >> 2); p += kGroups) {
    const int k = p << 2;
    float rv[4][4];
#pragma unroll
    for (int gt = 0; gt < 4; ++gt) {
      const float* r = a.R + (static_cast<long long>(gt) * dh + k) * d + j;
#pragma unroll
      for (int i = 0; i < 4; ++i) rv[gt][i] = __ldg(r + i * d);
    }
#pragma unroll
    for (int gt = 0; gt < 4; ++gt) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 h4 = *reinterpret_cast<const float4*>(hsm + r * d + gt * dh + k);
        float s = acc[gt][r];
        s = fmaf(h4.x, rv[gt][0], s);
        s = fmaf(h4.y, rv[gt][1], s);
        s = fmaf(h4.z, rv[gt][2], s);
        s = fmaf(h4.w, rv[gt][3], s);
        acc[gt][r] = s;
      }
    }
  }
#pragma unroll
  for (int gt = 0; gt < 4; ++gt) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) part[((q * 4 + gt) * kRows + r) * kUnits + u] = acc[gt][r];
  }
  __syncthreads();

  if (!cell) return;
  float g[4];
#pragma unroll
  for (int gt = 0; gt < 4; ++gt) {
    float s = part[(gt * kRows + b) * kUnits + v];
    for (int p = 1; p < kGroups; ++p) s = __fadd_rn(s, part[((p * 4 + gt) * kRows + b) * kUnits + v]);
    g[gt] = __fadd_rn(wxv[gt], s);
  }
  const float z = tanhf(g[0]);
  const float o = sigmoid_f(g[3]);
  const float logf_ = log_sigmoid_f(g[2]);
  const float m = max_nan(__fadd_rn(logf_, m_p), g[1]);
  const float ip = expf(__fsub_rn(g[1], m));
  const float fp = expf(__fsub_rn(__fadd_rn(logf_, m_p), m));
  const float c = __fadd_rn(__fmul_rn(fp, c_p), __fmul_rn(ip, z));
  const float n = __fadd_rn(__fmul_rn(fp, n_p), ip);
  const float h = __fdiv_rn(__fmul_rn(o, c), max_nan(n, 1.0f));
  a.hs[st * d + jj] = h;
  a.c_out[si] = c;
  a.n_out[si] = n;
  a.m_out[si] = m;
  if (a.g_save != nullptr) {
#pragma unroll
    for (int gt = 0; gt < 4; ++gt) a.g_save[st * 4 * d + gt * d + jj] = g[gt];
    a.c_save[st * d + jj] = c;
    a.n_save[st * d + jj] = n;
    a.m_save[st * d + jj] = m;
  }
}

struct BwdArgs {
  const float* dhs;  // (B, S, d)
  const float* R;    // (4, d/4, d)
  const float* g;    // saved (B, S, 4d)
  const float* cs;   // saved (B, S, d) each
  const float* ns;
  const float* ms;
  float* dG;         // (B, S, 4d): writes [:, t]
  float* dc;         // (B, d) each: the carries (read from t = S−2 on)
  float* dn;
  float* dm;
  int B, S, d, t;
};

__global__ void __launch_bounds__(kThreads) slstm_bwd_step(BwdArgs a) {
  extern __shared__ float4 smem4[];
  float* gsm = reinterpret_cast<float*>(smem4);  // [kRows][d]: dg_{t+1}'s head block
  const int d = a.d, dh = d >> 2, S = a.S, t = a.t;
  float* red = gsm + kRows * d;                  // [2][kUnits][kRows]
  const int u0 = blockIdx.x * kUnits;
  const int hd = u0 / dh, k0 = u0 - hd * dh;
  const int b0 = blockIdx.y * kRows;
  const int nb = min(kRows, a.B - b0);
  const int tid = threadIdx.x;
  const bool later = t + 1 < S;  // dg_{t+1} exists
  // the cell's thread (row b, unit v) reads its inputs before the products
  const int b = tid / kUnits, v = tid % kUnits;
  const bool cell = tid < kRows * kUnits && b < nb;
  const long long row = static_cast<long long>(b0 + b);
  const int j = u0 + v;
  const long long st = row * S + t;
  const long long si = row * d + j;
  float dh_ = 0.0f, zr = 0.0f, ir = 0.0f, fr = 0.0f, orr = 0.0f, c = 0.0f, n = 0.0f, m = 0.0f;
  float c_p = 0.0f, n_p = 0.0f, m_p = 0.0f, dc = 0.0f, dn = 0.0f, dm = 0.0f;
  if (cell) {
    dh_ = a.dhs[st * d + j];
    const float* g = a.g + st * 4 * d + j;
    zr = g[0];
    ir = g[d];
    fr = g[2 * d];
    orr = g[3 * d];
    c = a.cs[st * d + j];
    n = a.ns[st * d + j];
    m = a.ms[st * d + j];
    if (t > 0) {  // the sequence starts from the zero state
      c_p = a.cs[(st - 1) * d + j];
      n_p = a.ns[(st - 1) * d + j];
      m_p = a.ms[(st - 1) * d + j];
    }
    if (later) {
      dc = a.dc[si];
      dn = a.dn[si];
      dm = a.dm[si];
    }
  }
  if (later) {
    const long long stride = static_cast<long long>(S) * 4 * d;
    stage_rows(gsm, a.dG + static_cast<long long>(b0) * stride + static_cast<long long>(t + 1) * 4 * d +
                        static_cast<long long>(hd) * d,
               stride, nb, d);
    __syncthreads();
    const int warp = tid >> 5, lane = tid & 31;
    const int half = warp >> 2;
    const int uw = (warp & 3) * kBwdUnitsPerWarp;
    float acc[kBwdUnitsPerWarp][kRows];
#pragma unroll
    for (int i = 0; i < kBwdUnitsPerWarp; ++i) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[i][r] = 0.0f;
    }
    const float* rr = a.R + (static_cast<long long>(hd) * dh + k0 + uw) * d;
    const int e_end = (half + 1) * (d >> 1);
#pragma unroll 4
    for (int e = half * (d >> 1) + lane; e < e_end; e += 32) {
      float rv[kBwdUnitsPerWarp];
#pragma unroll
      for (int i = 0; i < kBwdUnitsPerWarp; ++i) rv[i] = __ldg(rr + static_cast<long long>(i) * d + e);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float gv = gsm[r * d + e];
#pragma unroll
        for (int i = 0; i < kBwdUnitsPerWarp; ++i) acc[i][r] = fmaf(gv, rv[i], acc[i][r]);
      }
    }
#pragma unroll
    for (int i = 0; i < kBwdUnitsPerWarp; ++i) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float s = acc[i][r];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) red[(half * kUnits + uw + i) * kRows + r] = s;
      }
    }
    __syncthreads();
  }

  if (!cell) return;
  if (later) {
    dh_ = __fadd_rn(dh_, __fadd_rn(red[v * kRows + b], red[(kUnits + v) * kRows + b]));
  }
  const float z = tanhf(zr);
  const float o = sigmoid_f(orr);
  const float logf_ = log_sigmoid_f(fr);
  const float av = __fadd_rn(logf_, m_p);
  const float ip = expf(__fsub_rn(ir, m));
  const float fp = expf(__fsub_rn(av, m));
  const float nc = max_nan(n, 1.0f);
  const float h = __fdiv_rn(__fmul_rn(o, c), nc);
  const float t1 = __fdiv_rn(dh_, nc);  // d(o·c)
  const float do_ = __fmul_rn(t1, c);
  const float dct = __fadd_rn(dc, __fmul_rn(t1, o));
  const float dnt = __fsub_rn(dn, __fmul_rn(__fmul_rn(t1, h), tie_split(n, 1.0f)));
  const float dfp = __fadd_rn(__fmul_rn(dct, c_p), __fmul_rn(dnt, n_p));
  const float dip = __fadd_rn(__fmul_rn(dct, z), dnt);
  const float dz = __fmul_rn(dct, ip);
  const float da_arg = __fmul_rn(dfp, fp);  // d(logf + m_{t−1} − m_t)
  const float di_arg = __fmul_rn(dip, ip);  // d(g_i − m_t)
  const float dmt = __fsub_rn(__fsub_rn(dm, da_arg), di_arg);
  const float wa = tie_split(av, ir);
  const float da = __fadd_rn(da_arg, __fmul_rn(dmt, wa));
  const float dir = __fadd_rn(di_arg, __fmul_rn(dmt, __fsub_rn(1.0f, wa)));
  const float dfr = __fmul_rn(da, expf(__fsub_rn(logf_, fr)));  // σ(−f) = exp(log σ(f) − f)
  const float dor = __fmul_rn(__fmul_rn(do_, o), __fsub_rn(1.0f, o));
  const float dzr = __fmul_rn(dz, __fsub_rn(1.0f, __fmul_rn(z, z)));
  float* dg = a.dG + st * 4 * d + j;
  dg[0] = dzr;
  dg[d] = dir;
  dg[2 * d] = dfr;
  dg[3 * d] = dor;
  a.dc[si] = __fmul_rn(dct, fp);
  a.dn[si] = __fmul_rn(dnt, fp);
  a.dm[si] = da;
}

int fwd_smem(int d) { return (kRows * d + kGroups * 4 * kRows * kUnits) * 4; }
int bwd_smem(int d) { return (kRows * d + 2 * kUnits * kRows) * 4; }

// the shared memory a block may have on the current card, granted to
// ``kernel`` once per card
template <typename K>
cudaError_t grant(svc::PerDevice<int>& limit, svc::PerDevice<cudaError_t>& granted, K kernel,
                  int need) {
  const int most = limit.get([](int dev) {
    int v = 0;
    cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    return v;
  });
  if (need > most) return cudaErrorInvalidValue;
  return svc::allow_smem(granted, kernel, most);
}

bool bad_shape(int B, int S, int d) {
  return B < 1 || S < 1 || d < 4 * kUnits || d % (4 * kUnits) != 0;
}

}  // namespace

// wx (B, S, 4d), R (4, d/4, d); h0, c0, n0, m0 (B, d) each or null (the
// zero state); hs (B, S, d); c_out, n_out, m_out (B, d) each: the state
// after the last step (h's is hs[:, S−1]); g_save (B, S, 4d) and c_save,
// n_save, m_save (B, S, d) each, all null or all given.  All float32,
// contiguous, on the current card.  Enqueues S launches on ``stream``.
extern "C" int svc_slstm_fwd(const float* wx, const float* R, const float* h0, const float* c0,
                             const float* n0, const float* m0, float* hs, float* c_out,
                             float* n_out, float* m_out, float* g_save, float* c_save,
                             float* n_save, float* m_save, int B, int S, int d, void* stream) {
  if (bad_shape(B, S, d)) return static_cast<int>(cudaErrorInvalidValue);
  if ((g_save == nullptr) != (c_save == nullptr) || (g_save == nullptr) != (n_save == nullptr) ||
      (g_save == nullptr) != (m_save == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static svc::PerDevice<int> limit;
  static svc::PerDevice<cudaError_t> granted;
  const int smem = fwd_smem(d);
  cudaError_t err = grant(limit, granted, slstm_fwd_step, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(d / kUnits, (B + kRows - 1) / kRows);
  FwdArgs P{wx, R, nullptr, 0, nullptr, nullptr, nullptr, hs, c_out, n_out, m_out,
            g_save, c_save, n_save, m_save, B, S, d, 0};
  for (int t = 0; t < S; ++t) {
    P.t = t;
    if (t == 0) {
      P.h_prev = h0;
      P.h_stride = d;
      P.c_prev = c0;
      P.n_prev = n0;
      P.m_prev = m0;
    } else {
      P.h_prev = hs + static_cast<long long>(t - 1) * d;
      P.h_stride = static_cast<long long>(S) * d;
      P.c_prev = c_out;
      P.n_prev = n_out;
      P.m_prev = m_out;
    }
    slstm_fwd_step<<<grid, kThreads, smem, s>>>(P);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// dhs (B, S, d), R (4, d/4, d); g_save (B, S, 4d), c_save, n_save, m_save
// (B, S, d) each: the forward's, from the zero state; dG (B, S, 4d): gets
// every step's dg (the gradient of wx); dc, dn, dm (B, d) each: scratch for
// the carries (need no zeroing).  All float32,
// contiguous, on the current card.  Enqueues S launches on ``stream``.
extern "C" int svc_slstm_bwd(const float* dhs, const float* R, const float* g_save,
                             const float* c_save, const float* n_save, const float* m_save,
                             float* dG, float* dc, float* dn, float* dm, int B, int S, int d,
                             void* stream) {
  if (bad_shape(B, S, d)) return static_cast<int>(cudaErrorInvalidValue);
  static svc::PerDevice<int> limit;
  static svc::PerDevice<cudaError_t> granted;
  const int smem = bwd_smem(d);
  cudaError_t err = grant(limit, granted, slstm_bwd_step, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(d / kUnits, (B + kRows - 1) / kRows);
  BwdArgs P{dhs, R, g_save, c_save, n_save, m_save, dG, dc, dn, dm, B, S, d, 0};
  for (int t = S - 1; t >= 0; --t) {
    P.t = t;
    slstm_bwd_step<<<grid, kThreads, smem, s>>>(P);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
