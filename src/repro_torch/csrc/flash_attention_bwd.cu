// The gradient of flash attention: dq, dk and dv from q, k, v, the
// forward's output o, its per-row log-sum-exp lse and the output gradient dO.
//
// Replaces no TPU kernel.  The JAX package's Pallas flash kernel has no VJP
// and is on no training path; JAX's trainer differentiates the model's XLA
// attention (repro/models/layers.py:gqa_attention) with autodiff.  This is
// that gradient, in the FlashAttention-2 form, so that the port's train
// steps take no plain PyTorch path on the card:
//
//   D  = rowsum(dO ∘ o)                        (per query row, f32)
//   P  = exp(s·scale − lse) on the kept pairs  (recomputed per tile, f32)
//   dV = Pᵀ·dO,   dS = P ∘ (dO·Vᵀ − D),   dQ = dS·K·scale,   dK = dSᵀ·Q·scale
//
// with s = q·k and the masks of the forward (flash_common.cuh: causal with
// qpos, the banded window, key_pos ring slots; non-causal keeps every key).
// Masked pairs have P = 0 exactly, so the kernel keeps the pairs the plain
// version's keep_mask keeps.
//
// On the caller's stream, none with a float atomic, so two calls on the
// same inputs give the same bits: D (flash_bwd_prep), then the dK/dV and
// dQ passes (one launch on the warpgroup route, two on the others); where
// the dK/dV blocks cannot fill the card (one KV head: gemma-2b, the
// hybrid) each key tile's steps are cut into kv_splits runs, one block
// each, whose f32 partials flash_bwd_sum adds in run order before rounding
// dK and dV once (ops.bwd_plan chooses the split and mirrors every tile
// below; the entry point refuses any other plan).  The bf16 products take
// P and dS as bf16
// hi + lo operands (two products each): rounded once to bf16, their error
// would tie SDPA's backward (which rounds them so) instead of staying at
// about a third of it.  q, k, v and dO are exact in bf16.
//
// bfloat16 at head_dim 64, 128 and 256 (namespace wg, Hopper; the training
// shapes).  Blocks of two consumer warpgroups and a producer warpgroup
// (one thread of it issues every copy): TMA tiles (64 rows × 64 columns,
// 128-byte swizzle, tensor maps encoded per call on the host) and lse and D
// rows as bulk copies into a ring of mbarrier slots, the consumers with
// setmaxnreg's 240 registers (flash_hopper.cuh has the primitives).  Every
// product is a wgmma: the S-side ones (64 × 64 over the head_dim) with both
// operands in shared memory, the accumulating ones (64 × head_dim over 64)
// with the bf16 hi or lo fragments of an f32 accumulator as the register A
// operand (the accumulator layout of m64nNk16 is the A layout) and the
// other operand read MN-major through the descriptor's transpose bit.  Both
// passes run in one launch, the dK/dV blocks first, so each pass's last
// wave runs beside the other's blocks.
//   - head_dim 128 and 256: the two warpgroups share 64 keys (dK/dV) or 64
//     queries (dQ), since 64 × 256 f32 of dK and of dV do not fit one
//     warpgroup.  dK/dV pass, one block per (64 keys, b·kv head, run): K
//     and V stay resident, each step brings 64 queries of one group head;
//     warpgroup 0 computes Sᵀ = K·Qᵀ and Pᵀ and accumulates dV += Pᵀ·dO,
//     warpgroup 1 computes dPᵀ = V·dOᵀ, takes Pᵀ from warpgroup 0 through
//     shared memory, forms dSᵀ and accumulates dK += dSᵀ·Q.  So Sᵀ and dPᵀ
//     are computed once per (key tile, step), and each warpgroup holds one
//     64 × head_dim accumulator.  dQ pass, one block per (64 queries,
//     b·head) over the key tiles of their causal range in order:
//     warpgroup 0 computes S and P, warpgroup 1 dP; they trade P and dP,
//     both form dS, warpgroup 0 accumulates dS_hi·K and warpgroup 1
//     dS_lo·K, summed once at the end.
//   - head_dim 64 (solo): each warpgroup owns 64 of a block's 128 keys (or
//     queries) and computes every product of them, holding dK and dV (or
//     dQ) itself: nothing crosses between warpgroups, and a block reads the
//     other operand once for twice the work, which at this width is what
//     holds the pass (a step's loads against its few products).
//   Products over the head_dim a kept pair takes: 6 in the dK/dV pass (S,
//   dP, dV and dK as hi + lo) and 4 in the dQ pass (S, dP, dQ as hi + lo),
//   10 in all against the bound's 5 (ops.bwd_products).  The ring holds 4
//   slots at head_dim 64, 3 at 128, 2 at 256 (shared memory).
//
// bfloat16 at head_dim 16, 32 and 96 (namespace tc): mma.sync.m16n8k16
// with f32 accumulation, operands through ldmatrix from shared memory
// (rows padded by 16 bytes), tiles through 16-byte cp.async (two stages),
// dS and P as A fragments straight from the accumulators.  dQ pass: 4
// warps × 16 flat (query, group head) rows against 64 keys a step (32 at
// 96).  dK/dV pass: 4 warps × 16 keys, the transposed products (K·Qᵀ,
// V·dOᵀ), 64 flat rows a step (32 at 96 columns).  10 products a pair.
//
// float32 (namespace cc): the CUDA cores, no TF32 (the f32 train checks
// hold the card to the CPU at 1e-5).  Each step stages a (16 rows × 32
// keys) tile's P and dS in shared memory (one thread per pair, f32 dot
// products over head_dim), then accumulates dQ (rows × dims per thread) or
// dK and dV (keys × dims per thread) from it.  7 products a pair.
//
// Bound: the gradient's bytes (q, k, v, o, dO read once, dq, dk, dv written
// once) or, at long sequences, its five products over the kept pairs at
// the bf16 tensor-core rate; the recompute of S and dO·Vᵀ in the dQ pass
// and the hi + lo products add five products a pair the bound does not
// count.
#include <atomic>
#include <chrono>

#include "flash_hopper.cuh"

namespace {


constexpr float LOG2E = 1.4426950408889634f;

// Σ a ∘ b over 16 bytes: 8 bf16 or 4 f32
__device__ __forceinline__ float dot16(const uint4& a, const uint4& b, const __nv_bfloat16*) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 u = __bfloat1622float2(x[i]), w = __bfloat1622float2(y[i]);
    acc = fmaf(u.x, w.x, acc);
    acc = fmaf(u.y, w.y, acc);
  }
  return acc;
}
__device__ __forceinline__ float dot16(const uint4& a, const uint4& b, const float*) {
  const float4 u = *reinterpret_cast<const float4*>(&a), w = *reinterpret_cast<const float4*>(&b);
  return fmaf(u.x, w.x, fmaf(u.y, w.y, fmaf(u.z, w.z, u.w * w.w)));
}

// D = rowsum(dO ∘ o) of every (b, s, h) row of the contiguous (B, S, H, hd)
// o and dO, written at (b·H + h)·SP + s of delta; with lse2, also the
// forward's lse · log2 e there.  tpr threads a row (a power of two up to
// 32), 16-byte loads; warps past the rows' fill the npad pitch entries
// past S of every (b, h) row: D 0, lse2 +inf (P = 0 there).
template <typename T>
__global__ void flash_bwd_prep(const T* o, const T* dout, const float* lse, float* delta,
                               float* lse2, int S, int H, int hd, int SP, int64_t nrows,
                               int64_t npad, int tpr) {
  constexpr int VW = 16 / sizeof(T);
  const int lane = threadIdx.x & 31, rpw = 32 / tpr;
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
  const int64_t row_warps = (nrows + rpw - 1) / rpw;
  if (warp >= row_warps) {
    const int64_t i = (warp - row_warps) * 32 + lane;
    if (i >= npad) return;
    const int64_t at = i / (SP - S) * SP + S + i % (SP - S);
    delta[at] = 0.f;
    lse2[at] = __int_as_float(0x7f800000);
    return;
  }
  const int64_t row = warp * rpw + lane / tpr;
  const int sub = lane % tpr;
  float acc = 0.f;
  if (row < nrows) {
    const uint4* ov = reinterpret_cast<const uint4*>(o + row * hd);
    const uint4* dv = reinterpret_cast<const uint4*>(dout + row * hd);
    for (int c = sub; c < hd / VW; c += tpr) acc += dot16(ov[c], dv[c], o);
  }
  for (int m = tpr / 2; m; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (sub == 0 && row < nrows) {
    const int64_t b = row / (static_cast<int64_t>(S) * H);
    const int s = static_cast<int>((row / H) % S), h = static_cast<int>(row % H);
    delta[(b * H + h) * SP + s] = acc;
    if (lse2) lse2[(b * H + h) * SP + s] = lse[(b * H + h) * S + s] * LOG2E;
  }
}

// D into the (B, H, SP) delta (and lse2 beside it, when given)
template <typename T>
cudaError_t launch_prep(const T* o, const T* dout, const float* lse, float* delta, float* lse2,
                        int B, int S, int H, int hd, int SP, cudaStream_t stream) {
  const int64_t nrows = static_cast<int64_t>(B) * S * H;
  const int64_t npad = static_cast<int64_t>(B) * H * (SP - S);
  int tpr = 1;  // the largest power of two up to 32 and the row's 16-byte chunks
  while (tpr < 32 && 2 * tpr <= hd * static_cast<int>(sizeof(T)) / 16) tpr *= 2;
  constexpr int threads = 256;
  const int64_t warps = (nrows + 32 / tpr - 1) / (32 / tpr) + (npad + 31) / 32;
  const int64_t blocks = (warps + threads / 32 - 1) / (threads / 32);
  flash_bwd_prep<T><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      o, dout, lse, delta, lse2, S, H, hd, SP, nrows, npad, tpr);
  return cudaGetLastError();
}

// dk = scale·Σ_z part_dk[z], dv = Σ_z part_dv[z], z in order, from the
// (splits, 2, n) f32 partials of a split dK/dV pass: two bf16 per thread
__global__ void flash_bwd_sum(const float* part, __nv_bfloat16* dk, __nv_bfloat16* dv, int64_t n,
                              int splits, float scale) {
  const int64_t i = 2 * (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x);
  if (i >= n) return;
  float2 sk = make_float2(0.f, 0.f), sv = make_float2(0.f, 0.f);
  for (int z = 0; z < splits; ++z) {
    const float2 a = *reinterpret_cast<const float2*>(part + 2 * z * n + i);
    const float2 c = *reinterpret_cast<const float2*>(part + (2 * z + 1) * n + i);
    sk.x += a.x;
    sk.y += a.y;
    sv.x += c.x;
    sv.y += c.y;
  }
  *reinterpret_cast<__nv_bfloat162*>(dk + i) = __floats2bfloat162_rn(sk.x * scale, sk.y * scale);
  *reinterpret_cast<__nv_bfloat162*>(dv + i) = __floats2bfloat162_rn(sv.x, sv.y);
}

cudaError_t launch_sum(const float* part, __nv_bfloat16* dk, __nv_bfloat16* dv, int64_t n,
                       int splits, float scale, cudaStream_t stream) {
  flash_bwd_sum<<<static_cast<unsigned>((n / 2 + 255) / 256), 256, 0, stream>>>(part, dk, dv, n,
                                                                               splits, scale);
  return cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// bfloat16: the tensor cores
// ---------------------------------------------------------------------------
namespace tc {

struct BwdParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;  // (B, S, H, hd) contiguous
  const float* lse;  // (B, H, S)
  const float* delta;
  bf16* dq;  // (B, S, H, hd) contiguous
  bf16* dk;  // (B, T, K, hd) contiguous
  bf16* dv;
  int64_t sqb, sqs, sqh, skb, skt, skh, svb, svt, svh;  // element strides of q, k, v
  int B, S, T, H, K, G;
  int causal;
  int window;
  int qpos;
  float scale;
  const int* key_pos;
  int kv_splits;  // > 1: the dK/dV pass splits each key tile's rows over blocks
  float* part;    // then (kv_splits, 2, B, T, K, hd) f32 partials, summed by flash_bwd_sum
};

// A fragments of one k-step (16 along k) from the accumulator fragments of
// two n-tiles (8 along n each) of the previous product, as bf16 hi + lo
__device__ __forceinline__ void frag_a(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                      const float (&c0)[4], const float (&c1)[4]) {
  split2(c0[0], c0[1], hi[0], lo[0]);
  split2(c0[2], c0[3], hi[1], lo[1]);
  split2(c1[0], c1[1], hi[2], lo[2]);
  split2(c1[2], c1[3], hi[3], lo[3]);
}

// the offset of a flat row of (b, kv head) in a contiguous (B, S, H, hd) array
template <int HD>
__device__ __forceinline__ int64_t row_off(const BwdParams& p, int b, int kvh, int flat) {
  const int s = flat / p.G, h = kvh * p.G + flat % p.G;
  return ((static_cast<int64_t>(b) * p.S + s) * p.H + h) * HD;
}

// dQ pass: 64 flat rows (4 warps × 16) of one (b, kv head) against BN keys a
// step; Q and dO stay in shared memory, K and V stream through two stages.
template <int HD, int BN>
struct DqCfg {
  static constexpr int BM = 64;
  static constexpr int LD = HD + 8;  // rows 16 bytes apart mod 128: ldmatrix without conflicts
  static constexpr int SMEM = 2 * BM * LD * 2 + 2 * 2 * BN * LD * 2;
  static_assert(HD % 16 == 0 && BN % 16 == 0, "tiles are whole mma steps");
  static_assert(SMEM <= SMEM_MAX, "shared memory");
};

template <int HD, int BN>
__global__ void __launch_bounds__(NT) flash_bwd_dq_tc(BwdParams p) {
  using C = DqCfg<HD, BN>;
  constexpr int BM = C::BM, LD = C::LD;
  constexpr int NKT = BN / 8;  // score n-tiles of a warp
  constexpr int NDT = HD / 8;  // dQ n-tiles
  constexpr int CH = HD / 8;   // 16-byte chunks of a row

  extern __shared__ uint4 smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // BM × LD
  bf16* dOs = Qs + BM * LD;                      // BM × LD
  bf16* Ks = dOs + BM * LD;                      // 2 × BN × LD
  bf16* Vs = Ks + 2 * BN * LD;                   // 2 × BN × LD

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = p.S * p.G;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * BM;  // the longest causal tiles first
  const int bk = blockIdx.y, b = bk / p.K, kvh = bk % p.K;
  const bf16* kp = p.k + static_cast<int64_t>(b) * p.skb + static_cast<int64_t>(kvh) * p.skh;
  const bf16* vp = p.v + static_cast<int64_t>(b) * p.svb + static_cast<int64_t>(kvh) * p.svh;

  for (int idx = tid; idx < BM * CH; idx += NT) {
    const int r = idx / CH, c = (idx % CH) * 8;
    const int flat = row0 + r;
    const bool ok = flat < rows;
    const bf16* qsrc = p.q;
    const bf16* dsrc = p.dout;
    if (ok) {
      const int s = flat / p.G, h = kvh * p.G + flat % p.G;
      qsrc += static_cast<int64_t>(b) * p.sqb + static_cast<int64_t>(s) * p.sqs +
              static_cast<int64_t>(h) * p.sqh + c;
      dsrc += row_off<HD>(p, b, kvh, flat) + c;
    }
    load16(Qs + r * LD + c, qsrc, ok, 1);
    load16(dOs + r * LD + c, dsrc, ok, 1);
  }
  cp_commit();

  int kbeg, kend;
  causal_range(p, row0, min(row0 + BM, rows), kbeg, kend);
  const int ntiles = kend > kbeg ? (kend - kbeg + BN - 1) / BN : 0;
  auto load_tile = [&](int it) {
    const int t0 = kbeg + it * BN;
    bf16* kd = Ks + (it & 1) * BN * LD;
    bf16* vd = Vs + (it & 1) * BN * LD;
    for (int idx = tid; idx < BN * CH; idx += NT) {
      const int j = idx / CH, c = (idx % CH) * 8;
      const int t = t0 + j;
      const bool ok = t < kend;
      load16(kd + j * LD + c, ok ? kp + static_cast<int64_t>(t) * p.skt + c : kp, ok, 1);
      load16(vd + j * LD + c, ok ? vp + static_cast<int64_t>(t) * p.svt + c : vp, ok, 1);
    }
  };
  if (ntiles > 0) load_tile(0);
  cp_commit();

  // this thread's fragment rows: g and g + 8 of the warp's 16
  const int g = lane >> 2, t4 = lane & 3;
  const int frow = row0 + warp * 16 + g;
  bool rv[2];
  int qi[2];
  float lse_r[2], d_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int flat = frow + 8 * r;
    rv[r] = flat < rows;
    qi[r] = flat / p.G;
    lse_r[r] = rv[r] ? p.lse[lse_index(p, b, kvh, flat)] : 0.f;
    d_r[r] = rv[r] ? p.delta[lse_index(p, b, kvh, flat)] : 0.f;
  }
  float acc[NDT][4];
#pragma unroll
  for (int d = 0; d < NDT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    cp_wait<0>();     // Q, dO and tile it have landed
    __syncthreads();  // ... for every thread; and tile it - 1's slot is free
    if (it + 1 < ntiles) load_tile(it + 1);
    cp_commit();
    const bf16* Kt = Ks + (it & 1) * BN * LD;
    const bf16* Vt = Vs + (it & 1) * BN * LD;

    // S = Q·Kᵀ and dP = dO·Vᵀ: 16 rows × BN keys of this warp
    float sc[NKT][4], dp[NKT][4];
#pragma unroll
    for (int j = 0; j < NKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4], ad[4];
      ldsm_x4(a, Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
      ldsm_x4(ad, dOs + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < NKT / 2; ++nj) {
        const int off = (nj * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                        ((lane >> 3) & 1) * 8;
        uint32_t bb[4];
        ldsm_x4(bb, Kt + off);
        mma(sc[2 * nj], a, bb[0], bb[1]);
        mma(sc[2 * nj + 1], a, bb[2], bb[3]);
        ldsm_x4(bb, Vt + off);
        mma(dp[2 * nj], ad, bb[0], bb[1]);
        mma(dp[2 * nj + 1], ad, bb[2], bb[3]);
      }
    }

    // P = exp(s·scale − lse) on the kept pairs, dS = P ∘ (dP − D), into sc;
    // a tile the mask keeps whole skips the per-pair test
    const int t0 = kbeg + it * BN;
    const bool full = row0 + BM <= rows && t0 + BN <= kend &&
                      (!p.causal || (!p.key_pos && t0 + BN - 1 <= p.qpos + row0 / p.G &&
                                     (p.window <= 0 ||
                                      t0 > p.qpos + (row0 + BM - 1) / p.G - p.window)));
    const int key0 = t0 + 2 * t4;
#pragma unroll
    for (int j = 0; j < NKT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + j * 8 + (e & 1), r = e >> 1;
        const bool ok =
            full || (rv[r] && key < kend && (!p.causal || keep_key(p, key, qi[r])));
        const float pr = ok ? __expf(sc[j][e] * p.scale - lse_r[r]) : 0.f;
        sc[j][e] = pr * (dp[j][e] - d_r[r]);
      }
    }

    // dQ += dS·K: the dS fragments of 16 keys are the A fragment of one
    // k-step, as bf16 hi + lo (two products: dS keeps its f32 precision)
#pragma unroll
    for (int ks = 0; ks < BN / 16; ++ks) {
      uint32_t ah[4], al[4];
      frag_a(ah, al, sc[2 * ks], sc[2 * ks + 1]);
#pragma unroll
      for (int dj = 0; dj < HD / 16; ++dj) {
        uint32_t bb[4];
        ldsm_x4_t(bb, Kt + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dj * 16 +
                          (lane >> 4) * 8);
        mma(acc[2 * dj], ah, bb[0], bb[1]);
        mma(acc[2 * dj], al, bb[0], bb[1]);
        mma(acc[2 * dj + 1], ah, bb[2], bb[3]);
        mma(acc[2 * dj + 1], al, bb[2], bb[3]);
      }
    }
  }
  cp_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!rv[r]) continue;
    bf16* dst = p.dq + row_off<HD>(p, b, kvh, frow + 8 * r);
#pragma unroll
    for (int d = 0; d < NDT; ++d)
      *reinterpret_cast<__nv_bfloat162*>(dst + d * 8 + 2 * t4) =
          __floats2bfloat162_rn(acc[d][2 * r] * p.scale, acc[d][2 * r + 1] * p.scale);
  }
}

// dK/dV pass: 64 keys (4 warps × 16) of one (b, kv head), every output
// column, against BMQ flat rows a step; K and V stay in shared memory, Q,
// dO, lse and D stream through two stages.  With kv_splits > 1 the rows a
// key tile keeps are cut into kv_splits runs, one block each, whose f32
// partials flash_bwd_sum adds in split order.
template <int HD, int BMQ>
struct DkvCfg {
  static constexpr int BN = 64;
  static constexpr int LD = HD + 8;
  static constexpr int STAGE = 2 * BMQ * LD * 2 + 2 * BMQ * 4;  // Q, dO; lse, D
  static constexpr int SMEM = 2 * BN * LD * 2 + 2 * STAGE;
  static_assert(HD % 16 == 0 && BMQ % 16 == 0, "tiles are whole mma steps");
  static_assert(SMEM <= SMEM_MAX, "shared memory");
};

template <int HD, int BMQ>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_tc(BwdParams p) {
  using C = DkvCfg<HD, BMQ>;
  constexpr int BN = C::BN, LD = C::LD;
  constexpr int NRT = BMQ / 8;  // n-tiles of a step's rows
  constexpr int NCT = HD / 8;   // n-tiles of the output columns
  constexpr int CH = HD / 8;

  extern __shared__ uint4 smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // BN × LD
  bf16* Vs = Ks + BN * LD;                       // BN × LD
  bf16* Qs = Vs + BN * LD;                       // 2 × BMQ × LD
  bf16* dOs = Qs + 2 * BMQ * LD;                 // 2 × BMQ × LD
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * BMQ * LD);  // 2 × BMQ
  float* d_s = lse_s + 2 * BMQ;                                 // 2 × BMQ

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = blockIdx.x * BN;  // the longest causal key tiles start first
  const int k1 = min(k0 + BN, p.T);
  const int bk = blockIdx.y, b = bk / p.K, kvh = bk % p.K;
  const int z = blockIdx.z;  // this block's run of the key tile's rows
  const bf16* kp = p.k + static_cast<int64_t>(b) * p.skb + static_cast<int64_t>(kvh) * p.skh;
  const bf16* vp = p.v + static_cast<int64_t>(b) * p.svb + static_cast<int64_t>(kvh) * p.svh;

  for (int idx = tid; idx < BN * CH; idx += NT) {
    const int j = idx / CH, c = (idx % CH) * 8;
    const int t = k0 + j;
    const bool ok = t < k1;
    load16(Ks + j * LD + c, ok ? kp + static_cast<int64_t>(t) * p.skt + c : kp, ok, 1);
    load16(Vs + j * LD + c, ok ? vp + static_cast<int64_t>(t) * p.svt + c : vp, ok, 1);
  }
  cp_commit();

  int r0, r1;
  causal_rows(p, k0, k1, r0, r1);
  if (p.kv_splits > 1) {  // runs of whole steps, in order
    const int run = ((r1 - r0 + p.kv_splits - 1) / p.kv_splits + BMQ - 1) / BMQ * BMQ;
    r0 = min(r1, r0 + z * run);
    r1 = min(r1, r0 + run);
  }
  const int ntiles = r1 > r0 ? (r1 - r0 + BMQ - 1) / BMQ : 0;
  auto load_rows = [&](int it) {
    const int base = r0 + it * BMQ, slot = it & 1;
    bf16* qd = Qs + slot * BMQ * LD;
    bf16* dd = dOs + slot * BMQ * LD;
    for (int idx = tid; idx < BMQ * CH; idx += NT) {
      const int r = idx / CH, c = (idx % CH) * 8;
      const int flat = base + r;
      const bool ok = flat < r1;
      const bf16* qsrc = p.q;
      const bf16* dsrc = p.dout;
      if (ok) {
        const int s = flat / p.G, h = kvh * p.G + flat % p.G;
        qsrc += static_cast<int64_t>(b) * p.sqb + static_cast<int64_t>(s) * p.sqs +
                static_cast<int64_t>(h) * p.sqh + c;
        dsrc += row_off<HD>(p, b, kvh, flat) + c;
      }
      load16(qd + r * LD + c, qsrc, ok, 1);
      load16(dd + r * LD + c, dsrc, ok, 1);
    }
    for (int r = tid; r < BMQ; r += NT) {
      const int flat = base + r;
      const bool ok = flat < r1;
      const int64_t at = ok ? lse_index(p, b, kvh, flat) : 0;
      load4(lse_s + slot * BMQ + r, p.lse + at, ok);
      load4(d_s + slot * BMQ + r, p.delta + at, ok);
    }
  };
  if (ntiles > 0) load_rows(0);
  cp_commit();

  // this thread's fragment keys: g and g + 8 of the warp's 16
  const int g = lane >> 2, t4 = lane & 3;
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  float dk[NCT][4], dv[NCT][4];
#pragma unroll
  for (int d = 0; d < NCT; ++d)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[d][e] = dv[d][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    cp_wait<0>();
    __syncthreads();
    if (it + 1 < ntiles) load_rows(it + 1);
    cp_commit();
    const int slot = it & 1;
    const bf16* Qt = Qs + slot * BMQ * LD;
    const bf16* dOt = dOs + slot * BMQ * LD;
    const float* lse_t = lse_s + slot * BMQ;
    const float* d_t = d_s + slot * BMQ;

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: the warp's 16 keys × BMQ rows
    float st[NRT][4], dpt[NRT][4];
#pragma unroll
    for (int j = 0; j < NRT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4], av[4];
      ldsm_x4(a, Ks + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
      ldsm_x4(av, Vs + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < NRT / 2; ++nj) {
        const int off = (nj * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                        ((lane >> 3) & 1) * 8;
        uint32_t bb[4];
        ldsm_x4(bb, Qt + off);
        mma(st[2 * nj], a, bb[0], bb[1]);
        mma(st[2 * nj + 1], a, bb[2], bb[3]);
        ldsm_x4(bb, dOt + off);
        mma(dpt[2 * nj], av, bb[0], bb[1]);
        mma(dpt[2 * nj + 1], av, bb[2], bb[3]);
      }
    }

    // Pᵀ on the kept pairs into st, dSᵀ = Pᵀ ∘ (dPᵀ − D) into dpt; a step
    // the mask keeps whole skips the per-pair test
    const int base = r0 + it * BMQ;
    const bool full = base + BMQ <= r1 && k0 + BN <= k1 &&
                      (!p.causal || (!p.key_pos && k0 + BN - 1 <= p.qpos + base / p.G &&
                                     (p.window <= 0 ||
                                      k0 > p.qpos + (base + BMQ - 1) / p.G - p.window)));
#pragma unroll
    for (int j = 0; j < NRT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rl = j * 8 + 2 * t4 + (e & 1), kj = key[e >> 1];
        const int flat = base + rl;
        const bool ok =
            full || (flat < r1 && kj < k1 && (!p.causal || keep_key(p, kj, flat / p.G)));
        const float pr = ok ? __expf(st[j][e] * p.scale - lse_t[rl]) : 0.f;
        st[j][e] = pr;
        dpt[j][e] = pr * (dpt[j][e] - d_t[rl]);
      }
    }

    // dV += Pᵀ·dO and dK += dSᵀ·Q over every column, Pᵀ and dSᵀ as
    // bf16 hi + lo; dO and Q through ldmatrix.trans (rows are the k index)
#pragma unroll
    for (int ks = 0; ks < BMQ / 16; ++ks) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
      frag_a(ph, pl, st[2 * ks], st[2 * ks + 1]);
      frag_a(sh, sl, dpt[2 * ks], dpt[2 * ks + 1]);
#pragma unroll
      for (int dj = 0; dj < HD / 16; ++dj) {
        const int off = (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dj * 16 +
                        (lane >> 4) * 8;
        uint32_t bb[4];
        ldsm_x4_t(bb, dOt + off);
        mma(dv[2 * dj], ph, bb[0], bb[1]);
        mma(dv[2 * dj], pl, bb[0], bb[1]);
        mma(dv[2 * dj + 1], ph, bb[2], bb[3]);
        mma(dv[2 * dj + 1], pl, bb[2], bb[3]);
        ldsm_x4_t(bb, Qt + off);
        mma(dk[2 * dj], sh, bb[0], bb[1]);
        mma(dk[2 * dj], sl, bb[0], bb[1]);
        mma(dk[2 * dj + 1], sh, bb[2], bb[3]);
        mma(dk[2 * dj + 1], sl, bb[2], bb[3]);
      }
    }
  }
  cp_wait<0>();

  const int64_t n = static_cast<int64_t>(p.B) * p.T * p.K * HD;  // elements of dk
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= k1) continue;
    const int64_t off = ((static_cast<int64_t>(b) * p.T + key[r]) * p.K + kvh) * HD;
#pragma unroll
    for (int d = 0; d < NCT; ++d) {
      const int64_t at = off + d * 8 + 2 * t4;
      if (p.kv_splits > 1) {
        float* part = p.part + 2 * z * n;
        *reinterpret_cast<float2*>(part + at) = make_float2(dk[d][2 * r], dk[d][2 * r + 1]);
        *reinterpret_cast<float2*>(part + n + at) = make_float2(dv[d][2 * r], dv[d][2 * r + 1]);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(p.dk + at) =
            __floats2bfloat162_rn(dk[d][2 * r] * p.scale, dk[d][2 * r + 1] * p.scale);
        *reinterpret_cast<__nv_bfloat162*>(p.dv + at) =
            __floats2bfloat162_rn(dv[d][2 * r], dv[d][2 * r + 1]);
      }
    }
  }
}

// The tiles of each head_dim this route takes (16, 32, 96): (dQ keys a
// step; dK/dV columns a block, rows a step).  ops.bwd_plan mirrors this
// table, and the entry point refuses a plan that differs from it.
template <int HD>
struct Tiles {
  static constexpr int DQ_KEYS = HD <= 64 ? 64 : 32;
  static constexpr int KV_COLS = HD;
  static constexpr int KV_ROWS = HD <= 64 ? 64 : 32;
};

template <int HD>
cudaError_t launch_bwd(const BwdParams& p, cudaStream_t stream) {
  using T = Tiles<HD>;
  using Q = DqCfg<HD, T::DQ_KEYS>;
  using V = DkvCfg<HD, T::KV_ROWS>;
  static svc::PerDevice<cudaError_t> attr_kv_cards;
  const cudaError_t attr_kv = svc::allow_smem(
      attr_kv_cards, flash_bwd_dkv_tc<HD, T::KV_ROWS>, V::SMEM);
  static svc::PerDevice<cudaError_t> attr_q_cards;
  const cudaError_t attr_q = svc::allow_smem(
      attr_q_cards, flash_bwd_dq_tc<HD, T::DQ_KEYS>, Q::SMEM);
  if (attr_kv != cudaSuccess) return attr_kv;
  if (attr_q != cudaSuccess) return attr_q;
  if (p.kv_splits < 1 || (p.kv_splits > 1 && p.part == nullptr)) return cudaErrorInvalidValue;
  const dim3 kv_grid((p.T + V::BN - 1) / V::BN, p.B * p.K, p.kv_splits);
  flash_bwd_dkv_tc<HD, T::KV_ROWS><<<kv_grid, NT, V::SMEM, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (p.kv_splits > 1) {
    err = launch_sum(p.part, p.dk, p.dv, static_cast<int64_t>(p.B) * p.T * p.K * HD, p.kv_splits,
                     p.scale, stream);
    if (err != cudaSuccess) return err;
  }
  const dim3 q_grid((p.S * p.G + Q::BM - 1) / Q::BM, p.B * p.K);
  flash_bwd_dq_tc<HD, T::DQ_KEYS><<<q_grid, NT, Q::SMEM, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// bfloat16 at head_dim 64, 128 and 256: warpgroups (wgmma, TMA)
// ---------------------------------------------------------------------------
namespace wg {

using hop::bf16;
constexpr int NTH = 384;   // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int TILE = 64;   // keys of a dK/dV block, queries of a dQ block: a wgmma's M
constexpr int REG_CONSUMER = 240, REG_PRODUCER = 24;  // 384 threads launch with 168 each
constexpr int XF = 1, XE = 2, R1 = 3, R2 = 4;  // named barriers: exchange full and empty,
                                               // dQ's reduction

// per head_dim: BM, the keys of a dK/dV block and the queries of a dQ
// block, and the producer's ring slots.  SOLO (head_dim 64): each consumer
// warpgroup owns 64 of the block's 128 keys (or queries) and computes
// every product of them, so nothing crosses between warpgroups and a block
// reads the other operand once for twice the work (one warpgroup holds dK
// and dV there, 64 registers a thread).  Otherwise (128, 256) the two
// warpgroups share 64 keys (or queries) and split the products, since
// 64 × 256 f32 of dK and of dV do not fit one warpgroup.  At 256 two slots
// are what shared memory holds beside the resident tiles.  A step is 64
// queries (dK/dV) or keys (dQ) everywhere.
template <int HD>
struct Cfg {
  static constexpr bool SOLO = HD == 64;
  static constexpr int BM = SOLO ? 2 * TILE : TILE;
  static constexpr int STAGES = HD == 64 ? 4 : (HD == 128 ? 3 : 2);
};

// the pitch of the (B, H, SP) lse2 and D rows: whole 64-query tiles and
// two more, so a step's bulk copy (at most 128 entries from a query below
// S) never leaves its row (ops._bwd_pitch)
inline int pitch(int S) { return (S + TILE - 1) / TILE * TILE + 2 * TILE; }

struct Params {
  bf16* dq;           // (B, S, H, hd) contiguous
  bf16* dk;           // (B, T, K, hd) contiguous
  bf16* dv;
  const float* lse2;  // (B, H, SP): the forward's lse · log2 e, +inf past S
  const float* dlt;   // (B, H, SP): D, 0 past S
  float* part;        // (kv_splits, 2, B, T, K, hd) f32 partials when kv_splits > 1
  const int* key_pos;
  int B, S, T, H, K, G, SP;
  int causal, window, qpos;
  float scale, scale2;  // 1/sqrt(hd), and times log2 e
  int kv_splits;
};

// the mask helpers of flash_common.cuh over query indices: every row of
// this route is one query of one head (G = 1 there)
struct Mask {
  const int* key_pos;
  int S, T, G, causal, window, qpos;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// the bf16 hi (low == false) or lo part of the A fragments of the 4
// k-steps (16 along k each) of a 64 × 64 accumulator x, whose layout is the
// A fragments' (the forward's P·V trick); hi + lo is x to about 2^-16
__device__ __forceinline__ void frags_part(uint32_t (&a)[TILE / 16][4], const float (&x)[TILE / 2],
                                           bool low) {
#pragma unroll
  for (int ks = 0; ks < TILE / 16; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      uint32_t hi, lo;
      tc::split2(x[8 * ks + 2 * r], x[8 * ks + 2 * r + 1], hi, lo);
      a[ks][r] = low ? lo : hi;
    }
}

// x (64 × 64 f32) = A·Bᵀ over the head_dim: A and B 64-row K-major tiles
template <int HD>
__device__ __forceinline__ void s_product(float (&x)[TILE / 2], const bf16* A, const bf16* Bt) {
#pragma unroll
  for (int e = 0; e < TILE / 2; ++e) x[e] = 0.f;
  hop::wg_fence();
  hop::pin(x);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    hop::wgmma_ss_n64(x, hop::desc_k(A, TILE, kk), hop::desc_k(Bt, TILE, kk), kk > 0);
  hop::wg_commit();
  hop::wg_wait<0>();
  hop::pin(x);
}

// both S-side products of a solo warpgroup, one wait: x1 = A1·B1ᵀ and
// x2 = A2·B2ᵀ
template <int HD>
__device__ __forceinline__ void s_products(float (&x1)[TILE / 2], const bf16* A1, const bf16* B1,
                                           float (&x2)[TILE / 2], const bf16* A2,
                                           const bf16* B2) {
#pragma unroll
  for (int e = 0; e < TILE / 2; ++e) x1[e] = x2[e] = 0.f;
  hop::wg_fence();
  hop::pin(x1);
  hop::pin(x2);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    hop::wgmma_ss_n64(x1, hop::desc_k(A1, TILE, kk), hop::desc_k(B1, TILE, kk), kk > 0);
    hop::wgmma_ss_n64(x2, hop::desc_k(A2, TILE, kk), hop::desc_k(B2, TILE, kk), kk > 0);
  }
  hop::wg_commit();
  hop::wg_wait<0>();
  hop::pin(x1);
  hop::pin(x2);
}

// acc (64 × HD f32) += a·B over 64: a the A fragments of 4 k-steps, B a
// 64-row tile read MN-major
template <int HD>
__device__ __forceinline__ void acc_product(float (&acc)[HD / 2], uint32_t (&a)[TILE / 16][4],
                                            const bf16* Bm) {
  hop::wg_fence();
  hop::pin(acc);
  hop::pin(a);
#pragma unroll
  for (int ks = 0; ks < TILE / 16; ++ks)
    hop::wgmma_rs<HD>(acc, a[ks], hop::desc_mn(Bm, TILE, ks));
  hop::wg_commit();
  hop::wg_wait<0>();
  hop::pin(acc);
  hop::pin(a);
}

// acc += (x_hi + x_lo)·B: both halves of x's bf16 split, one wait
template <int HD>
__device__ __forceinline__ void acc_product2(float (&acc)[HD / 2], const float (&x)[TILE / 2],
                                             const bf16* Bm) {
  uint32_t ah[TILE / 16][4], al[TILE / 16][4];
  frags_part(ah, x, false);
  frags_part(al, x, true);
  hop::wg_fence();
  hop::pin(acc);
  hop::pin(ah);
  hop::pin(al);
#pragma unroll
  for (int ks = 0; ks < TILE / 16; ++ks) {
    hop::wgmma_rs<HD>(acc, ah[ks], hop::desc_mn(Bm, TILE, ks));
    hop::wgmma_rs<HD>(acc, al[ks], hop::desc_mn(Bm, TILE, ks));
  }
  hop::wg_commit();
  hop::wg_wait<0>();
  hop::pin(acc);
  hop::pin(ah);
  hop::pin(al);
}

// a 64-row tile at (row, head, b) of a tensor map: one 64 × 64 box for each
// of its 64-column panels
template <int HD>
__device__ __forceinline__ void load_tile(bf16* dst, const CUtensorMap* map, uint64_t* bar,
                                          int row, int head, int b) {
#pragma unroll
  for (int c = 0; c < HD / 64; ++c)
    hop::tma_load_4d(dst + c * TILE * 64, map, bar, c * 64, row, head, b);
}

// The dK/dV pass's shared memory: K and V (BM / 64 tiles each), the ring's
// Q and dO tiles (1024-byte aligned for the swizzle), its lse2 and D rows,
// the Pᵀ exchange where the warpgroups share keys, the barriers
template <int HD>
struct KvSmem {
  static constexpr int BM = Cfg<HD>::BM, STAGES = Cfg<HD>::STAGES;
  static constexpr int TK = BM * HD * 2, TQ = TILE * HD * 2;  // bytes of K (or V), a Q tile
  static constexpr int Q0 = 2 * TK;                            // slot st: Q, then dO
  static constexpr int LSE = Q0 + 2 * STAGES * TQ;
  static constexpr int DLT = LSE + STAGES * TILE * 4;
  static constexpr int X = DLT + STAGES * TILE * 4;
  static constexpr int BAR = X + (Cfg<HD>::SOLO ? 0 : TILE * TILE * 4);
  static constexpr int SMEM = BAR + 64 + 1024;  // and the base's alignment
  static_assert(SMEM <= tc::SMEM_MAX, "shared memory");
};

// dK/dV pass: one block per (BM keys, b·kv head, run of steps).  The
// producer loads K and V once, then a step's (64 queries of one group
// head) Q, dO, lse2 and D per ring slot; the steps run over the group's
// heads, each over the queries [s0, s1) that can keep a key of the block.
// Shared keys (head_dim 128, 256): warpgroup 0 computes Sᵀ = K·Qᵀ and Pᵀ,
// passes Pᵀ to warpgroup 1 through shared memory and accumulates
// dV += Pᵀ·dO; warpgroup 1 computes dPᵀ = V·dOᵀ, dSᵀ = Pᵀ ∘ (dPᵀ − D) and
// accumulates dK += dSᵀ·Q: each of Sᵀ and dPᵀ once per (key tile, step).
// Solo (head_dim 64): warpgroup w does all of that for its own 64 keys.
// With kv_splits > 1 each key tile's steps are cut into kv_splits runs,
// one block each, whose f32 partials flash_bwd_sum adds in run order.
template <int HD>
__device__ __forceinline__ void dkv_block(const CUtensorMap* tq, const CUtensorMap* tdo,
                                          const CUtensorMap* tk, const CUtensorMap* tv,
                                          const Params& p, uint8_t* sm, int kt, int bk, int z) {
  using L = KvSmem<HD>;
  constexpr int BM = L::BM, STAGES = L::STAGES;
  constexpr bool SOLO = Cfg<HD>::SOLO;
  bf16* Ks = reinterpret_cast<bf16*>(sm);
  bf16* Vs = reinterpret_cast<bf16*>(sm + L::TK);
  auto Qs = [&](int st) { return reinterpret_cast<bf16*>(sm + L::Q0 + 2 * st * L::TQ); };
  auto dOs = [&](int st) { return reinterpret_cast<bf16*>(sm + L::Q0 + (2 * st + 1) * L::TQ); };
  float* lse_s = reinterpret_cast<float*>(sm + L::LSE);
  float* d_s = reinterpret_cast<float*>(sm + L::DLT);
  float* X = reinterpret_cast<float*>(sm + L::X);
  uint64_t* kv_bar = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* full = kv_bar + 1;
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, wgi = tid / 128, wtid = tid % 128;
  const int warp = wtid / 32, lane = tid & 31;
  const int k0 = kt * BM;
  const int b = bk / p.K, kvh = bk % p.K;
  const Mask mk{p.key_pos, p.S, p.T, 1, p.causal, p.window, p.qpos};
  int s0, s1;
  causal_rows(mk, k0, min(k0 + BM, p.T), s0, s1);
  s0 &= ~3;  // 16-byte aligned lse2 and D copies; the queries below keep no key of the block
  const int per_head = s1 > s0 ? (s1 - s0 + TILE - 1) / TILE : 0;
  const int total = p.G * per_head;
  const int run = (total + p.kv_splits - 1) / p.kv_splits;
  const int it0 = min(total, z * run);
  const int nsteps = min(total, it0 + run) - it0;

  if (tid == 0) {
    hop::mbar_init(kv_bar, 1);
    for (int st = 0; st < STAGES; ++st) {
      hop::mbar_init(full + st, 1);
      hop::mbar_init(empty + st, 8);  // the consumers' warps
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (wgi == 2) {  // the producer: one thread issues every copy
    hop::reg_dealloc<REG_PRODUCER>();
    if (wtid == 0 && nsteps > 0) {
      hop::mbar_expect_tx(kv_bar, 2 * L::TK);
      for (int w = 0; w < BM / TILE; ++w) {
        load_tile<HD>(Ks + w * TILE * HD, tk, kv_bar, k0 + w * TILE, kvh, b);
        load_tile<HD>(Vs + w * TILE * HD, tv, kv_bar, k0 + w * TILE, kvh, b);
      }
      for (int i = 0; i < nsteps; ++i) {
        const int st = i % STAGES;
        hop::mbar_wait(empty + st, ((i / STAGES) & 1) ^ 1);
        const int it = it0 + i, h = kvh * p.G + it / per_head, s = s0 + it % per_head * TILE;
        hop::mbar_expect_tx(full + st, 2 * L::TQ + 2 * TILE * 4);
        load_tile<HD>(Qs(st), tq, full + st, s, h, b);
        load_tile<HD>(dOs(st), tdo, full + st, s, h, b);
        const int64_t row = (static_cast<int64_t>(b) * p.H + h) * p.SP + s;
        hop::bulk_load(lse_s + st * TILE, p.lse2 + row, TILE * 4, full + st);
        hop::bulk_load(d_s + st * TILE, p.dlt + row, TILE * 4, full + st);
      }
    }
    return;
  }

  hop::reg_alloc<REG_CONSUMER>();
  const int g8 = lane >> 2, t4 = lane & 3;
  const int kw = k0 + (SOLO ? wgi * TILE : 0);  // this warpgroup's keys [kw, kw + 64)
  const int key_lo = kw + warp * 16 + g8;      // this thread's keys: key_lo and key_lo + 8
  const bf16* Kw = Ks + (kw - k0) * HD;
  const bf16* Vw = Vs + (kw - k0) * HD;
  float acc[HD / 2];                  // dV (solo, or warpgroup 0) or dK (warpgroup 1)
  float acck[SOLO ? HD / 2 : 1];      // dK (solo)
#pragma unroll
  for (int e = 0; e < HD / 2; ++e) acc[e] = 0.f;
#pragma unroll
  for (int e = 0; e < (SOLO ? HD / 2 : 1); ++e) acck[e] = 0.f;
  if (nsteps > 0) hop::mbar_wait(kv_bar, 0);
  for (int i = 0; i < nsteps; ++i) {
    const int st = i % STAGES;
    hop::mbar_wait(full + st, (i / STAGES) & 1);
    const int s = s0 + (it0 + i) % per_head * TILE;
    const bf16* Qt = Qs(st);
    const bf16* dOt = dOs(st);
    // Pᵀ = exp(sᵀ·scale − lse) on the kept pairs; a step the mask keeps
    // whole skips the per-pair test
    const bool whole = s + TILE <= p.S && kw + TILE <= p.T &&
                       (!p.causal || (!p.key_pos && kw + TILE - 1 <= p.qpos + s &&
                                      (p.window <= 0 || kw > p.qpos + s + TILE - 1 - p.window)));
    const float* ls = lse_s + st * TILE;
    const float* dd = d_s + st * TILE;
    auto prob = [&](float sc, int j, int e) {
      const int qi = 8 * j + 2 * t4 + (e & 1), key = key_lo + 8 * (e >> 1);
      const bool ok = whole || (s + qi < p.S && key < p.T &&
                                (!p.causal || keep_key(mk, key, s + qi)));
      return ok ? ex2(fmaf(sc, p.scale2, -ls[qi])) : 0.f;
    };
    if constexpr (SOLO) {
      float xs[TILE / 2], xd[TILE / 2];  // Sᵀ and dPᵀ: 64 keys × 64 queries
      s_products<HD>(xs, Kw, Qt, xd, Vw, dOt);
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pr = prob(xs[4 * j + e], j, e);
          xs[4 * j + e] = pr;
          xd[4 * j + e] = pr * (xd[4 * j + e] - dd[8 * j + 2 * t4 + (e & 1)]);
        }
      acc_product2<HD>(acc, xs, dOt);   // dV += Pᵀ·dO
      acc_product2<HD>(acck, xd, Qt);   // dK += dSᵀ·Q
    } else {
      float x[TILE / 2];  // Sᵀ (warpgroup 0) or dPᵀ (1)
      s_product<HD>(x, wgi == 0 ? Kw : Vw, wgi == 0 ? Qt : dOt);
      if (wgi == 0) {
#pragma unroll
        for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) x[4 * j + e] = prob(x[4 * j + e], j, e);
        if (i > 0) hop::bar_sync(XE, 256);  // warpgroup 1 has read the previous Pᵀ
#pragma unroll
        for (int e = 0; e < TILE / 2; ++e) X[e * 128 + wtid] = x[e];
        hop::bar_arrive(XF, 256);
      } else {
        hop::bar_sync(XF, 256);
#pragma unroll
        for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            x[4 * j + e] = X[(4 * j + e) * 128 + wtid] * (x[4 * j + e] - dd[8 * j + 2 * t4 + (e & 1)]);
        if (i + 1 < nsteps) hop::bar_arrive(XE, 256);
      }
      acc_product2<HD>(acc, x, wgi == 0 ? dOt : Qt);  // dV += Pᵀ·dO or dK += dSᵀ·Q
    }
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(empty + st);
  }

  // dK (slot 0 of a run's partials, scaled when rounded) and dV (slot 1)
  const int64_t n = static_cast<int64_t>(p.B) * p.T * p.K * HD;  // elements of dk
  auto store = [&](const float (&a)[HD / 2], bf16* out, float mul, int slot) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key_lo + 8 * r;
      if (key >= p.T) continue;
      const int64_t off = ((static_cast<int64_t>(b) * p.T + key) * p.K + kvh) * HD + 2 * t4;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        const float v0 = a[4 * j + 2 * r], v1 = a[4 * j + 2 * r + 1];
        if (p.kv_splits > 1)
          *reinterpret_cast<float2*>(p.part + (2 * static_cast<int64_t>(z) + slot) * n + off +
                                     8 * j) = make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(out + off + 8 * j) =
              __floats2bfloat162_rn(v0 * mul, v1 * mul);
      }
    }
  };
  if constexpr (SOLO) {
    store(acck, p.dk, p.scale, 0);
    store(acc, p.dv, 1.f, 1);
  } else if (wgi == 0) {
    store(acc, p.dv, 1.f, 1);
  } else {
    store(acc, p.dk, p.scale, 0);
  }
}

// The dQ pass's shared memory: Q and dO (BM / 64 tiles each), the ring's K
// and V tiles, the P and dP exchange where the warpgroups share queries,
// the barriers; there, after the loop, the ring holds warpgroup 1's half
// of dQ
template <int HD>
struct DqSmem {
  static constexpr int BM = Cfg<HD>::BM, STAGES = Cfg<HD>::STAGES;
  static constexpr int TQ = BM * HD * 2, TK = TILE * HD * 2;  // bytes of Q (or dO), a K tile
  static constexpr int K0 = 2 * TQ;                            // slot st: K, then V
  static constexpr int X = K0 + 2 * STAGES * TK;
  static constexpr int BAR = X + (Cfg<HD>::SOLO ? 0 : 2 * TILE * TILE * 4);
  static constexpr int SMEM = BAR + 64 + 1024;
  static_assert(SMEM <= tc::SMEM_MAX, "shared memory");
  static_assert(Cfg<HD>::SOLO || 2 * STAGES * TK >= TILE * HD * 4,
                "the ring holds a 64 × HD f32 dQ");
};

// dQ pass: one block per (BM queries, b·head), as the forward's tiling,
// looping over the key tiles (64 keys) of the queries' causal range in
// order.  The producer loads Q and dO once, then a key tile's K and V per
// ring slot.  Shared queries (head_dim 128, 256): warpgroup 0 computes
// S = Q·Kᵀ and P, warpgroup 1 dP = dO·Vᵀ; they trade P and dP through
// shared memory, both form dS = P ∘ (dP − D), and warpgroup 0 accumulates
// dS_hi·K, warpgroup 1 dS_lo·K (dS's bf16 hi and lo parts), summed once at
// the end, in that order.  Solo (head_dim 64): warpgroup w computes S, dP,
// dS and dQ += dS_hi·K + dS_lo·K for its own 64 queries.  No atomics: two
// calls give the same bits.
template <int HD>
__device__ __forceinline__ void dq_block(const CUtensorMap* tq, const CUtensorMap* tdo,
                                         const CUtensorMap* tk, const CUtensorMap* tv,
                                         const Params& p, uint8_t* sm, int qt, int bh) {
  using L = DqSmem<HD>;
  constexpr int BM = L::BM, STAGES = L::STAGES;
  constexpr bool SOLO = Cfg<HD>::SOLO;
  bf16* Qs = reinterpret_cast<bf16*>(sm);
  bf16* dOs = reinterpret_cast<bf16*>(sm + L::TQ);
  auto Ks = [&](int st) { return reinterpret_cast<bf16*>(sm + L::K0 + 2 * st * L::TK); };
  auto Vs = [&](int st) { return reinterpret_cast<bf16*>(sm + L::K0 + (2 * st + 1) * L::TK); };
  float* X = reinterpret_cast<float*>(sm + L::X);  // P (32 × 128 f32), then dP
  uint64_t* q_bar = reinterpret_cast<uint64_t*>(sm + L::BAR);
  uint64_t* full = q_bar + 1;
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, wgi = tid / 128, wtid = tid % 128;
  const int warp = wtid / 32, lane = tid & 31;
  const int m0 = qt * BM;
  const int b = bh / p.H, h = bh % p.H, kvh = h / p.G;
  const Mask mk{p.key_pos, p.S, p.T, 1, p.causal, p.window, p.qpos};
  int kbeg, kend;
  causal_range(mk, m0, min(m0 + BM, p.S), kbeg, kend);
  const int nsteps = kend > kbeg ? (kend - kbeg + TILE - 1) / TILE : 0;

  if (tid == 0) {
    hop::mbar_init(q_bar, 1);
    for (int st = 0; st < STAGES; ++st) {
      hop::mbar_init(full + st, 1);
      hop::mbar_init(empty + st, 8);
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (wgi == 2) {
    hop::reg_dealloc<REG_PRODUCER>();
    if (wtid == 0 && nsteps > 0) {
      hop::mbar_expect_tx(q_bar, 2 * L::TQ);
      for (int w = 0; w < BM / TILE; ++w) {
        load_tile<HD>(Qs + w * TILE * HD, tq, q_bar, m0 + w * TILE, h, b);
        load_tile<HD>(dOs + w * TILE * HD, tdo, q_bar, m0 + w * TILE, h, b);
      }
      for (int i = 0; i < nsteps; ++i) {
        const int st = i % STAGES;
        hop::mbar_wait(empty + st, ((i / STAGES) & 1) ^ 1);
        const int t0 = kbeg + i * TILE;
        hop::mbar_expect_tx(full + st, 2 * L::TK);
        load_tile<HD>(Ks(st), tk, full + st, t0, kvh, b);
        load_tile<HD>(Vs(st), tv, full + st, t0, kvh, b);
      }
    }
    return;
  }

  hop::reg_alloc<REG_CONSUMER>();
  const int g8 = lane >> 2, t4 = lane & 3;
  const int mw = m0 + (SOLO ? wgi * TILE : 0);  // this warpgroup's queries [mw, mw + 64)
  const int row_lo = mw + warp * 16 + g8;      // this thread's queries: row_lo and row_lo + 8
  const bf16* Qw = Qs + (mw - m0) * HD;
  const bf16* dOw = dOs + (mw - m0) * HD;
  float lse_r[2], d_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // rows past S read the pitch's padding
    const int64_t at = (static_cast<int64_t>(b) * p.H + h) * p.SP + row_lo + 8 * r;
    lse_r[r] = p.lse2[at];
    d_r[r] = p.dlt[at];
  }
  float acc[HD / 2];  // dQ (solo), or dS_hi·K (warpgroup 0) or dS_lo·K (1): 64 queries × HD
#pragma unroll
  for (int e = 0; e < HD / 2; ++e) acc[e] = 0.f;
  if (nsteps > 0) hop::mbar_wait(q_bar, 0);
  for (int i = 0; i < nsteps; ++i) {
    const int st = i % STAGES;
    hop::mbar_wait(full + st, (i / STAGES) & 1);
    const int t0 = kbeg + i * TILE;
    const bool whole = mw + TILE <= p.S && t0 + TILE <= kend &&
                       (!p.causal || (!p.key_pos && t0 + TILE - 1 <= p.qpos + mw &&
                                      (p.window <= 0 || t0 > p.qpos + mw + TILE - 1 - p.window)));
    auto prob = [&](float sc, int j, int e) {
      const int key = t0 + 8 * j + 2 * t4 + (e & 1), r = e >> 1, qi = row_lo + 8 * r;
      const bool ok = whole || (qi < p.S && key < kend && (!p.causal || keep_key(mk, key, qi)));
      return ok ? ex2(fmaf(sc, p.scale2, -lse_r[r])) : 0.f;
    };
    if constexpr (SOLO) {
      float xs[TILE / 2], xd[TILE / 2];  // S and dP: 64 queries × 64 keys
      s_products<HD>(xs, Qw, Ks(st), xd, dOw, Vs(st));
#pragma unroll
      for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          xd[4 * j + e] = prob(xs[4 * j + e], j, e) * (xd[4 * j + e] - d_r[e >> 1]);
      acc_product2<HD>(acc, xd, Ks(st));
    } else {
      float x[TILE / 2];  // S (warpgroup 0) or dP (1)
      s_product<HD>(x, wgi == 0 ? Qw : dOw, wgi == 0 ? Ks(st) : Vs(st));
      if (wgi == 0) {
#pragma unroll
        for (int j = 0; j < TILE / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) x[4 * j + e] = prob(x[4 * j + e], j, e);
      }
      if (i > 0) hop::bar_sync(XE, 256);  // both have read the previous exchange
#pragma unroll
      for (int e = 0; e < TILE / 2; ++e) X[(wgi * TILE / 2 + e) * 128 + wtid] = x[e];
      hop::bar_sync(XF, 256);
      // dS = P ∘ (dP − D), the same bits in both warpgroups
#pragma unroll
      for (int e = 0; e < TILE / 2; ++e) {
        const float y = X[((1 - wgi) * TILE / 2 + e) * 128 + wtid];
        const float pr = wgi == 0 ? x[e] : y, dp = wgi == 0 ? y : x[e];
        x[e] = pr * (dp - d_r[(e >> 1) & 1]);
      }
      uint32_t a[TILE / 16][4];
      frags_part(a, x, wgi == 1);
      acc_product<HD>(acc, a, Ks(st));
    }
    __syncwarp();
    if (lane == 0) hop::mbar_arrive(empty + st);
  }

  if constexpr (!SOLO) {
    // dQ = (dS_hi·K + dS_lo·K)·scale: warpgroup 1 hands its half over
    // through the ring, which every load has left
    float* red = reinterpret_cast<float*>(sm + L::K0);
    if (wgi == 1) {
      hop::bar_sync(R1, 256);  // warpgroup 0's last product has read the ring
#pragma unroll
      for (int e = 0; e < HD / 2; ++e) red[e * 128 + wtid] = acc[e];
      hop::bar_arrive(R2, 256);
      return;
    }
    hop::bar_arrive(R1, 256);
    hop::bar_sync(R2, 256);
#pragma unroll
    for (int e = 0; e < HD / 2; ++e) acc[e] += red[e * 128 + wtid];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row_lo + 8 * r;
    if (qi >= p.S) continue;
    bf16* dst = p.dq + ((static_cast<int64_t>(b) * p.S + qi) * p.H + h) * HD + 2 * t4;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * r] * p.scale, acc[4 * j + 2 * r + 1] * p.scale);
  }
}

// The two passes in one launch (both read only D and the inputs): blocks
// [0, kv blocks) are dK/dV blocks (key tile fastest, the longest causal key
// tiles first, then b·kv head, then run), the rest dQ blocks (query tile
// fastest, the longest causal ranges first, then b·head), so that one
// pass's last wave runs beside the other's blocks
template <int HD>
__global__ void __launch_bounds__(NTH, 1)
    flash_bwd_wg(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
                 const Params p) {
  extern __shared__ uint8_t wg_smem[];
  uint8_t* sm = align1024(wg_smem);
  if (threadIdx.x == NTH - 128) {  // the producer's thread: its maps' descriptors, early
    hop::prefetch_map(&tq);
    hop::prefetch_map(&tdo);
    hop::prefetch_map(&tk);
    hop::prefetch_map(&tv);
  }
  constexpr int BM = Cfg<HD>::BM;
  const int nkt = (p.T + BM - 1) / BM, nbk = p.B * p.K;
  const int kv_blocks = nkt * nbk * p.kv_splits, l = blockIdx.x;
  if (l < kv_blocks) {
    dkv_block<HD>(&tq, &tdo, &tk, &tv, p, sm, l % nkt, l / nkt % nbk, l / (nkt * nbk));
    return;
  }
  const int nqt = (p.S + BM - 1) / BM, m = l - kv_blocks;
  dq_block<HD>(&tq, &tdo, &tk, &tv, p, sm, nqt - 1 - m % nqt, m / nqt);
}

// cuTensorMapEncodeTiled from the driver through the runtime's entry-point
// query (the library links no driver API)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
      f = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) !=
        cudaSuccess)
      f = nullptr;
#endif
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// the map of a (B, N, heads, hd) bf16 tensor with element strides (sb, sn,
// sh) and a contiguous last dim: 64 × 64 boxes, 128-byte swizzle, zeros
// past N
bool tensor_map(CUtensorMap* m, const void* base, int hd, int N, int heads, int B, int64_t sb,
                int64_t sn, int64_t sh) {
  const EncodeTiled enc = encoder();
  if (!enc) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(N),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sn) * 2, static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, TILE, 1, 1}, unit[4] = {1, 1, 1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
             unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

std::atomic<int> tmap_ns{0};  // the last call's tensor-map encoding, host ns

template <int HD>
cudaError_t launch_bwd(const Params& p, const bf16* q, const bf16* k, const bf16* v,
                       const bf16* dout, const int64_t (&st)[9], cudaStream_t stream) {
  constexpr int smem = KvSmem<HD>::SMEM > DqSmem<HD>::SMEM ? KvSmem<HD>::SMEM : DqSmem<HD>::SMEM;
  static svc::PerDevice<cudaError_t> attr_cards;
  const cudaError_t attr = svc::allow_smem(attr_cards, flash_bwd_wg<HD>, smem);
  if (attr != cudaSuccess) return attr;
  if (p.kv_splits < 1 || (p.kv_splits > 1 && p.part == nullptr)) return cudaErrorInvalidValue;
  const auto t0 = std::chrono::steady_clock::now();
  CUtensorMap tq, tdo, tk, tv;
  const bool ok =
      tensor_map(&tq, q, HD, p.S, p.H, p.B, st[0], st[1], st[2]) &&
      tensor_map(&tdo, dout, HD, p.S, p.H, p.B, static_cast<int64_t>(p.S) * p.H * HD,
                 static_cast<int64_t>(p.H) * HD, HD) &&
      tensor_map(&tk, k, HD, p.T, p.K, p.B, st[3], st[4], st[5]) &&
      tensor_map(&tv, v, HD, p.T, p.K, p.B, st[6], st[7], st[8]);
  tmap_ns.store(static_cast<int>(std::chrono::duration_cast<std::chrono::nanoseconds>(
                                     std::chrono::steady_clock::now() - t0)
                                     .count()));
  if (!ok) return cudaErrorInvalidValue;
  constexpr int BM = Cfg<HD>::BM;
  const int64_t blocks = static_cast<int64_t>((p.T + BM - 1) / BM) * p.B * p.K * p.kv_splits +
                         static_cast<int64_t>((p.S + BM - 1) / BM) * p.B * p.H;
  flash_bwd_wg<HD><<<static_cast<unsigned>(blocks), NTH, smem, stream>>>(tq, tdo, tk, tv, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.kv_splits == 1) return err;
  return launch_sum(p.part, p.dk, p.dv, static_cast<int64_t>(p.B) * p.T * p.K * HD, p.kv_splits,
                    p.scale, stream);
}

}  // namespace wg

// ---------------------------------------------------------------------------
// float32: the CUDA cores
// ---------------------------------------------------------------------------
namespace cc {

constexpr int NT = 128;  // threads per block
constexpr int NW = NT / 32;
constexpr int BK = 32;   // keys a tile (a block's keys in the dK/dV pass)
constexpr int R = 16;    // flat rows a tile (a block's rows in the dQ pass)
constexpr int PS = BK + 1;

struct BwdParams {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;
  const float* delta;
  float* dq;
  float* dk;
  float* dv;
  int64_t sqb, sqs, sqh, skb, skt, skh, svb, svt, svh;
  int B, S, T, H, K, G;
  int causal;
  int window;
  int qpos;
  float scale;
  const int* key_pos;
};

template <int HD>
struct Dims {
  static constexpr int HDP = (HD + 31) / 32 * 32;  // columns a lane multiple
  static constexpr int LS = HDP + 1;  // row stride: lanes reading 32 rows hit 32 banks
  static constexpr int DPT = HDP / 32;
  // Q, dO (R rows), K, V (BK rows); P, dS (R × PS); lse, D (R)
  static constexpr int SMEM = 4 * (2 * R * LS + 2 * BK * LS + 2 * R * PS + 2 * R);
};

// R flat rows from row0 of (b, kv head) into Qs (scaled) and dOs, their lse
// and D; rows at or past rlim read as 0
template <int HD>
__device__ __forceinline__ void load_rows(const BwdParams& p, int b, int kvh, int row0, int rlim,
                                          float* Qs, float* dOs, float* lse_s, float* d_s) {
  constexpr int LS = Dims<HD>::LS, HDP = Dims<HD>::HDP;
  for (int idx = threadIdx.x; idx < R * HDP; idx += NT) {
    const int r = idx / HDP, d = idx % HDP;
    const int flat = row0 + r;
    float qv = 0.f, dv = 0.f;
    if (flat < rlim && d < HD) {
      const int s = flat / p.G, h = kvh * p.G + flat % p.G;
      qv = p.q[static_cast<int64_t>(b) * p.sqb + static_cast<int64_t>(s) * p.sqs +
               static_cast<int64_t>(h) * p.sqh + d] * p.scale;
      dv = p.dout[((static_cast<int64_t>(b) * p.S + s) * p.H + h) * HD + d];
    }
    Qs[r * LS + d] = qv;
    dOs[r * LS + d] = dv;
  }
  for (int r = threadIdx.x; r < R; r += NT) {
    const int flat = row0 + r;
    const bool ok = flat < rlim;
    lse_s[r] = ok ? p.lse[lse_index(p, b, kvh, flat)] : 0.f;
    d_s[r] = ok ? p.delta[lse_index(p, b, kvh, flat)] : 0.f;
  }
}

// BK keys from k0 of (b, kv head) into Ks and Vs; keys at or past klim read as 0
template <int HD>
__device__ __forceinline__ void load_keys(const BwdParams& p, int b, int kvh, int k0, int klim,
                                          float* Ks, float* Vs) {
  constexpr int LS = Dims<HD>::LS, HDP = Dims<HD>::HDP;
  const float* kp = p.k + static_cast<int64_t>(b) * p.skb + static_cast<int64_t>(kvh) * p.skh;
  const float* vp = p.v + static_cast<int64_t>(b) * p.svb + static_cast<int64_t>(kvh) * p.svh;
  for (int idx = threadIdx.x; idx < BK * HDP; idx += NT) {
    const int j = idx / HDP, d = idx % HDP;
    const int t = k0 + j;
    const bool ok = t < klim && d < HD;
    Ks[j * LS + d] = ok ? kp[static_cast<int64_t>(t) * p.skt + d] : 0.f;
    Vs[j * LS + d] = ok ? vp[static_cast<int64_t>(t) * p.svt + d] : 0.f;
  }
}

// P and dS of the (R rows from row0) × (BK keys from k0) tile into Ps and
// dSs, one (row, key) pair per thread and step: lane = key, warp + 4i = row
template <int HD>
__device__ __forceinline__ void tile_p_ds(const BwdParams& p, int row0, int rlim, int k0,
                                          int klim, const float* Qs, const float* dOs,
                                          const float* Ks, const float* Vs, const float* lse_s,
                                          const float* d_s, float* Ps, float* dSs) {
  constexpr int LS = Dims<HD>::LS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int key = k0 + lane;
#pragma unroll
  for (int i = 0; i < R / NW; ++i) {
    const int r = warp + NW * i, flat = row0 + r;
    float s = 0.f, dp = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      s = fmaf(Qs[r * LS + d], Ks[lane * LS + d], s);
      dp = fmaf(dOs[r * LS + d], Vs[lane * LS + d], dp);
    }
    const bool ok = flat < rlim && key < klim && (!p.causal || keep_key(p, key, flat / p.G));
    const float pr = ok ? expf(s - lse_s[r]) : 0.f;
    if (Ps) Ps[r * PS + lane] = pr;
    dSs[r * PS + lane] = pr * (dp - d_s[r]);
  }
}

template <int HD>
__global__ void __launch_bounds__(NT) flash_bwd_dq_cc(BwdParams p) {
  constexpr int LS = Dims<HD>::LS, DPT = Dims<HD>::DPT, RPW = R / NW;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + R * LS;
  float* Ks = dOs + R * LS;
  float* Vs = Ks + BK * LS;
  float* dSs = Vs + BK * LS;
  float* lse_s = dSs + R * PS;
  float* d_s = lse_s + R;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rows = p.S * p.G;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * R;
  const int bk = blockIdx.y, b = bk / p.K, kvh = bk % p.K;
  load_rows<HD>(p, b, kvh, row0, rows, Qs, dOs, lse_s, d_s);
  int kbeg, kend;
  causal_range(p, row0, min(row0 + R, rows), kbeg, kend);

  float acc[RPW][DPT];
#pragma unroll
  for (int i = 0; i < RPW; ++i)
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
  for (int t0 = kbeg; t0 < kend; t0 += BK) {
    __syncthreads();  // the previous tile is consumed (and the rows are written)
    load_keys<HD>(p, b, kvh, t0, kend, Ks, Vs);
    __syncthreads();
    tile_p_ds<HD>(p, row0, rows, t0, kend, Qs, dOs, Ks, Vs, lse_s, d_s, nullptr, dSs);
    __syncthreads();
    // dQ += dS·K: lane owns dims lane + 32c of the warp's rows
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float ds = dSs[(warp + NW * i) * PS + j];
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[i][c] = fmaf(ds, Ks[j * LS + lane + 32 * c], acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int flat = row0 + warp + NW * i;
    if (flat >= rows) continue;
    const int s = flat / p.G, h = kvh * p.G + flat % p.G;
    float* dst = p.dq + ((static_cast<int64_t>(b) * p.S + s) * p.H + h) * HD;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int d = lane + 32 * c;
      if (d < HD) dst[d] = acc[i][c] * p.scale;
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_cc(BwdParams p) {
  constexpr int LS = Dims<HD>::LS, DPT = Dims<HD>::DPT, KPW = BK / NW;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + R * LS;
  float* Ks = dOs + R * LS;
  float* Vs = Ks + BK * LS;
  float* Ps = Vs + BK * LS;
  float* dSs = Ps + R * PS;
  float* lse_s = dSs + R * PS;
  float* d_s = lse_s + R;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k0 = blockIdx.x * BK, k1 = min(k0 + BK, p.T);
  const int bk = blockIdx.y, b = bk / p.K, kvh = bk % p.K;
  load_keys<HD>(p, b, kvh, k0, k1, Ks, Vs);
  int r0, r1;
  causal_rows(p, k0, k1, r0, r1);

  float dk[KPW][DPT], dv[KPW][DPT];
#pragma unroll
  for (int i = 0; i < KPW; ++i)
#pragma unroll
    for (int c = 0; c < DPT; ++c) dk[i][c] = dv[i][c] = 0.f;
  for (int rb = r0; rb < r1; rb += R) {
    __syncthreads();  // the previous rows are consumed (and the keys are written)
    load_rows<HD>(p, b, kvh, rb, r1, Qs, dOs, lse_s, d_s);
    __syncthreads();
    tile_p_ds<HD>(p, rb, r1, k0, k1, Qs, dOs, Ks, Vs, lse_s, d_s, Ps, dSs);
    __syncthreads();
    // dV += Pᵀ·dO and dK += dSᵀ·(Q·scale): lane owns dims lane + 32c of the
    // warp's keys
#pragma unroll 4
    for (int r = 0; r < R; ++r) {
      float dov[DPT], qv[DPT];
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        dov[c] = dOs[r * LS + lane + 32 * c];
        qv[c] = Qs[r * LS + lane + 32 * c];
      }
#pragma unroll
      for (int i = 0; i < KPW; ++i) {
        const float pr = Ps[r * PS + warp + NW * i], ds = dSs[r * PS + warp + NW * i];
#pragma unroll
        for (int c = 0; c < DPT; ++c) {
          dv[i][c] = fmaf(pr, dov[c], dv[i][c]);
          dk[i][c] = fmaf(ds, qv[c], dk[i][c]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < KPW; ++i) {
    const int t = k0 + warp + NW * i;
    if (t >= k1) continue;
    const int64_t off = ((static_cast<int64_t>(b) * p.T + t) * p.K + kvh) * HD;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int d = lane + 32 * c;
      if (d < HD) {
        p.dk[off + d] = dk[i][c];
        p.dv[off + d] = dv[i][c];
      }
    }
  }
}

template <int HD>
cudaError_t launch_bwd(const BwdParams& p, cudaStream_t stream) {
  constexpr int dq_smem = Dims<HD>::SMEM - 4 * R * PS;  // no P tile
  constexpr int kv_smem = Dims<HD>::SMEM;
  static svc::PerDevice<cudaError_t> attr_kv_cards;
  const cudaError_t attr_kv = svc::allow_smem(attr_kv_cards, flash_bwd_dkv_cc<HD>, kv_smem);
  static svc::PerDevice<cudaError_t> attr_q_cards;
  const cudaError_t attr_q = svc::allow_smem(attr_q_cards, flash_bwd_dq_cc<HD>, dq_smem);
  if (attr_kv != cudaSuccess) return attr_kv;
  if (attr_q != cudaSuccess) return attr_q;
  const dim3 kv_grid((p.T + BK - 1) / BK, p.B * p.K);
  flash_bwd_dkv_cc<HD><<<kv_grid, NT, kv_smem, stream>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 q_grid((p.S * p.G + R - 1) / R, p.B * p.K);
  flash_bwd_dq_cc<HD><<<q_grid, NT, dq_smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace cc

namespace {

// whether bf16 at head_dim HD takes the warpgroup route (ops.WG_HEAD_DIMS)
template <int HD>
constexpr bool warpgroups() {
  return HD == 64 || HD == 128 || HD == 256;
}

// the plan the host passed against the source's tiles: (dQ rows, dQ keys,
// dK/dV keys, dK/dV rows, dK/dV columns)
template <int HD>
bool same_plan(int dtype, const int (&got)[5]) {
  if constexpr (warpgroups<HD>()) {
    if (dtype == 1)
      return got[0] == wg::Cfg<HD>::BM && got[1] == wg::TILE && got[2] == wg::Cfg<HD>::BM &&
             got[3] == wg::TILE && got[4] == HD;
  } else if (dtype == 1) {
    using T = tc::Tiles<HD>;
    return got[0] == tc::DqCfg<HD, T::DQ_KEYS>::BM && got[1] == T::DQ_KEYS &&
           got[2] == tc::DkvCfg<HD, T::KV_ROWS>::BN && got[3] == T::KV_ROWS &&
           got[4] == T::KV_COLS;
  }
  return got[0] == cc::R && got[1] == cc::BK && got[2] == cc::BK && got[3] == cc::R &&
         got[4] == HD;
}

template <int HD>
cudaError_t launch_hd(int dtype, const void* q, const void* k, const void* v, const void* o,
                      const void* dout, const float* lse, float* delta, void* dq, void* dk,
                      void* dv, const int64_t (&st)[9], const int (&dims)[6], int causal,
                      int window, int qpos, float scale, const int* key_pos,
                      const int (&tiles)[5], int kv_splits, float* part, cudaStream_t stream) {
  if (!same_plan<HD>(dtype, tiles)) return cudaErrorInvalidValue;
  const int B = dims[0], S = dims[1], H = dims[3], G = dims[3] / dims[4];
  using bf16 = __nv_bfloat16;
  if constexpr (warpgroups<HD>()) {
    if (dtype == 1) {  // delta: D, then lse · log2 e, each (B, H, SP)
      const int SP = wg::pitch(S);
      float* lse2 = delta + static_cast<int64_t>(B) * H * SP;
      const cudaError_t err = launch_prep(static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
                                          lse, delta, lse2, B, S, H, HD, SP, stream);
      if (err != cudaSuccess) return err;
      const wg::Params p{static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                         lse2, delta, part, key_pos, B, S, dims[2], H, dims[4], G, SP, causal,
                         window, qpos, scale, scale * LOG2E, kv_splits};
      return wg::launch_bwd<HD>(p, static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                static_cast<const bf16*>(v), static_cast<const bf16*>(dout), st,
                                stream);
    }
  } else if (dtype == 1) {
    const cudaError_t err = launch_prep(static_cast<const bf16*>(o),
                                        static_cast<const bf16*>(dout), lse, delta, nullptr, B,
                                        S, H, HD, S, stream);
    if (err != cudaSuccess) return err;
    const tc::BwdParams p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                          static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
                          static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                          st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
                          dims[0], dims[1], dims[2], dims[3], dims[4], G, causal, window, qpos,
                          scale, key_pos, kv_splits, part};
    return tc::launch_bwd<HD>(p, stream);
  }
  if (kv_splits != 1) return cudaErrorInvalidValue;  // the CUDA-core route does not split
  const cudaError_t err = launch_prep(static_cast<const float*>(o),
                                      static_cast<const float*>(dout), lse, delta, nullptr, B, S,
                                      H, HD, S, stream);
  if (err != cudaSuccess) return err;
  const cc::BwdParams p{static_cast<const float*>(q), static_cast<const float*>(k),
                        static_cast<const float*>(v), static_cast<const float*>(dout), lse, delta,
                        static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv),
                        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
                        dims[0], dims[1], dims[2], dims[3], dims[4], G, causal, window, qpos,
                        scale, key_pos};
  return cc::launch_bwd<HD>(p, stream);
}

}  // namespace

// dq (B, S, H, hd), dk and dv (B, T, K, hd), all contiguous and of q's dtype
// (0 float32, the CUDA cores; 1 bfloat16, the tensor cores), from q, k, v
// (any strides with the last dim contiguous, 16-byte aligned rows), o and
// dout (contiguous (B, S, H, hd)) and the forward's lse (B, H, S) float32;
// delta is the caller's (B, H, S) float32 scratch for D.  The mask
// arguments are the forward's.  tiles: (dQ rows, dQ keys, dK/dV keys,
// dK/dV rows, dK/dV columns) as ops.bwd_plan computes them; a plan that is
// not the source's is refused.  kv_splits (bfloat16 only; 1 for float32):
// the runs each dK/dV key tile's rows are cut into, with part the caller's
// (kv_splits, 2, B, T, K, hd) float32 scratch when it is above 1.  delta:
// the caller's float32 scratch, (B, H, S) for D, or on the warpgroup route
// (bf16 at head_dim 64, 128, 256) two (B, H, wg::pitch(S)) arrays, D and
// lse · log2 e.  Launches: D, the dK/dV and dQ passes (one launch on the
// warpgroup route, else two), and the partials' sum with a split.
extern "C" int svc_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv, int64_t sqb, int64_t sqs,
    int64_t sqh, int64_t skb, int64_t skt, int64_t skh, int64_t svb, int64_t svt, int64_t svh,
    int B, int S, int T, int H, int K, int hd, int causal, int window, int qpos, float scale,
    int dtype, const int* key_pos, int dq_rows, int dq_keys, int kv_keys, int kv_rows,
    int kv_cols, int kv_splits, float* part, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((dtype != 0 && dtype != 1) || K <= 0 || H % K != 0) return cudaErrorInvalidValue;
  cudaError_t err;
  const int64_t strides[9] = {sqb, sqs, sqh, skb, skt, skh, svb, svt, svh};
  const int dims[6] = {B, S, T, H, K, hd};
  const int tiles[5] = {dq_rows, dq_keys, kv_keys, kv_rows, kv_cols};
#define SVC_BWD_HD(N)                                                                         \
  case N:                                                                                     \
    err = launch_hd<N>(dtype, q, k, v, o, dout, lse, delta, dq, dk, dv, strides, dims,       \
                       causal, window, qpos, scale, key_pos, tiles, kv_splits, part, st);    \
    break;
  switch (hd) {
    SVC_BWD_HD(16)
    SVC_BWD_HD(32)
    SVC_BWD_HD(64)
    SVC_BWD_HD(96)
    SVC_BWD_HD(128)
    SVC_BWD_HD(256)
    default:
      err = cudaErrorInvalidValue;
  }
#undef SVC_BWD_HD
  return static_cast<int>(err);
}

// host nanoseconds the last warpgroup-route call spent encoding its four
// tensor maps (0 before any)
extern "C" int svc_flash_bwd_tmap_ns() { return wg::tmap_ns.load(); }
