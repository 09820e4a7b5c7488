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
// Three launches on the caller's stream (four with a row split, below),
// none with a float atomic, so two calls on the same inputs give the same
// bits:
//   1. flash_bwd_delta: D, one warp per query row, into the caller's
//      (B, H, S) f32 scratch.
//   2. the dK/dV pass: one block per (key tile, b·kv head, column slice).  It
//      keeps its keys' K and V rows in shared memory and loops over the
//      flat rows (query, group head) that can keep one of them (the causal
//      and window bounds cut the range; with key_pos none is cut), so the G
//      query heads that share a KV head are summed inside one block in a
//      fixed order.  At head_dim 256 a block owns 128 of the 256 output
//      columns (two blocks per key tile, each recomputing P and dS): the
//      accumulators of 16 keys × 256 columns for both dK and dV would not
//      fit a thread's registers, and the split doubles the blocks where
//      one KV head (gemma-2b, the hybrid) leaves the card half empty.  Where
//      the blocks still cannot fill the card (bf16, ops.bwd_plan), each key
//      tile's rows are also cut into kv_splits runs of whole steps, one
//      block each, writing f32 partials that flash_bwd_sum adds in run
//      order (the fourth launch) before rounding dK and dV once.
//   3. the dQ pass: one block per (row tile, b·kv head), as the forward's
//      tiling, looping over the key tiles of the tile's causal range.
// S and dO·Vᵀ are computed in both passes (seven products where an
// atomically summed dQ would need five): the price of determinism.
//
// bfloat16 (namespace tc): the tensor cores, mma.sync.m16n8k16 with f32
// accumulation, operands through ldmatrix from shared memory (rows padded
// by 16 bytes), tiles through 16-byte cp.async (two stages).  A product's
// f32 accumulator fragments are the A fragments of the next product (the
// forward's P·V trick), so P and dS never leave the registers.  As the A
// operands of dV, dK and dQ they are split into bf16 hi + lo and multiplied
// twice, as the forward's P·V: rounded once to bf16, their error would tie
// that of SDPA's backward (which rounds them so) instead of staying below
// it.  The split adds three products to the seven a pair takes in the two
// passes.  q, k, v and dO are exact in bf16.  dQ pass: 4 warps
// × 16 rows against 64 keys a step (32 at head_dim 96 and 128, 16 at 256,
// where the 16 × 256 f32 dQ accumulator already takes 128 registers).
// dK/dV pass: 4 warps × 16 keys, the transposed products (K·Qᵀ, V·dOᵀ) so
// that keys are the rows of every fragment, against 64 flat rows a step (32
// at 96 columns, 16 at 128).
//
// float32 (namespace cc): the CUDA cores, no TF32 (the f32 train checks
// hold the card to the CPU at 1e-5).  Each step stages a (16 rows × 32
// keys) tile's P and dS in shared memory (one thread per pair, f32 dot
// products over head_dim), then accumulates dQ (rows × dims per thread) or
// dK and dV (keys × dims per thread) from it.
//
// Bound: the gradient's bytes (q, k, v, o, dO read once, dq, dk, dv written
// once) or, at long sequences, its four products over the kept pairs at the
// bf16 tensor-core rate; the recompute of S and dO·Vᵀ in the second pass,
// the hi + lo products and the hd-256 column split add products the bound
// does not count.
#include "flash_common.cuh"

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// D = rowsum(dO ∘ o) of every (b, s, h) row of the contiguous (B, S, H, hd)
// o and dO, written at (b, h, s) of the (B, H, S) delta.  One warp a row.
template <typename T>
__global__ void flash_bwd_delta(const T* o, const T* dout, float* delta, int S, int H, int hd,
                                int64_t nrows) {
  const int64_t row = static_cast<int64_t>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= nrows) return;
  const T* orow = o + row * hd;
  const T* drow = dout + row * hd;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32) acc = fmaf(to_f32(orow[d]), to_f32(drow[d]), acc);
#pragma unroll
  for (int m = 16; m; m >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, m);
  if (lane == 0) {
    const int64_t b = row / (static_cast<int64_t>(S) * H);
    const int s = static_cast<int>((row / H) % S), h = static_cast<int>(row % H);
    delta[(b * H + h) * S + s] = acc;
  }
}

template <typename T>
cudaError_t launch_delta(const T* o, const T* dout, float* delta, int B, int S, int H, int hd,
                         cudaStream_t stream) {
  const int64_t nrows = static_cast<int64_t>(B) * S * H;
  constexpr int threads = 256;
  const int64_t blocks = (nrows + threads / 32 - 1) / (threads / 32);
  flash_bwd_delta<T><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(o, dout, delta, S, H,
                                                                             hd, nrows);
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

// dK/dV pass: 64 keys (4 warps × 16) of one (b, kv head) and HC of the HD
// output columns, against BMQ flat rows a step; K and V stay in shared
// memory, Q, dO, lse and D stream through two stages.  With kv_splits > 1
// the rows a key tile keeps are cut into kv_splits runs, one block each,
// whose f32 partials flash_bwd_sum adds in split order.
template <int HD, int HC, int BMQ>
struct DkvCfg {
  static constexpr int BN = 64;
  static constexpr int LD = HD + 8;
  static constexpr int STAGE = 2 * BMQ * LD * 2 + 2 * BMQ * 4;  // Q, dO; lse, D
  static constexpr int SMEM = 2 * BN * LD * 2 + 2 * STAGE;
  static_assert(HD % HC == 0 && HC % 16 == 0 && BMQ % 16 == 0, "tiles are whole mma steps");
  static_assert(SMEM <= SMEM_MAX, "shared memory");
};

template <int HD, int HC, int BMQ>
__global__ void __launch_bounds__(NT) flash_bwd_dkv_tc(BwdParams p) {
  using C = DkvCfg<HD, HC, BMQ>;
  constexpr int BN = C::BN, LD = C::LD;
  constexpr int NRT = BMQ / 8;  // n-tiles of a step's rows
  constexpr int NCT = HC / 8;   // n-tiles of the block's output columns
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
  const int z = blockIdx.z / (HD / HC);  // this block's run of the key tile's rows
  const int c0 = blockIdx.z % (HD / HC) * HC;
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

    // dV += Pᵀ·dO and dK += dSᵀ·Q over the block's columns, Pᵀ and dSᵀ as
    // bf16 hi + lo; dO and Q through ldmatrix.trans (rows are the k index)
#pragma unroll
    for (int ks = 0; ks < BMQ / 16; ++ks) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
      frag_a(ph, pl, st[2 * ks], st[2 * ks + 1]);
      frag_a(sh, sl, dpt[2 * ks], dpt[2 * ks + 1]);
#pragma unroll
      for (int dj = 0; dj < HC / 16; ++dj) {
        const int off = (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + c0 + dj * 16 +
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
    const int64_t off = ((static_cast<int64_t>(b) * p.T + key[r]) * p.K + kvh) * HD + c0;
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

// dk = scale·Σ_z part_dk[z], dv = Σ_z part_dv[z], z in order: two bf16 per thread
__global__ void flash_bwd_sum(BwdParams p, int64_t n) {
  const int64_t i = 2 * (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x);
  if (i >= n) return;
  float2 dk = make_float2(0.f, 0.f), dv = make_float2(0.f, 0.f);
  for (int z = 0; z < p.kv_splits; ++z) {
    const float2 a = *reinterpret_cast<const float2*>(p.part + 2 * z * n + i);
    const float2 c = *reinterpret_cast<const float2*>(p.part + (2 * z + 1) * n + i);
    dk.x += a.x;
    dk.y += a.y;
    dv.x += c.x;
    dv.y += c.y;
  }
  *reinterpret_cast<__nv_bfloat162*>(p.dk + i) =
      __floats2bfloat162_rn(dk.x * p.scale, dk.y * p.scale);
  *reinterpret_cast<__nv_bfloat162*>(p.dv + i) = __floats2bfloat162_rn(dv.x, dv.y);
}

// The tiles of each head_dim: (dQ keys a step; dK/dV columns a block, rows
// a step).  ops.bwd_plan mirrors this table, and the entry point refuses a
// plan that differs from it.
template <int HD>
struct Tiles {
  static constexpr int DQ_KEYS = HD <= 64 ? 64 : (HD <= 128 ? 32 : 16);
  static constexpr int KV_COLS = HD < 128 ? HD : 128;
  static constexpr int KV_ROWS = KV_COLS <= 64 ? 64 : (KV_COLS <= 96 ? 32 : 16);
};

template <int HD>
cudaError_t launch_bwd(const BwdParams& p, cudaStream_t stream) {
  using T = Tiles<HD>;
  using Q = DqCfg<HD, T::DQ_KEYS>;
  using V = DkvCfg<HD, T::KV_COLS, T::KV_ROWS>;
  static const cudaError_t attr_kv = cudaFuncSetAttribute(
      flash_bwd_dkv_tc<HD, T::KV_COLS, T::KV_ROWS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      V::SMEM);
  static const cudaError_t attr_q = cudaFuncSetAttribute(
      flash_bwd_dq_tc<HD, T::DQ_KEYS>, cudaFuncAttributeMaxDynamicSharedMemorySize, Q::SMEM);
  if (attr_kv != cudaSuccess) return attr_kv;
  if (attr_q != cudaSuccess) return attr_q;
  if (p.kv_splits < 1 || (p.kv_splits > 1 && p.part == nullptr)) return cudaErrorInvalidValue;
  const dim3 kv_grid((p.T + V::BN - 1) / V::BN, p.B * p.K, HD / T::KV_COLS * p.kv_splits);
  flash_bwd_dkv_tc<HD, T::KV_COLS, T::KV_ROWS><<<kv_grid, NT, V::SMEM, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (p.kv_splits > 1) {
    const int64_t n = static_cast<int64_t>(p.B) * p.T * p.K * HD;
    flash_bwd_sum<<<static_cast<unsigned>((n / 2 + 255) / 256), 256, 0, stream>>>(p, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 q_grid((p.S * p.G + Q::BM - 1) / Q::BM, p.B * p.K);
  flash_bwd_dq_tc<HD, T::DQ_KEYS><<<q_grid, NT, Q::SMEM, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace tc

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
  static const cudaError_t attr_kv = cudaFuncSetAttribute(
      flash_bwd_dkv_cc<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, kv_smem);
  static const cudaError_t attr_q = cudaFuncSetAttribute(
      flash_bwd_dq_cc<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem);
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

// the plan the host passed against the source's tiles: (dQ rows, dQ keys,
// dK/dV keys, dK/dV rows, dK/dV columns)
template <int HD>
bool same_plan(int dtype, const int (&got)[5]) {
  if (dtype == 1) {
    using T = tc::Tiles<HD>;
    return got[0] == tc::DqCfg<HD, T::DQ_KEYS>::BM && got[1] == T::DQ_KEYS &&
           got[2] == tc::DkvCfg<HD, T::KV_COLS, T::KV_ROWS>::BN && got[3] == T::KV_ROWS &&
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
  const int G = dims[3] / dims[4];
  if (dtype == 1) {
    using bf16 = __nv_bfloat16;
    const cudaError_t err = launch_delta(static_cast<const bf16*>(o),
                                         static_cast<const bf16*>(dout), delta, dims[0], dims[1],
                                         dims[3], HD, stream);
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
  const cudaError_t err = launch_delta(static_cast<const float*>(o),
                                       static_cast<const float*>(dout), delta, dims[0], dims[1],
                                       dims[3], HD, stream);
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
// (kv_splits, 2, B, T, K, hd) float32 scratch when it is above 1.  Three
// launches (D, dK/dV, dQ), four with a split (the partials' sum).
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
