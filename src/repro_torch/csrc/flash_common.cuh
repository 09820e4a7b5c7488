// Device helpers shared by the flash attention forward (flash_attention.cu)
// and its backward (flash_attention_bwd.cu): the causal mask and its
// refinements, a block's causal key and query ranges, and the tensor-core
// primitives (cp.async, ldmatrix, mma.sync m16n8k16 bf16 → f32, the hi + lo
// split of an f32 operand).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "svc_common.cuh"

// Whether key ``key`` is kept for the query at index ``qi`` (from 0) under
// the causal mask and its refinements: key j is kept for query i iff
// 0 <= p_j <= qpos + i and, when window > 0, p_j > qpos + i - window, where
// p_j is key_pos[j] (a slot's position, -1 for an empty slot) or j.
template <typename P>
__device__ __forceinline__ bool keep_key(const P& p, int key, int qi) {
  const int kp = p.key_pos ? __ldg(p.key_pos + key) : key;
  const int qp = p.qpos + qi;
  return kp >= 0 && kp <= qp && (p.window <= 0 || kp > qp - p.window);
}

// A block's causal key range [lo, hi) for its flat rows [row0, row_end):
// everything when key_pos is given (slots are masked one by one), else cut
// at the last query's position and, under a window, below the first's.
template <typename P>
__device__ __forceinline__ void causal_range(const P& p, int row0, int row_end, int& lo,
                                             int& hi) {
  lo = 0;
  hi = p.T;
  if (!p.causal || p.key_pos) return;
  hi = min(hi, p.qpos + (row_end - 1) / p.G + 1);
  if (p.window > 0) lo = max(0, p.qpos + row0 / p.G - p.window + 1);
}

// The flat rows [r0, r1) that can keep a key of [k0, k1): every row when
// key_pos is given or the mask is not causal; else from the first query at
// or past k0 and, under a window, up to the last query whose band still
// reaches k1 - 1 (the transpose of causal_range).
template <typename P>
__device__ __forceinline__ void causal_rows(const P& p, int k0, int k1, int& r0, int& r1) {
  const int rows = p.S * p.G;
  r0 = 0;
  r1 = rows;
  if (!p.causal || p.key_pos) return;
  r0 = min(p.S, max(0, k0 - p.qpos)) * p.G;
  if (p.window > 0) r1 = max(r0, min(p.S, max(0, k1 - 1 + p.window - p.qpos)) * p.G);
}

// A flat row's index in a (B, H, S) per-row array (lse, delta): (b, query
// head, query) of row ``flat`` = s·G + g of (b, kv head kvh).
template <typename P>
__device__ __forceinline__ int64_t lse_index(const P& p, int b, int kvh, int flat) {
  return (static_cast<int64_t>(b) * p.H + kvh * p.G + flat % p.G) * p.S + flat / p.G;
}

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int NT = 128;  // threads per block: four warps
constexpr int NW = NT / 32;
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_MAX = 232448;  // bytes of shared memory a block may use

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared, zero-filled when !ok (src is then not read)
__device__ __forceinline__ void load16(bf16* dst, const bf16* src, bool ok, int vec) {
  if (vec) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  } else {
#pragma unroll
    for (int u = 0; u < 8; ++u) dst[u] = ok ? src[u] : __float2bfloat16_rn(0.f);
  }
}

// 4 bytes (one f32) global → shared, zero-filled when !ok
__device__ __forceinline__ void load4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c (16×8 f32) += a (16×16 bf16, row) · b (16×8 bf16, col)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x0, x1) → bf16 pairs hi and lo with hi + lo = x to about 2^-16 relative:
// P·V as hi·V + lo·V keeps the probabilities' f32 precision (V is exact)
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

}  // namespace tc
