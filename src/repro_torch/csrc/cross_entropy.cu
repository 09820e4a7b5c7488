// The float32 cross-entropy over the vocabulary, forward and backward, one
// launch each, for bf16 or float32 logits (N, V) and int32 or int64 labels.
//
//   svc_cross_entropy_fwd — per row r:
//       lse[r] = log Σ_j exp(x[r, j])             (torch.logsumexp's value)
//       nll[r] = lse[r] − x[r, label]              (NaN where the label is
//                                                   out of range)
//   svc_cross_entropy_bwd — per row r and column j, from lse and the two
//     incoming per-row gradients g_lse and g_nll:
//       dx[r, j] = (g_lse[r] + g_nll[r])·exp(x[r, j] − lse[r]) − g_nll[r]·[j = label]
//     in float32, rounded once to the logits' dtype.
//
// Labels follow JAX's take_along_axis (default fill mode): a label in
// [−V, 0) wraps to label + V; one at or past V or below −V reads no logit,
// so its nll is NaN and its row takes no gold term in the backward.
//
// Replaces no Pallas kernel: JAX's src/repro/training/train_step.py:46-53
// cross_entropy (astype(f32), jax.nn.logsumexp, take_along_axis) and its
// VJP are plain jnp, which XLA fuses into a few passes over the logits.
// The plain PyTorch version (kernels/cross_entropy/ref.py) makes a float32
// copy of the logits and a full float32 pass for each of amax, x − max,
// exp and the sum, and as many for the backward's product, scatter, sum
// and cast.
//
// Bound: device memory.  The forward reads each logit once (N·V·e bytes);
// the backward reads each once and writes its gradient once (2·N·V·e).
// About four float32 operations an element (an expf among them) take far
// less than the bytes at the card's float32 rate.
//
// Design:
//   * One block of kThreads a row; the grid is the N rows.  Element
//     offsets are 64-bit: N·V passes 2^31 at 8,192 rows of 256k.
//   * Lanes take consecutive 16-byte words of the row (8 bf16 or 4 float32
//     values), kUnroll words in flight a thread.  A row starts at a
//     16-byte boundary only when V·e is a multiple of 16 (seamless's
//     V = 256,206 in bf16 starts rows 4 bytes apart), so the first
//     elements up to the boundary and the last that fill no word go one
//     at a time (the backward also needs its output row on the same
//     boundary, else the whole row goes one element at a time).
//   * Forward: each thread keeps a running (max, Σ exp(x − max)) pair,
//     updated once a word (the word's max first, one rescale, then the
//     word's exps); the pairs merge by warp shuffles and then warp by warp
//     in index order on thread 0, so a repeat gives the same bits.  A NaN
//     anywhere makes the max NaN and lse NaN; an infinite max gives that
//     infinity, as torch.logsumexp does (a row of −inf has lse −inf).
//   * Backward: one pass writing every element; the label's element takes
//     its gold term in the thread that writes its word.  No atomics, no
//     float32 temporary the size of the logits.
//   * expf is the correctly compiled one (the build has no fast math): the
//     backward's exp(x − lse) matches the plain version's element by
//     element.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // 16-byte words of the row in flight a thread

template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static constexpr int kPer = 4;  // values a 16-byte word
  __device__ static float load(const float* p) { return *p; }
  __device__ static void store(float* p, float v) { *p = v; }
  __device__ static void unpack(const uint4& w, float (&v)[kPer]) {
    v[0] = __uint_as_float(w.x);
    v[1] = __uint_as_float(w.y);
    v[2] = __uint_as_float(w.z);
    v[3] = __uint_as_float(w.w);
  }
  __device__ static uint4 pack(const float (&v)[kPer]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kPer = 8;
  __device__ static float load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
  __device__ static void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
  // a 32-bit lane holds two values, the lower address in the low half
  __device__ static void split(uint32_t u, float& lo, float& hi) {
    lo = __uint_as_float(u << 16);
    hi = __uint_as_float(u & 0xffff0000u);
  }
  __device__ static uint32_t join(float lo, float hi) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
  }
  __device__ static void unpack(const uint4& w, float (&v)[kPer]) {
    split(w.x, v[0], v[1]);
    split(w.y, v[2], v[3]);
    split(w.z, v[4], v[5]);
    split(w.w, v[6], v[7]);
  }
  __device__ static uint4 pack(const float (&v)[kPer]) {
    return make_uint4(join(v[0], v[1]), join(v[2], v[3]), join(v[4], v[5]), join(v[6], v[7]));
  }
};

// max that keeps a NaN of either side
__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a) return a;
  return (b > a || b != b) ? b : a;
}

struct MaxSum {
  float m;  // the largest value seen (NaN once a NaN was seen)
  float s;  // Σ exp(x − m) over the values seen; 0 while m is infinite
};

// (a, b) → their union; symmetric, so a shuffle tree's order is fixed by
// its lanes alone
__device__ __forceinline__ MaxSum merge(MaxSum a, MaxSum b) {
  const float m = nan_max(a.m, b.m);
  if (isinf(m)) return {m, 0.0f};
  return {m, a.s * expf(a.m - m) + b.s * expf(b.m - m)};
}

// the pair after n more values v[0..n)
template <int n>
__device__ __forceinline__ MaxSum add(MaxSum acc, const float (&v)[n]) {
  float wm = v[0];
#pragma unroll
  for (int k = 1; k < n; ++k) wm = nan_max(wm, v[k]);
  const float m = nan_max(acc.m, wm);
  if (isinf(m)) return {m, 0.0f};
  float s = acc.s * expf(acc.m - m);  // acc.m = −inf: 0 · 0
#pragma unroll
  for (int k = 0; k < n; ++k) s += expf(v[k] - m);
  return {m, s};
}

__device__ __forceinline__ MaxSum add1(MaxSum acc, float x) {
  const float v[1] = {x};
  return add<1>(acc, v);
}

// the row's wrapped label, or −1 when it reads no logit
template <typename L>
__device__ __forceinline__ int64_t wrapped_label(const L* labels, int64_t row, int V) {
  int64_t lab = static_cast<int64_t>(labels[row]);
  if (lab < 0) lab += V;
  return (lab >= 0 && lab < V) ? lab : -1;
}

// elements before the row's first 16-byte boundary (at most V)
template <typename T>
__device__ __forceinline__ int head_of(const T* row, int V) {
  const int bytes = static_cast<int>((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15);
  const int h = bytes / static_cast<int>(sizeof(T));
  return h < V ? h : V;
}

template <typename T, typename L>
__global__ void __launch_bounds__(kThreads)
    cross_entropy_fwd_kernel(const T* __restrict__ x, const L* __restrict__ labels,
                             float* __restrict__ lse_out, float* __restrict__ nll_out, int V) {
  using E = Elem<T>;
  constexpr int K = E::kPer;
  const int64_t row = blockIdx.x;
  const T* r = x + row * static_cast<int64_t>(V);
  const int head = head_of(r, V);
  const int words = (V - head) / K;
  const int tail = head + words * K;
  MaxSum acc{-INFINITY, 0.0f};
  for (int j = threadIdx.x; j < head; j += kThreads) acc = add1(acc, E::load(r + j));
  const uint4* w = reinterpret_cast<const uint4*>(r + head);
  int i = threadIdx.x;
  for (; i + (kUnroll - 1) * kThreads < words; i += kUnroll * kThreads) {
    uint4 q[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) q[u] = __ldcs(w + i + u * kThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float v[K];
      E::unpack(q[u], v);
      acc = add<K>(acc, v);
    }
  }
  for (; i < words; i += kThreads) {
    float v[K];
    E::unpack(__ldcs(w + i), v);
    acc = add<K>(acc, v);
  }
  for (int j = tail + threadIdx.x; j < V; j += kThreads) acc = add1(acc, E::load(r + j));

  for (int off = 16; off > 0; off >>= 1) {
    const MaxSum o{__shfl_down_sync(0xffffffffu, acc.m, off),
                   __shfl_down_sync(0xffffffffu, acc.s, off)};
    acc = merge(acc, o);
  }
  __shared__ float red_m[kWarps], red_s[kWarps];
  if ((threadIdx.x & 31) == 0) {
    red_m[threadIdx.x >> 5] = acc.m;
    red_s[threadIdx.x >> 5] = acc.s;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  MaxSum t{red_m[0], red_s[0]};
  for (int k = 1; k < kWarps; ++k) t = merge(t, MaxSum{red_m[k], red_s[k]});
  // torch.logsumexp: log(Σ exp(x − max)) + max, an infinite max taken as is
  const float lse = isinf(t.m) ? t.m : logf(t.s) + t.m;
  const int64_t lab = wrapped_label(labels, row, V);
  const float gold = lab >= 0 ? E::load(r + lab) : NAN;
  lse_out[row] = lse;
  nll_out[row] = lse - gold;
}

template <typename T, typename L>
__global__ void __launch_bounds__(kThreads)
    cross_entropy_bwd_kernel(const T* __restrict__ x, const L* __restrict__ labels,
                             const float* __restrict__ lse, const float* __restrict__ g_lse,
                             const float* __restrict__ g_nll, T* __restrict__ dx, int V) {
  using E = Elem<T>;
  constexpr int K = E::kPer;
  const int64_t row = blockIdx.x;
  const int64_t at = row * static_cast<int64_t>(V);
  const T* r = x + at;
  T* o = dx + at;
  const float l = lse[row];
  const float gn = g_nll[row];
  const float c = g_lse[row] + gn;
  const int64_t lab = wrapped_label(labels, row, V);
  // the output row must share the input row's place in its 16-byte word
  const bool paired =
      ((reinterpret_cast<uintptr_t>(r) ^ reinterpret_cast<uintptr_t>(o)) & 15) == 0;
  const int head = paired ? head_of(r, V) : V;
  const int words = (V - head) / K;
  const int tail = head + words * K;
  auto grad = [&](float v, int64_t j) {
    const float d = c * expf(v - l);
    return j == lab ? d - gn : d;
  };
  for (int j = threadIdx.x; j < head; j += kThreads) E::store(o + j, grad(E::load(r + j), j));
  const uint4* w = reinterpret_cast<const uint4*>(r + head);
  uint4* wo = reinterpret_cast<uint4*>(o + head);
  // the word (if any) that holds the label, and the label's place in it
  const int64_t lab_word = lab >= head && lab < tail ? (lab - head) / K : -1;
  const int lab_k = static_cast<int>(lab - head - lab_word * K);
  auto word = [&](const uint4& q, int idx) {
    float v[K];
    E::unpack(q, v);
    const int hit = idx == lab_word ? lab_k : -1;  // v stays in registers: no dynamic index
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float d = c * expf(v[k] - l);
      v[k] = k == hit ? d - gn : d;
    }
    __stcs(wo + idx, E::pack(v));
  };
  int i = threadIdx.x;
  for (; i + (kUnroll - 1) * kThreads < words; i += kUnroll * kThreads) {
    uint4 q[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) q[u] = __ldcs(w + i + u * kThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) word(q[u], i + u * kThreads);
  }
  for (; i < words; i += kThreads) word(__ldcs(w + i), i);
  for (int j = tail + threadIdx.x; j < V; j += kThreads) E::store(o + j, grad(E::load(r + j), j));
}

bool bad_shape(long long N, int V) { return N < 1 || N > 0x7fffffffLL || V < 1; }

template <typename T, typename L>
cudaError_t fwd(const void* x, const void* labels, float* lse, float* nll, long long N, int V,
                cudaStream_t s) {
  cross_entropy_fwd_kernel<T, L><<<static_cast<unsigned>(N), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const L*>(labels), lse, nll, V);
  return cudaGetLastError();
}

template <typename T, typename L>
cudaError_t bwd(const void* x, const void* labels, const float* lse, const float* g_lse,
                const float* g_nll, void* dx, long long N, int V, cudaStream_t s) {
  cross_entropy_bwd_kernel<T, L><<<static_cast<unsigned>(N), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const L*>(labels), lse, g_lse, g_nll,
      static_cast<T*>(dx), V);
  return cudaGetLastError();
}

}  // namespace

// x (N, V): dtype 0 float32, 1 bfloat16; labels (N,): label_bytes 4
// (int32) or 8 (int64); lse, nll (N,) float32.  All contiguous, on the
// current card.  One launch on ``stream``.
extern "C" int svc_cross_entropy_fwd(const void* x, int dtype, const void* labels,
                                     int label_bytes, float* lse, float* nll, long long N, int V,
                                     void* stream) {
  if (bad_shape(N, V)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && label_bytes == 4) err = fwd<float, int32_t>(x, labels, lse, nll, N, V, s);
  if (dtype == 0 && label_bytes == 8) err = fwd<float, int64_t>(x, labels, lse, nll, N, V, s);
  if (dtype == 1 && label_bytes == 4) {
    err = fwd<__nv_bfloat16, int32_t>(x, labels, lse, nll, N, V, s);
  }
  if (dtype == 1 && label_bytes == 8) {
    err = fwd<__nv_bfloat16, int64_t>(x, labels, lse, nll, N, V, s);
  }
  return static_cast<int>(err);
}

// x, dx (N, V) of one dtype (0 float32, 1 bfloat16); labels (N,) as in the
// forward; lse (the forward's), g_lse, g_nll (N,) float32.  All contiguous,
// on the current card.  One launch on ``stream``.
extern "C" int svc_cross_entropy_bwd(const void* x, int dtype, const void* labels,
                                     int label_bytes, const float* lse, const float* g_lse,
                                     const float* g_nll, void* dx, long long N, int V,
                                     void* stream) {
  if (bad_shape(N, V)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0 && label_bytes == 4) {
    err = bwd<float, int32_t>(x, labels, lse, g_lse, g_nll, dx, N, V, s);
  }
  if (dtype == 0 && label_bytes == 8) {
    err = bwd<float, int64_t>(x, labels, lse, g_lse, g_nll, dx, N, V, s);
  }
  if (dtype == 1 && label_bytes == 4) {
    err = bwd<__nv_bfloat16, int32_t>(x, labels, lse, g_lse, g_nll, dx, N, V, s);
  }
  if (dtype == 1 && label_bytes == 8) {
    err = bwd<__nv_bfloat16, int64_t>(x, labels, lse, g_lse, g_nll, dx, N, V, s);
  }
  return static_cast<int>(err);
}
