// AdamW over every trainable leaf: clip by the global norm, the cosine
// schedule, bias correction, decoupled decay on matrices, in two launches a
// step whatever the number of leaves (up to kMaxLeaves; more split into
// groups, two launches a group).
//
//   svc_adamw_sumsq  — Σg² over every leaf, then, in the last block, the
//     step's scalars: step + 1 (int32), lr, grad_norm, clip_scale, bc1, bc2.
//   svc_adamw_update — per element, from g, p, m, v and those scalars:
//       g ← g·clip_scale
//       m ← b1·m + (1 − b1)·g
//       v ← b2·v + (1 − b2)·g·g
//       δ ← (m / bc1) / (sqrt(v / bc2) + eps)  [+ wd·p where the leaf decays]
//       p ← p − lr·δ
//
// Replaces no Pallas kernel: JAX's src/repro/training/optim.py:53
// adamw_update (with global_norm at :48) is plain jnp, which XLA fuses into
// one pass a leaf.  The plain PyTorch version (kernels/adamw/ref.py) makes
// ~13 elementwise passes a leaf and a torch._foreach_norm.
//
// Bound: device memory.  Each element's g is read once by the norm
// (4 bytes) and p, g, m, v read and p, m, v written once by the update
// (28 bytes); ~20 float32 operations an element.
//
// Design:
//   * The leaves' pointers and sizes travel in the kernel's parameter block
//     (32,764 bytes from CUDA 12.1 on, read through the constant cache), so
//     a step needs no host-to-device copy of a table: the gradients are new
//     tensors every step, and the table changes with them.
//   * Every leaf is cut into chunks of kChunk elements.  A persistent grid
//     (as many blocks as the card holds at once) strides over the chunks; a
//     block finds its chunk's leaf by a binary search over the cumulative
//     chunk counts.  Where a leaf's p, g, m and v are all 16-byte aligned
//     (chunks start at multiples of 4 elements, so every chunk of the leaf
//     is), lanes take consecutive 16-byte words, several words of each
//     stream in flight before any arithmetic; the last n mod 4 elements of
//     a leaf, and every element of a misaligned leaf, go one at a time.
//   * The norm sums g² in float64 in a fixed order (each thread's elements,
//     warp shuffles, warps in index order) into one partial a block, in a
//     persistent workspace; the last block of the last launch (a
//     __threadfence, then a ticket, which it resets to 0) sums every
//     partial in index order.  The grid depends only on the leaves and the
//     card, so two calls give the same bits.
//   * The scalars are computed on the device from the step counter the
//     caller holds there (int32), as the plain version computes them: no
//     host read, no launch of its own.  The update reads them from device
//     memory; it takes the plain version's scalars as well as the norm's.
//   * Float32 arithmetic in the plain version's order, each rounding pinned
//     by an intrinsic: the products and sums round where torch's in-place
//     ops round, the two multiply-adds of torch's `add_(…, alpha=)` are
//     fused as torch's are, division is IEEE (__fdiv_rn) and the square
//     root correctly rounded (__fsqrt_rn).  The build has no fast math.
#include <algorithm>
#include <climits>

#include "svc_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kChunk = 32768;  // elements of one leaf a block takes at a time (4 | kChunk)
constexpr int kNormWords = 4;      // 16-byte words of g in flight a thread (the norm)
constexpr int kUpdateWords = 2;    // 16-byte words of each of p, g, m, v (the update)

// Kernel parameter space: 32,764 bytes from CUDA 12.1 on (Volta and later).
// kMaxLeaves leaves fit one launch of either kernel; a call over more
// (qwen2-vl-72b has 723) launches each kernel once a group of kMaxLeaves.
static_assert(CUDART_VERSION >= 12010, "the leaves' table needs CUDA 12.1's 32 KB parameters");
constexpr int kParamBytes = 32764;
constexpr int kMaxLeaves = 704;

// The schedule's and the clip's constants, each rounded to float32 by the
// caller as torch rounds a Python scalar against a float32 tensor.
struct Schedule {
  float lr;         // cfg.lr
  float warmup;     // cfg.warmup_steps
  float warmup1;    // max(cfg.warmup_steps, 1)
  float span1;      // max(cfg.total_steps - cfg.warmup_steps, 1)
  float min_ratio;  // cfg.min_lr_ratio
  float half_span;  // (1 - cfg.min_lr_ratio) * 0.5, taken in double
  float b1;
  float b2;
  float clip;       // cfg.clip_norm
};

struct NormParams {
  const float* g[kMaxLeaves];
  int64_t n[kMaxLeaves];
  int32_t chunk_end[kMaxLeaves];  // chunks of leaves 0..l
  int32_t leaves;
  int32_t chunks;
  int32_t base;   // partial slots the call's earlier launches filled
  int32_t last;   // 1: the call's last launch, whose last block finishes
  double* partials;
  int* ticket;    // 0 between calls
  const int32_t* step_in;
  int32_t* step_out;
  float* scalars;  // lr, grad_norm, clip_scale, bc1, bc2
  Schedule s;
};
static_assert(sizeof(NormParams) <= kParamBytes, "the norm's table outgrows the parameter space");

struct UpdateParams {
  float* p[kMaxLeaves];
  const float* g[kMaxLeaves];
  float* m[kMaxLeaves];
  float* v[kMaxLeaves];
  int64_t n[kMaxLeaves];
  int32_t chunk_end[kMaxLeaves];
  uint32_t decay[(kMaxLeaves + 31) / 32];  // bit l: leaf l takes the decay
  int32_t leaves;
  int32_t chunks;
  const float* lr;
  const float* scale;
  const float* bc1;
  const float* bc2;
  float b1, omb1, b2, omb2, eps, wd;  // omb1 = 1 − b1 and omb2 = 1 − b2, taken in double
};
static_assert(sizeof(UpdateParams) <= kParamBytes,
              "the update's table outgrows the parameter space");

struct Span {
  int leaf;
  int64_t begin;  // first element of the chunk in its leaf
  int len;        // elements of the chunk
};

// chunk c's leaf (the first with chunk_end > c) and range
template <typename Params>
__device__ __forceinline__ Span span_of(const Params& P, int c) {
  int lo = 0, hi = P.leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (P.chunk_end[mid] > c) hi = mid;
    else lo = mid + 1;
  }
  const int first = lo > 0 ? P.chunk_end[lo - 1] : 0;
  const int64_t begin = static_cast<int64_t>(c - first) * kChunk;
  const int64_t rest = P.n[lo] - begin;
  return {lo, begin, static_cast<int>(rest < kChunk ? rest : kChunk)};
}

__device__ __forceinline__ double sq(float x) {
  const double d = static_cast<double>(x);
  return d * d;
}

__device__ __forceinline__ double warp_sum(double x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

// the block's sum in a fixed order, on thread 0
__device__ __forceinline__ double block_sum(double x, double (&red)[kWarps]) {
  x = warp_sum(x);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  double s = 0.0;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarps; ++w) s += red[w];
  }
  return s;
}

// The plain version's scalars (kernels/adamw/ref.py adamw_norm_ref) from the
// step counter and Σg², on one thread.
__device__ void write_scalars(const NormParams& P, double sumsq) {
  const Schedule& h = P.s;
  const int32_t step = *P.step_in + 1;
  *P.step_out = step;
  const float s = static_cast<float>(step);
  // cosine_schedule: where(s < warmup, s / warmup1, min_ratio + half_span·(1 + cos(π·prog)))
  const float warm = __fdiv_rn(s, h.warmup1);
  const float prog = fminf(fmaxf(__fdiv_rn(__fsub_rn(s, h.warmup), h.span1), 0.0f), 1.0f);
  const float c = cosf(__fmul_rn(3.14159265358979323846f, prog));
  const float cosv = __fadd_rn(h.min_ratio, __fmul_rn(h.half_span, __fadd_rn(1.0f, c)));
  const float lr = __fmul_rn(h.lr, s < h.warmup ? warm : cosv);
  const float gnorm = __double2float_rn(sqrt(sumsq));
  // clamp(clip / clamp(gnorm, min=1e-9), max=1); torch's scalar / tensor is
  // reciprocal, then product; a NaN norm stays NaN through both clamps
  const float floor_ = gnorm < 1e-9f ? 1e-9f : gnorm;
  float scale = __fmul_rn(__frcp_rn(floor_), h.clip);
  scale = scale > 1.0f ? 1.0f : scale;
  P.scalars[0] = lr;
  P.scalars[1] = gnorm;
  P.scalars[2] = scale;
  P.scalars[3] = __fsub_rn(1.0f, powf(h.b1, s));
  P.scalars[4] = __fsub_rn(1.0f, powf(h.b2, s));
}

__global__ void __launch_bounds__(kThreads)
    adamw_sumsq_kernel(const __grid_constant__ NormParams P) {
  __shared__ double red[kWarps];
  __shared__ bool last_block;
  double acc = 0.0;
  for (int c = blockIdx.x; c < P.chunks; c += gridDim.x) {
    const Span sp = span_of(P, c);
    const float* g = P.g[sp.leaf] + sp.begin;
    int done = 0;
    if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
      const float4* g4 = reinterpret_cast<const float4*>(g);
      const int words = sp.len >> 2;
      for (int base = threadIdx.x; base < words; base += kThreads * kNormWords) {
        float4 x[kNormWords];
#pragma unroll
        for (int u = 0; u < kNormWords; ++u) {
          const int w = base + u * kThreads;
          x[u] = w < words ? __ldg(g4 + w) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
#pragma unroll
        for (int u = 0; u < kNormWords; ++u) {
          acc += sq(x[u].x);
          acc += sq(x[u].y);
          acc += sq(x[u].z);
          acc += sq(x[u].w);
        }
      }
      done = words << 2;
    }
    for (int i = done + threadIdx.x; i < sp.len; i += kThreads) acc += sq(__ldg(g + i));
  }

  const double total = block_sum(acc, red);
  if (threadIdx.x == 0) {
    P.partials[P.base + blockIdx.x] = total;
    if (P.last) {
      __threadfence();
      last_block = atomicAdd(P.ticket, 1) == static_cast<int>(gridDim.x) - 1;
    }
  }
  if (!P.last) return;
  __syncthreads();
  if (!last_block) return;
  __threadfence();

  // the last block: every partial of the call, thread t taking slots t, t + 256, …
  const int slots = P.base + static_cast<int>(gridDim.x);
  acc = 0.0;
  for (int i = threadIdx.x; i < slots; i += kThreads) acc += __ldcg(P.partials + i);
  const double sumsq = block_sum(acc, red);
  if (threadIdx.x == 0) {
    write_scalars(P, sumsq);
    *P.ticket = 0;
  }
}

struct Consts {
  float b1, omb1, b2, omb2, eps, wd, lr, scale, bc1, bc2;
};

// one element, in the plain version's order of operations and roundings
__device__ __forceinline__ void step_elem(float& p, float g, float& m, float& v, bool decay,
                                          const Consts& k) {
  g = __fmul_rn(g, k.scale);                                  // grads · scale
  m = __fmaf_rn(k.omb1, g, __fmul_rn(m, k.b1));               // m.mul_(b1).add_(g, alpha=1−b1)
  v = __fmaf_rn(__fmul_rn(k.omb2, g), g, __fmul_rn(v, k.b2));  // v.mul_(b2).addcmul_(g, g, 1−b2)
  const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, k.bc2)), k.eps);
  float d = __fdiv_rn(__fdiv_rn(m, k.bc1), denom);            // (m / bc1).div_(…)
  if (decay) d = __fmaf_rn(k.wd, p, d);                      // delta.add_(p, alpha=wd)
  p = __fsub_rn(p, __fmul_rn(d, k.lr));                       // p.sub_(delta.mul_(lr))
}

__device__ __forceinline__ void step4(float4& p, const float4& g, float4& m, float4& v, bool decay,
                                      const Consts& k) {
  step_elem(p.x, g.x, m.x, v.x, decay, k);
  step_elem(p.y, g.y, m.y, v.y, decay, k);
  step_elem(p.z, g.z, m.z, v.z, decay, k);
  step_elem(p.w, g.w, m.w, v.w, decay, k);
}

__global__ void __launch_bounds__(kThreads)
    adamw_update_kernel(const __grid_constant__ UpdateParams P) {
  const Consts k{P.b1, P.omb1, P.b2, P.omb2, P.eps, P.wd,
                 __ldg(P.lr), __ldg(P.scale), __ldg(P.bc1), __ldg(P.bc2)};
  for (int c = blockIdx.x; c < P.chunks; c += gridDim.x) {
    const Span sp = span_of(P, c);
    float* p = P.p[sp.leaf] + sp.begin;
    const float* g = P.g[sp.leaf] + sp.begin;
    float* m = P.m[sp.leaf] + sp.begin;
    float* v = P.v[sp.leaf] + sp.begin;
    const bool decay = (P.decay[sp.leaf >> 5] >> (sp.leaf & 31)) & 1u;
    const uintptr_t any = reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
                          reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(v);
    int done = 0;
    if ((any & 15) == 0) {
      float4* p4 = reinterpret_cast<float4*>(p);
      const float4* g4 = reinterpret_cast<const float4*>(g);
      float4* m4 = reinterpret_cast<float4*>(m);
      float4* v4 = reinterpret_cast<float4*>(v);
      const int words = sp.len >> 2;
      for (int base = threadIdx.x; base < words; base += kThreads * kUpdateWords) {
        float4 pp[kUpdateWords], gg[kUpdateWords], mm[kUpdateWords], vv[kUpdateWords];
#pragma unroll
        for (int u = 0; u < kUpdateWords; ++u) {
          const int w = base + u * kThreads;
          if (w < words) {
            pp[u] = p4[w];
            gg[u] = __ldg(g4 + w);
            mm[u] = m4[w];
            vv[u] = v4[w];
          }
        }
#pragma unroll
        for (int u = 0; u < kUpdateWords; ++u) {
          const int w = base + u * kThreads;
          if (w < words) {
            step4(pp[u], gg[u], mm[u], vv[u], decay, k);
            p4[w] = pp[u];
            m4[w] = mm[u];
            v4[w] = vv[u];
          }
        }
      }
      done = words << 2;
    }
    for (int i = done + threadIdx.x; i < sp.len; i += kThreads) {
      float pe = p[i], me = m[i], ve = v[i];
      step_elem(pe, __ldg(g + i), me, ve, decay, k);
      p[i] = pe;
      m[i] = me;
      v[i] = ve;
    }
  }
}

// blocks of ``kernel`` the current card holds at once
template <typename K>
int resident(svc::PerDevice<int>& cards, K kernel) {
  return cards.get([&](int dev) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    return sms * (per_sm < 1 ? 1 : per_sm);
  });
}

// chunk_end over leaves [first, first + count) of a table with ``stride``
// int64 columns, numel in column ``ncol``; the group's chunks, or −1 when
// a size is negative or the chunks outgrow int32
template <typename Params>
int64_t fill_chunks(Params& P, const int64_t* table, int stride, int ncol, int first, int count) {
  int64_t chunks = 0;
  for (int i = 0; i < count; ++i) {
    const int64_t n = table[static_cast<int64_t>(first + i) * stride + ncol];
    if (n < 0) return -1;
    P.n[i] = n;
    chunks += (n + kChunk - 1) / kChunk;
    if (chunks > INT_MAX) return -1;
    P.chunk_end[i] = static_cast<int32_t>(chunks);
  }
  P.leaves = count;
  P.chunks = static_cast<int32_t>(chunks);
  return chunks;
}

int grid_of(int64_t chunks, int cap) {
  int64_t grid = chunks < cap ? chunks : cap;
  return static_cast<int>(grid < 1 ? 1 : grid);
}

}  // namespace

// Leaves one launch of either kernel takes; ⌈leaves / this⌉ launches of each
// a call.
extern "C" int svc_adamw_max_leaves() { return kMaxLeaves; }

// table: (leaves, 2) int64 in host memory, each row (g's address, numel).
// partials: at least ⌈leaves / kMaxLeaves⌉ · max_blocks doubles and
// ticket: one int, from the wrapper's persistent workspace (the ticket
// zeroed once).  step_in: the caller's int32 step; step_out: int32, gets
// step_in + 1; scalars: 5 floats, get lr, grad_norm, clip_scale, bc1, bc2.
extern "C" int svc_adamw_sumsq(const int64_t* table, int leaves, double* partials, int* ticket,
                               int max_blocks, const int32_t* step_in, int32_t* step_out,
                               float* scalars, float lr, float warmup, float warmup1, float span1,
                               float min_ratio, float half_span, float b1, float b2, float clip,
                               void* stream) {
  if (leaves < 1 || max_blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  static svc::PerDevice<int> cards;
  const int cap = std::min(resident(cards, adamw_sumsq_kernel), max_blocks);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  NormParams P{};
  P.partials = partials;
  P.ticket = ticket;
  P.step_in = step_in;
  P.step_out = step_out;
  P.scalars = scalars;
  P.s = Schedule{lr, warmup, warmup1, span1, min_ratio, half_span, b1, b2, clip};
  int base = 0;
  for (int first = 0; first < leaves; first += kMaxLeaves) {
    const int count = std::min(kMaxLeaves, leaves - first);
    for (int i = 0; i < count; ++i) {
      P.g[i] = reinterpret_cast<const float*>(table[static_cast<int64_t>(first + i) * 2]);
    }
    const int64_t chunks = fill_chunks(P, table, 2, 1, first, count);
    if (chunks < 0) return static_cast<int>(cudaErrorInvalidValue);
    P.base = base;
    P.last = first + count >= leaves ? 1 : 0;
    const int grid = grid_of(chunks, cap);
    adamw_sumsq_kernel<<<grid, kThreads, 0, s>>>(P);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    base += grid;
  }
  return 0;
}

// table: (leaves, 6) int64 in host memory, each row (p, g, m, v addresses,
// numel, decay 0/1).  lr, scale, bc1, bc2: float32 scalars on the card
// (svc_adamw_sumsq's, or the plain version's).
extern "C" int svc_adamw_update(const int64_t* table, int leaves, const float* lr,
                                const float* scale, const float* bc1, const float* bc2, float b1,
                                float omb1, float b2, float omb2, float eps, float wd,
                                void* stream) {
  if (leaves < 1) return static_cast<int>(cudaErrorInvalidValue);
  static svc::PerDevice<int> cards;
  const int cap = resident(cards, adamw_update_kernel);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  UpdateParams P{};
  P.lr = lr;
  P.scale = scale;
  P.bc1 = bc1;
  P.bc2 = bc2;
  P.b1 = b1;
  P.omb1 = omb1;
  P.b2 = b2;
  P.omb2 = omb2;
  P.eps = eps;
  P.wd = wd;
  for (int first = 0; first < leaves; first += kMaxLeaves) {
    const int count = std::min(kMaxLeaves, leaves - first);
    for (int w = 0; w < (kMaxLeaves + 31) / 32; ++w) P.decay[w] = 0u;
    for (int i = 0; i < count; ++i) {
      const int64_t* row = table + static_cast<int64_t>(first + i) * 6;
      P.p[i] = reinterpret_cast<float*>(row[0]);
      P.g[i] = reinterpret_cast<const float*>(row[1]);
      P.m[i] = reinterpret_cast<float*>(row[2]);
      P.v[i] = reinterpret_cast<float*>(row[3]);
      if (row[5] != 0) P.decay[i >> 5] |= 1u << (i & 31);
    }
    const int64_t chunks = fill_chunks(P, table, 6, 4, first, count);
    if (chunks < 0) return static_cast<int>(cudaErrorInvalidValue);
    adamw_update_kernel<<<grid_of(chunks, cap), kThreads, 0, s>>>(P);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
