// Flash attention: online-softmax attention with f32 scores, GQA/MQA-aware.
//
// Replaces repro/kernels/flash_attention/kernel.py:flash_tiles
// (_flash_kernel) and the K/V repeat of its ops.py wrapper.  It computes
// what _flash_kernel computes: q scaled by 1/sqrt(hd) in f32, scores,
// running max m, normaliser l and accumulator acc in f32, masked scores at
// -1e30 (not -inf), the same recurrence (m' = max(m, rowmax s),
// p = exp(s - m'), l' = l·exp(m - m') + Σp, acc' = acc·exp(m - m') + p·V),
// and out = acc / max(l, 1e-30) in q's type.  Two masks: causal (key j kept
// when j <= i, i the query's index from 0) and non-causal (keys beyond T
// masked).  Decode runs the non-causal mode on a slice of the KV cache.
//
// Layout: q (B, S, H, hd), k/v (B, T, K, hd), any strides with the last
// dim contiguous (the decode input is a non-contiguous cache slice), 64-bit
// offsets; out (B, S, H, hd) contiguous.  Query head h reads KV head
// h / (H/K): the G = H/K query heads that share a KV head are rows of one
// tile, so K/V are never repeated.
//
// Grid: (row tiles, B·K, key splits).  A row tile is R consecutive
// (query, group head) pairs of one (b, kv head), g fastest; R is 8 when a
// (b, kv head) has at most 8 such rows (decode) and 32 otherwise (prefill).
// Each block walks its key range in tiles of 32 keys staged in shared
// memory as f32: warp w owns rows w, w+4, …; in the score step lane j takes
// key j, the row max and sum are warp shuffles, and in the P·V step lane j
// owns dims j, j+32, … of the same rows, so a row's (m, l, acc) never leaves
// its warp.  When B·K·row tiles cannot fill the card (decode: 8 blocks at
// the serve path's B = 8, K = 1), the keys are split over gridDim.z and a
// second kernel combines the (m, l, acc) partials (flash-decoding).
//
// Bound: at decode, the K/V bytes of the cache slice (each read once per
// block, since one block holds every query head of its KV head); for a long
// causal prefill, the f32 FMA rate: scores and P·V run on the CUDA cores,
// not the tensor cores (the simple first version).  head_dim 256 makes a
// 32-row f32 accumulator 32 KB: it lives in registers spread over the four
// warps (64 a thread), not in one warp.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NT = 128;  // threads per block
constexpr int NW = NT / 32;
constexpr int BK = 32;  // keys per tile, one per lane
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t sqb, sqs, sqh, skb, skt, skh, svb, svt, svh;  // element strides
  int B, S, T, H, K, G;
  int causal;
  float scale;
  int chunk;   // keys per split, a multiple of BK
  int nsplit;  // > 1: write partials for the combine kernel
  int vec;     // every row start 16-byte aligned: vector loads
  float* part_ml;
  float* part_acc;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

template <typename T>
struct Elt;

template <>
struct Elt<float> {
  static constexpr int N = 4;  // elements per 16-byte load
  __device__ static float get(const float* p) { return *p; }
  __device__ static void load(const float* p, float* d) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    d[0] = x.x; d[1] = x.y; d[2] = x.z; d[3] = x.w;
  }
  __device__ static void put(float* p, float x) { *p = x; }
};

template <>
struct Elt<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static float get(const __nv_bfloat16* p) { return __bfloat162float(*p); }
  __device__ static void load(const __nv_bfloat16* p, float* d) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      d[2 * i] = f.x;
      d[2 * i + 1] = f.y;
    }
  }
  __device__ static void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
};

// N consecutive elements at p into d (f32).
template <typename T>
__device__ __forceinline__ void load_n(const T* p, float* d, int vec) {
  if (vec) {
    Elt<T>::load(p, d);
  } else {
#pragma unroll
    for (int u = 0; u < Elt<T>::N; ++u) d[u] = Elt<T>::get(p + u);
  }
}

template <int HD>
struct Dims {
  static constexpr int HDP = (HD + 31) / 32 * 32;  // padded to a lane multiple
  static constexpr int KS = HDP + 4;  // K row stride: float4 reads without bank conflicts
  static constexpr int DPT = HDP / 32;  // dims per lane in the P·V step
};

template <int HD, int R>
constexpr size_t smem_bytes() {
  return sizeof(float) * (R * Dims<HD>::HDP + BK * Dims<HD>::KS + BK * Dims<HD>::HDP);
}

template <typename T, int HD, int R>
__global__ void __launch_bounds__(NT) flash_fwd(Params p) {
  constexpr int HDP = Dims<HD>::HDP, KS = Dims<HD>::KS, DPT = Dims<HD>::DPT;
  constexpr int VN = Elt<T>::N;
  constexpr int RPW = R / NW;  // rows per warp
  static_assert(HD % VN == 0, "head_dim must be a multiple of the vector width");

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // R × HDP, pre-scaled
  float* Ks = Qs + R * HDP;                      // BK × KS
  float* Vs = Ks + BK * KS;                      // BK × HDP

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows = p.S * p.G;
  const int row0 = blockIdx.x * R;
  const int b = blockIdx.y / p.K, kvh = blockIdx.y % p.K;
  const T* qp = static_cast<const T*>(p.q);
  const T* kp = static_cast<const T*>(p.k) + (int64_t)b * p.skb + (int64_t)kvh * p.skh;
  const T* vp = static_cast<const T*>(p.v) + (int64_t)b * p.svb + (int64_t)kvh * p.svh;

  // this block's keys: [k0, k1), cut at the tile's last query when causal
  int kend = p.T;
  if (p.causal) kend = min(kend, (min(row0 + R, rows) - 1) / p.G + 1);
  const int k0 = blockIdx.z * p.chunk;
  const int k1 = min(k0 + p.chunk, kend);

  for (int idx = tid; idx < R * (HDP / VN); idx += NT) {
    const int r = idx / (HDP / VN), c = (idx % (HDP / VN)) * VN;
    const int flat = row0 + r;
    float buf[VN];
    if (flat < rows && c < HD) {
      const int s = flat / p.G, h = kvh * p.G + flat % p.G;
      load_n(qp + (int64_t)b * p.sqb + (int64_t)s * p.sqs + (int64_t)h * p.sqh + c, buf, p.vec);
#pragma unroll
      for (int u = 0; u < VN; ++u) buf[u] *= p.scale;
    } else {
#pragma unroll
      for (int u = 0; u < VN; ++u) buf[u] = 0.f;
    }
#pragma unroll
    for (int u = 0; u < VN; ++u) Qs[r * HDP + c + u] = buf[u];
  }

  float m[RPW], l[RPW], acc[RPW][DPT];
  int qi[RPW];  // each owned row's query index (the causal test)
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0.f;
    qi[i] = (row0 + warp + NW * i) / p.G;
  }

  for (int t0 = k0; t0 < k1; t0 += BK) {
    __syncthreads();  // the previous tile is consumed (and Qs is written)
    for (int idx = tid; idx < BK * (HDP / VN); idx += NT) {
      const int j = idx / (HDP / VN), c = (idx % (HDP / VN)) * VN;
      const int t = t0 + j;
      float kb[VN], vb[VN];
      if (t < k1 && c < HD) {
        load_n(kp + (int64_t)t * p.skt + c, kb, p.vec);
        load_n(vp + (int64_t)t * p.svt + c, vb, p.vec);
      } else {
#pragma unroll
        for (int u = 0; u < VN; ++u) kb[u] = vb[u] = 0.f;
      }
#pragma unroll
      for (int u = 0; u < VN; ++u) {
        Ks[j * KS + c + u] = kb[u];
        Vs[j * HDP + c + u] = vb[u];
      }
    }
    __syncthreads();

    // scores of the warp's rows against key t0 + lane
    float s[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) s[i] = 0.f;
    const float4* kr = reinterpret_cast<const float4*>(Ks + lane * KS);
#pragma unroll 4
    for (int d4 = 0; d4 < HDP / 4; ++d4) {
      const float4 kv = kr[d4];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float4 qv = reinterpret_cast<const float4*>(Qs + (warp + NW * i) * HDP)[d4];
        s[i] = fmaf(qv.x, kv.x, s[i]);
        s[i] = fmaf(qv.y, kv.y, s[i]);
        s[i] = fmaf(qv.z, kv.z, s[i]);
        s[i] = fmaf(qv.w, kv.w, s[i]);
      }
    }
    const int t = t0 + lane;
    float pr[RPW];
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const bool ok = t < k1 && (!p.causal || t <= qi[i]);
      const float si = ok ? s[i] : NEG;
      const float mn = fmaxf(m[i], warp_max(si));
      pr[i] = expf(si - mn);
      const float alpha = expf(m[i] - mn);
      l[i] = l[i] * alpha + warp_sum(pr[i]);
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[i][c] *= alpha;
    }

    // acc += P·V: lane owns dims lane + 32c of the warp's rows
#pragma unroll 8
    for (int j = 0; j < BK; ++j) {
      float vv[DPT];
#pragma unroll
      for (int c = 0; c < DPT; ++c) vv[c] = Vs[j * HDP + lane + 32 * c];
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        const float pj = __shfl_sync(FULL, pr[i], j);
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[i][c] = fmaf(pj, vv[c], acc[i][c]);
      }
    }
  }

  T* op = static_cast<T*>(p.o);
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int flat = row0 + warp + NW * i;
    if (flat >= rows) continue;  // padded query rows are never written
    if (p.nsplit > 1) {
      const int64_t part = ((int64_t)blockIdx.z * gridDim.y + blockIdx.y) * rows + flat;
      if (lane == 0) {
        p.part_ml[2 * part] = m[i];
        p.part_ml[2 * part + 1] = l[i];
      }
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const int d = lane + 32 * c;
        if (d < HD) p.part_acc[part * HD + d] = acc[i][c];
      }
    } else {
      const int s = flat / p.G, h = kvh * p.G + flat % p.G;
      T* orow = op + (((int64_t)b * p.S + s) * p.H + h) * HD;
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
      for (int c = 0; c < DPT; ++c) {
        const int d = lane + 32 * c;
        if (d < HD) Elt<T>::put(orow + d, acc[i][c] * inv);
      }
    }
  }
}

// One block per output row (b, kv head, flat row): merge the key splits'
// (m, l, acc) partials, as the single pass would have carried them.
template <typename T>
__global__ void flash_combine(Params p, int hd) {
  const int rows = p.S * p.G;
  const int64_t r = blockIdx.x;  // (b·K + kvh)·rows + flat
  const int64_t nrow = (int64_t)gridDim.x;
  const int bk = static_cast<int>(r / rows), flat = static_cast<int>(r % rows);
  const int b = bk / p.K, kvh = bk % p.K;
  float mx = NEG;
  for (int z = 0; z < p.nsplit; ++z) mx = fmaxf(mx, p.part_ml[2 * (z * nrow + r)]);
  const int s = flat / p.G, h = kvh * p.G + flat % p.G;
  T* orow = static_cast<T*>(p.o) + (((int64_t)b * p.S + s) * p.H + h) * hd;
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float l = 0.f, a = 0.f;
    for (int z = 0; z < p.nsplit; ++z) {
      const int64_t part = z * nrow + r;
      const float w = expf(p.part_ml[2 * part] - mx);
      l = fmaf(p.part_ml[2 * part + 1], w, l);
      a = fmaf(p.part_acc[part * hd + d], w, a);
    }
    Elt<T>::put(orow + d, a / fmaxf(l, 1e-30f));
  }
}

template <typename T, int HD, int R>
cudaError_t launch_fwd(const Params& p, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<HD, R>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd<T, HD, R>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.S * p.G + R - 1) / R, p.B * p.K, p.nsplit);
  flash_fwd<T, HD, R><<<grid, NT, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_rows(const Params& p, int rows_per_tile, cudaStream_t stream) {
  return rows_per_tile == 8 ? launch_fwd<T, HD, 8>(p, stream) : launch_fwd<T, HD, 32>(p, stream);
}

template <typename T>
cudaError_t launch_all(const Params& p, int hd, int rows_per_tile, cudaStream_t stream) {
  cudaError_t err;
  switch (hd) {
    case 16: err = launch_rows<T, 16>(p, rows_per_tile, stream); break;
    case 32: err = launch_rows<T, 32>(p, rows_per_tile, stream); break;
    case 64: err = launch_rows<T, 64>(p, rows_per_tile, stream); break;
    case 96: err = launch_rows<T, 96>(p, rows_per_tile, stream); break;
    case 128: err = launch_rows<T, 128>(p, rows_per_tile, stream); break;
    case 256: err = launch_rows<T, 256>(p, rows_per_tile, stream); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || p.nsplit == 1) return err;
  const int64_t nrow = (int64_t)p.B * p.K * p.S * p.G;
  flash_combine<T><<<static_cast<unsigned>(nrow), 128, 0, stream>>>(p, hd);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, k, v and out share it).  rows_per_tile
// is 8 or 32; chunk keys per split (a multiple of 32); part_ml (nsplit,
// B·K, S·G, 2) and part_acc (nsplit, B·K, S·G, hd) f32 when nsplit > 1.
extern "C" int svc_flash_attention(const void* q, const void* k, const void* v, void* o,
                                   int64_t sqb, int64_t sqs, int64_t sqh, int64_t skb,
                                   int64_t skt, int64_t skh, int64_t svb, int64_t svt,
                                   int64_t svh, int B, int S, int T, int H, int K, int hd,
                                   int causal, float scale, int dtype, int rows_per_tile,
                                   int chunk, int nsplit, int vec, float* part_ml,
                                   float* part_acc, void* stream) {
  Params p{q, k, v, o, sqb, sqs, sqh, skb, skt, skh, svb, svt, svh, B, S, T, H, K, H / K,
           causal, scale, chunk, nsplit, vec, part_ml, part_acc};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((rows_per_tile != 8 && rows_per_tile != 32) || chunk % BK != 0 || nsplit < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0) return static_cast<int>(launch_all<float>(p, hd, rows_per_tile, st));
  if (dtype == 1) return static_cast<int>(launch_all<__nv_bfloat16>(p, hd, rows_per_tile, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
