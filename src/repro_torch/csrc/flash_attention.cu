// Flash attention: online-softmax attention with f32 scores, GQA/MQA-aware.
//
// Replaces repro/kernels/flash_attention/kernel.py:flash_tiles
// (_flash_kernel) and the K/V repeat of its ops.py wrapper.  It computes
// what _flash_kernel computes: f32 scores scaled by 1/sqrt(hd), running
// max m, normaliser l and accumulator acc in f32, masked scores at -1e30
// (not -inf), the same recurrence (m' = max(m, rowmax s), p = exp(s - m'),
// l' = l·exp(m - m') + Σp, acc' = acc·exp(m - m') + p·V), and out =
// acc / max(l, 1e-30) in q's type.  Two masks: causal (key j kept when
// j <= i, i the query's index from 0) and non-causal (keys beyond T
// masked).  Decode runs the non-causal mode on a slice of the KV cache.
//
// The causal mask takes three refinements, for local attention (JAX
// computes both of its masks outside its kernel: layers.local_mask and
// the ring-buffer decode mask of models/rglru.py): the queries' position
// offset qpos (query i sits at qpos + i), the keys' positions key_pos (an
// int32 (T,) array shared by the batch, -1 for an empty slot; null: key j
// sits at j) and a window.  Key j is kept for query i iff 0 <= p_j <=
// qpos + i and, when window > 0, p_j > qpos + i - window.  With key_pos
// null a block's keys are cut to [first query - window + 1, last query]
// and its key splits start at the lower end; with key_pos the block reads
// all T slots and masks each.  qpos 0, window 0 and key_pos null are the
// causal mode above, bit for bit.
//
// Layout: q (B, S, H, hd), k/v (B, T, K, hd), any strides with the last
// dim contiguous (the decode input is a non-contiguous cache slice), 64-bit
// offsets; out (B, S, H, hd) contiguous.  Query head h reads KV head
// h / (H/K): the G = H/K query heads that share a KV head are rows of one
// tile (a row is a (query, group head) pair, g fastest), so K/V are read
// once per KV head and never repeated.  Grid: (row tiles, B·K, key
// splits).  When B·K·row tiles cannot fill the card (decode: 8 blocks at
// the serve path's B = 8, K = 1) the keys are split over gridDim.z
// (flash-decoding) and the (m, l, acc) partials are merged.
//
// Two routes, chosen by the wrapper from the dtype:
//
// bfloat16 (namespace tc): the tensor cores.  Q·Kᵀ and P·V are
// mma.sync.m16n8k16 (bf16 in, f32 accumulate), FlashAttention-2 style: a
// warp owns 16 rows, its score fragments are the A fragments of P·V, and
// the row max and sum need two shuffles within a quad.  Q, K and V stay
// bf16 in shared memory, read by ldmatrix (.trans for V), rows padded by
// 16 bytes so an ldmatrix is free of bank conflicts.  K/V tiles stream
// through a ring of two or three stages of 16-byte cp.async.cg copies
// (commit_group/wait_group), so tile t+1 (and t+2) load while tile t is
// computed; unaligned inputs take scalar loads into the same ring.  Scores
// are scaled in f32 after the product (1/sqrt(hd) is no power of two for
// hd 32, 96, 128, so q·scale is never rounded to bf16); P is split into
// bf16 hi + lo and multiplied twice, so P·V keeps the f32 precision of the
// JAX kernel's product (V itself is exact in bf16).  Prefill: 4 warps × 16
// rows against 64-key tiles (32 at hd 256, where a thread already holds
// 128 f32 accumulators).  Decode (at most 16 rows per (b, kv head)): one
// 16-row tile, the 4 warps each take 16 keys of a 64-key tile and merge
// through shared memory at the end.  Key splits are merged in the same
// launch: each block writes its partials, and the last block of a row tile
// to arrive (a per-(b·kv, row tile) counter in the caller's workspace,
// reset to 0 by that block) combines them — one launch per call.
//
// float32 (namespace cuda_cores): scalar f32 FMAs on the CUDA cores, K/V
// tiles of 32 keys staged as f32, a second kernel
// (flash_combine_cuda_cores) for the key splits.  TF32 tensor cores would
// miss the f32 callers' 1e-4 tolerances.
//
// Log-sum-exp: when the caller passes lse (a (B, H, S) float32 array; the
// training forward does), the launch also writes m + log l of every query
// row, the softmax's log normaliser that the backward
// (flash_attention_bwd.cu) recomputes P from; with split keys the block
// (or the combine kernel) that merges the partials writes it.  The serve
// and decode calls pass null and write nothing more.
//
// Bound: at decode, the K/V bytes of the cache slice (each read once per
// block, since one block holds every query head of its KV head); for a long
// causal prefill, the bf16 tensor-core rate (P·V runs twice, hi and lo).
#include "flash_common.cuh"

// ---------------------------------------------------------------------------
// float32: scalar FMAs on the CUDA cores
// ---------------------------------------------------------------------------
namespace cuda_cores {

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
  int window;  // > 0: the causal mask is banded (keys within window positions)
  int qpos;    // the first query's position
  float scale;
  int chunk;   // keys per split, a multiple of BK
  int nsplit;  // > 1: write partials for the combine kernel
  int vec;     // every row start 16-byte aligned: vector loads
  const int* key_pos;  // (T,) slot positions, or null: key j at position j
  float* part_ml;
  float* part_acc;
  float* lse;  // (B, H, S) m + log l of every row, or null
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
__global__ void __launch_bounds__(NT) flash_fwd_cuda_cores(Params p) {
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

  // this block's keys: [k0, k1), cut to the tile's causal range
  int kbeg, kend;
  causal_range(p, row0, min(row0 + R, rows), kbeg, kend);
  const int k0 = kbeg + blockIdx.z * p.chunk;
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
      const bool ok = t < k1 && (!p.causal || keep_key(p, t, qi[i]));
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
      if (p.lse && lane == 0)
        p.lse[lse_index(p, b, kvh, flat)] = m[i] + logf(fmaxf(l[i], 1e-30f));
    }
  }
}

// One block per output row (b, kv head, flat row): merge the key splits'
// (m, l, acc) partials, as the single pass would have carried them.
template <typename T>
__global__ void flash_combine_cuda_cores(Params p, int hd) {
  const int rows = p.S * p.G;
  const int64_t r = blockIdx.x;  // (b·K + kvh)·rows + flat
  const int64_t nrow = (int64_t)gridDim.x;
  const int bk = static_cast<int>(r / rows), flat = static_cast<int>(r % rows);
  const int b = bk / p.K, kvh = bk % p.K;
  float mx = NEG;
  for (int z = 0; z < p.nsplit; ++z) mx = fmaxf(mx, p.part_ml[2 * (z * nrow + r)]);
  const int s = flat / p.G, h = kvh * p.G + flat % p.G;
  T* orow = static_cast<T*>(p.o) + (((int64_t)b * p.S + s) * p.H + h) * hd;
  if (p.lse && threadIdx.x == 0) {
    float l = 0.f;
    for (int z = 0; z < p.nsplit; ++z) {
      const int64_t part = z * nrow + r;
      l = fmaf(p.part_ml[2 * part + 1], expf(p.part_ml[2 * part] - mx), l);
    }
    p.lse[lse_index(p, b, kvh, flat)] = mx + logf(fmaxf(l, 1e-30f));
  }
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
  static svc::PerDevice<cudaError_t> attr_cards;
  const cudaError_t attr = svc::allow_smem(
      attr_cards, flash_fwd_cuda_cores<T, HD, R>, static_cast<int>(bytes));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.S * p.G + R - 1) / R, p.B * p.K, p.nsplit);
  flash_fwd_cuda_cores<T, HD, R><<<grid, NT, bytes, stream>>>(p);
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
  flash_combine_cuda_cores<T><<<static_cast<unsigned>(nrow), 128, 0, stream>>>(p, hd);
  return cudaGetLastError();
}

}  // namespace cuda_cores

// ---------------------------------------------------------------------------
// bfloat16: Q·Kᵀ and P·V on the tensor cores
// ---------------------------------------------------------------------------
namespace tc {

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  int64_t sqb, sqs, sqh, skb, skt, skh, svb, svt, svh;  // element strides
  int B, S, T, H, K, G;
  int causal;
  int window;  // > 0: the causal mask is banded (keys within window positions)
  int qpos;    // the first query's position
  float scale;
  int chunk;   // keys per split, a multiple of the block's key tile
  int nsplit;  // > 1: partials, merged by the last block of each row tile
  int vec;     // every row start 16-byte aligned: cp.async, else scalar loads
  const int* key_pos;  // (T,) slot positions, or null: key j at position j
  float* part_ml;
  float* part_acc;
  int* arrivals;  // (B·K, row tiles), zero between launches
  float* lse;     // (B, H, S) m + log l of every row, or null
};

// WM warps over rows (16 rows each) × WN warps over the keys of a tile (KW
// each).  Prefill: 4 × 1, 64 rows against 64 keys (32 at head_dim 256, so
// that a thread's 128 f32 accumulators, 16 scores and fragments fit its
// registers).  Decode (at most 16 rows): 1 × 4, each warp its own 16 keys
// of a 64-key tile, merged through shared memory at the end.
template <int HD, int WM, int KW>
struct Cfg {
  static constexpr int WN = NW / WM;
  static constexpr int BM = 16 * WM;  // rows per block
  static constexpr int BN = WN * KW;  // keys per tile
  // bf16 row stride in shared memory: rows 16 bytes apart mod 128, so the
  // eight row addresses of an ldmatrix hit eight distinct bank groups
  static constexpr int LD = HD + 8;
  static constexpr int STAGE = 2 * BN * LD * 2;  // K and V bytes of one stage
  static constexpr int QB = BM * LD * 2;
  // three stages where two blocks still fit an SM (or for decode, where
  // one block per SM streams the cache), else two
  static constexpr int STAGES = (WN > 1 || 3 * STAGE + QB <= 116 * 1024) ? 3 : 2;
  static constexpr int SMEM = STAGES * STAGE + QB;
  static_assert(HD % 16 == 0 && KW % 16 == 0, "tiles are whole mma steps");
  static_assert(SMEM <= SMEM_MAX, "shared memory");
  static_assert(WN == 1 || WN * 16 * (HD + 2) * 4 <= STAGES * STAGE, "merge scratch");
};

// out row of flat row ``flat`` of (b, kv head)
__device__ __forceinline__ bf16* out_row(const Params& p, int b, int kvh, int flat, int hd) {
  const int s = flat / p.G, h = kvh * p.G + flat % p.G;
  return p.o + ((static_cast<int64_t>(b) * p.S + s) * p.H + h) * hd;
}

template <int HD, int WM, int KW>
__global__ void __launch_bounds__(NT) flash_fwd_tc(Params p) {
  using C = Cfg<HD, WM, KW>;
  constexpr int WN = C::WN, BM = C::BM, BN = C::BN, LD = C::LD, ST = C::STAGES;
  constexpr int NKT = KW / 8;  // score n-tiles of a warp
  constexpr int NDT = HD / 8;  // output n-tiles
  constexpr int CH = HD / 8;   // 16-byte chunks of a row

  extern __shared__ uint4 smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // BM × LD
  bf16* Ks = Qs + BM * LD;                       // ST × BN × LD
  bf16* Vs = Ks + ST * BN * LD;                  // ST × BN × LD
  __shared__ int is_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int rows = p.S * p.G;
  const int tile = gridDim.x - 1 - blockIdx.x;  // the longest causal tiles start first
  const int row0 = tile * BM;
  const int bk = blockIdx.y, b = bk / p.K, kvh = bk % p.K;
  const bf16* kp = p.k + static_cast<int64_t>(b) * p.skb + static_cast<int64_t>(kvh) * p.skh;
  const bf16* vp = p.v + static_cast<int64_t>(b) * p.svb + static_cast<int64_t>(kvh) * p.svh;

  // this block's keys: [k0, k1), cut to the tile's causal range
  int kbeg, kend;
  causal_range(p, row0, min(row0 + BM, rows), kbeg, kend);
  const int k0 = kbeg + blockIdx.z * p.chunk;
  const int k1 = min(k0 + p.chunk, kend);
  const int ntiles = k1 > k0 ? (k1 - k0 + BN - 1) / BN : 0;

  for (int idx = tid; idx < BM * CH; idx += NT) {
    const int r = idx / CH, c = (idx % CH) * 8;
    const int flat = row0 + r;
    const bool ok = flat < rows;
    const bf16* src = p.q;
    if (ok) {
      const int s = flat / p.G, h = kvh * p.G + flat % p.G;
      src += static_cast<int64_t>(b) * p.sqb + static_cast<int64_t>(s) * p.sqs +
             static_cast<int64_t>(h) * p.sqh + c;
    }
    load16(Qs + r * LD + c, src, ok, p.vec);
  }
  cp_commit();

  auto load_tile = [&](int it) {
    const int t0 = k0 + it * BN;
    bf16* kd = Ks + (it % ST) * BN * LD;
    bf16* vd = Vs + (it % ST) * BN * LD;
    for (int idx = tid; idx < BN * CH; idx += NT) {
      const int j = idx / CH, c = (idx % CH) * 8;
      const int t = t0 + j;
      const bool ok = t < k1;
      load16(kd + j * LD + c, ok ? kp + static_cast<int64_t>(t) * p.skt + c : kp, ok, p.vec);
      load16(vd + j * LD + c, ok ? vp + static_cast<int64_t>(t) * p.svt + c : vp, ok, p.vec);
    }
  };
#pragma unroll
  for (int it = 0; it < ST - 1; ++it) {
    if (it < ntiles) load_tile(it);
    cp_commit();
  }

  // this thread's fragment rows: g and g + 8 of the warp's 16
  const int g = lane >> 2, t4 = lane & 3;
  const int frow = row0 + wm * 16 + g;
  const int qi[2] = {frow / p.G, (frow + 8) / p.G};  // query index (the causal test)
  float acc[NDT][4];
#pragma unroll
  for (int d = 0; d < NDT; ++d) acc[d][0] = acc[d][1] = acc[d][2] = acc[d][3] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};

  for (int it = 0; it < ntiles; ++it) {
    cp_wait<ST - 2>();  // Q and tile it have landed (groups complete in order)
    __syncthreads();    // ... for every thread; and tile it - 1's slot is free
    if (it + ST - 1 < ntiles) load_tile(it + ST - 1);
    cp_commit();
    const bf16* Kt = Ks + ((it % ST) * BN + wn * KW) * LD;
    const bf16* Vt = Vs + ((it % ST) * BN + wn * KW) * LD;

    // S = Q·Kᵀ: 16 rows × KW keys of this warp
    float sc[NKT][4];
#pragma unroll
    for (int j = 0; j < NKT; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, Qs + (wm * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < NKT / 2; ++nj) {
        uint32_t bb[4];
        ldsm_x4(bb, Kt + (nj * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                        ((lane >> 3) & 1) * 8);
        mma(sc[2 * nj], a, bb[0], bb[1]);
        mma(sc[2 * nj + 1], a, bb[2], bb[3]);
      }
    }

    // scale in f32, mask at -1e30, and the online-softmax recurrence of
    // rows g (elements 0, 1) and g + 8 (elements 2, 3); a row's 4 lanes
    // share its max and sum by shuffles
    const int key0 = k0 + it * BN + wn * KW + 2 * t4;
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int j = 0; j < NKT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + j * 8 + (e & 1);
        const bool ok = key < k1 && (!p.causal || keep_key(p, key, qi[e >> 1]));
        sc[j][e] = ok ? sc[j][e] * p.scale : NEG;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r]);
      alpha[r] = __expf(m[r] - mn);
      m[r] = mn;
    }
#pragma unroll
    for (int j = 0; j < NKT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[j][e] = __expf(sc[j][e] - m[e >> 1]);
        rs[e >> 1] += sc[j][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(FULL, rs[r], 1);
      rs[r] += __shfl_xor_sync(FULL, rs[r], 2);
      l[r] = l[r] * alpha[r] + rs[r];
    }
#pragma unroll
    for (int d = 0; d < NDT; ++d) {
      acc[d][0] *= alpha[0];
      acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1];
      acc[d][3] *= alpha[1];
    }

    // acc += P·V: the score fragments of 16 keys are the A fragment of one
    // k-step; P as bf16 hi + lo, V through ldmatrix.trans
#pragma unroll
    for (int ks = 0; ks < KW / 16; ++ks) {
      uint32_t ph[4], pl[4];
      split2(sc[2 * ks][0], sc[2 * ks][1], ph[0], pl[0]);
      split2(sc[2 * ks][2], sc[2 * ks][3], ph[1], pl[1]);
      split2(sc[2 * ks + 1][0], sc[2 * ks + 1][1], ph[2], pl[2]);
      split2(sc[2 * ks + 1][2], sc[2 * ks + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dj = 0; dj < HD / 16; ++dj) {
        uint32_t bb[4];
        ldsm_x4_t(bb, Vt + (ks * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + dj * 16 +
                          (lane >> 4) * 8);
        mma(acc[2 * dj], ph, bb[0], bb[1]);
        mma(acc[2 * dj], pl, bb[0], bb[1]);
        mma(acc[2 * dj + 1], ph, bb[2], bb[3]);
        mma(acc[2 * dj + 1], pl, bb[2], bb[3]);
      }
    }
  }
  cp_wait<0>();

  const bool split = p.nsplit > 1;
  const int64_t part0 = (static_cast<int64_t>(blockIdx.z) * gridDim.y + bk) * rows;
  if constexpr (WN == 1) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int flat = frow + 8 * r;
      if (flat >= rows) continue;  // padded query rows are never written
      if (split) {
        const int64_t part = part0 + flat;
        if (t4 == 0) {
          p.part_ml[2 * part] = m[r];
          p.part_ml[2 * part + 1] = l[r];
        }
#pragma unroll
        for (int d = 0; d < NDT; ++d) {
          float2* dst = reinterpret_cast<float2*>(p.part_acc + part * HD + d * 8 + 2 * t4);
          *dst = make_float2(acc[d][2 * r], acc[d][2 * r + 1]);
        }
      } else {
        bf16* orow = out_row(p, b, kvh, flat, HD);
        const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
        for (int d = 0; d < NDT; ++d)
          *reinterpret_cast<__nv_bfloat162*>(orow + d * 8 + 2 * t4) =
              __floats2bfloat162_rn(acc[d][2 * r] * inv, acc[d][2 * r + 1] * inv);
        if (p.lse && t4 == 0)
          p.lse[lse_index(p, b, kvh, flat)] = m[r] + logf(fmaxf(l[r], 1e-30f));
      }
    }
  } else {
    // the WN warps hold the same 16 rows over different keys: merge their
    // (m, l, acc) through the shared memory of the ring, now idle
    __syncthreads();
    float* red_acc = reinterpret_cast<float*>(Ks);  // WN × 16 × HD
    float* red_ml = red_acc + WN * 16 * HD;          // WN × 16 × 2
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = wn * 16 + g + 8 * r;
#pragma unroll
      for (int d = 0; d < NDT; ++d)
        *reinterpret_cast<float2*>(red_acc + rr * HD + d * 8 + 2 * t4) =
            make_float2(acc[d][2 * r], acc[d][2 * r + 1]);
      if (t4 == 0) {
        red_ml[2 * rr] = m[r];
        red_ml[2 * rr + 1] = l[r];
      }
    }
    __syncthreads();
    for (int idx = tid; idx < 16 * HD; idx += NT) {
      const int r = idx / HD, d = idx % HD;
      const int flat = row0 + r;
      if (flat >= rows) continue;
      float mm = NEG;
#pragma unroll
      for (int w = 0; w < WN; ++w) mm = fmaxf(mm, red_ml[2 * (w * 16 + r)]);
      float ll = 0.f, aa = 0.f;
#pragma unroll
      for (int w = 0; w < WN; ++w) {
        const float sw = __expf(red_ml[2 * (w * 16 + r)] - mm);
        ll = fmaf(red_ml[2 * (w * 16 + r) + 1], sw, ll);
        aa = fmaf(red_acc[(w * 16 + r) * HD + d], sw, aa);
      }
      if (split) {
        const int64_t part = part0 + flat;
        if (d == 0) {
          p.part_ml[2 * part] = mm;
          p.part_ml[2 * part + 1] = ll;
        }
        p.part_acc[part * HD + d] = aa;
      } else {
        out_row(p, b, kvh, flat, HD)[d] = __float2bfloat16_rn(aa / fmaxf(ll, 1e-30f));
        if (p.lse && d == 0) p.lse[lse_index(p, b, kvh, flat)] = mm + logf(fmaxf(ll, 1e-30f));
      }
    }
  }
  if (!split) return;

  // flash-decoding without a second launch: the last of the nsplit blocks
  // of this row tile to arrive merges the partials and resets the counter
  __threadfence();
  __syncthreads();
  int* arrival = p.arrivals + static_cast<int64_t>(bk) * gridDim.x + tile;
  if (tid == 0) is_last = atomicAdd(arrival, 1) == p.nsplit - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const int64_t zstride = static_cast<int64_t>(gridDim.y) * rows;
  const int64_t row_part = static_cast<int64_t>(bk) * rows;
  for (int idx = tid; idx < BM * HD; idx += NT) {
    const int r = idx / HD, d = idx % HD;
    const int flat = row0 + r;
    if (flat >= rows) continue;
    float mm = NEG;
    for (int z = 0; z < p.nsplit; ++z)
      mm = fmaxf(mm, __ldcg(p.part_ml + 2 * (z * zstride + row_part + flat)));
    float ll = 0.f, aa = 0.f;
    for (int z = 0; z < p.nsplit; ++z) {
      const int64_t part = z * zstride + row_part + flat;
      const float w = __expf(__ldcg(p.part_ml + 2 * part) - mm);
      ll = fmaf(__ldcg(p.part_ml + 2 * part + 1), w, ll);
      aa = fmaf(__ldcg(p.part_acc + part * HD + d), w, aa);
    }
    out_row(p, b, kvh, flat, HD)[d] = __float2bfloat16_rn(aa / fmaxf(ll, 1e-30f));
    if (p.lse && d == 0) p.lse[lse_index(p, b, kvh, flat)] = mm + logf(fmaxf(ll, 1e-30f));
  }
  if (tid == 0) *arrival = 0;
}

template <int HD, int WM, int KW>
cudaError_t launch_cfg(const Params& p, cudaStream_t stream) {
  using C = Cfg<HD, WM, KW>;
  if (p.chunk % C::BN != 0) return cudaErrorInvalidValue;
  static svc::PerDevice<cudaError_t> attr_cards;
  const cudaError_t attr = svc::allow_smem(attr_cards, flash_fwd_tc<HD, WM, KW>, C::SMEM);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.S * p.G + C::BM - 1) / C::BM, p.B * p.K, p.nsplit);
  flash_fwd_tc<HD, WM, KW><<<grid, NT, C::SMEM, stream>>>(p);
  return cudaGetLastError();
}

// rows_per_tile 16: the decode configuration; 64: prefill
template <int HD>
cudaError_t launch_rows(const Params& p, int rows_per_tile, cudaStream_t stream) {
  if (rows_per_tile == 16) return launch_cfg<HD, 1, 16>(p, stream);
  if (rows_per_tile == 64) return launch_cfg<HD, 4, (HD == 256 ? 32 : 64)>(p, stream);
  return cudaErrorInvalidValue;
}

cudaError_t launch_all(const Params& p, int hd, int rows_per_tile, cudaStream_t stream) {
  if (p.nsplit < 1 || (p.nsplit > 1 && p.arrivals == nullptr)) return cudaErrorInvalidValue;
  switch (hd) {
    case 16: return launch_rows<16>(p, rows_per_tile, stream);
    case 32: return launch_rows<32>(p, rows_per_tile, stream);
    case 64: return launch_rows<64>(p, rows_per_tile, stream);
    case 96: return launch_rows<96>(p, rows_per_tile, stream);
    case 128: return launch_rows<128>(p, rows_per_tile, stream);
    case 256: return launch_rows<256>(p, rows_per_tile, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

// dtype 0 float32 (the CUDA-core route: rows_per_tile 8 or 32, chunk a
// multiple of 32, part_ml (nsplit, B·K, S·G, 2) and part_acc (nsplit, B·K,
// S·G, hd) f32 when nsplit > 1, merged by a second launch); dtype 1
// bfloat16 (the tensor-core route: rows_per_tile 16 or 64, chunk a multiple
// of the key tile, the same partials plus arrivals (B·K, row tiles) int32,
// zero on entry and on exit, merged in the same launch).  q, k, v and out
// share the dtype.  causal 1 takes window, qpos and key_pos (null, or an
// int32 (T,) device array) as the header says; causal 0 ignores them.
// lse: null, or a (B, H, S) float32 array that receives every row's
// m + log l.
extern "C" int svc_flash_attention(const void* q, const void* k, const void* v, void* o,
                                   int64_t sqb, int64_t sqs, int64_t sqh, int64_t skb,
                                   int64_t skt, int64_t skh, int64_t svb, int64_t svt,
                                   int64_t svh, int B, int S, int T, int H, int K, int hd,
                                   int causal, int window, int qpos, float scale, int dtype,
                                   int rows_per_tile, int chunk, int nsplit, int vec,
                                   const int* key_pos, float* part_ml, float* part_acc,
                                   int* arrivals, float* lse, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    cuda_cores::Params p{q, k, v, o, sqb, sqs, sqh, skb, skt, skh, svb, svt, svh, B, S, T, H, K,
                         H / K, causal, window, qpos, scale, chunk, nsplit, vec, key_pos,
                         part_ml, part_acc, lse};
    if ((rows_per_tile != 8 && rows_per_tile != 32) || chunk % cuda_cores::BK != 0 || nsplit < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cuda_cores::launch_all<float>(p, hd, rows_per_tile, st));
  }
  if (dtype == 1) {
    tc::Params p{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                 static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
                 sqb, sqs, sqh, skb, skt, skh, svb, svt, svh, B, S, T, H, K, H / K, causal, window,
                 qpos, scale, chunk, nsplit, vec, key_pos, part_ml, part_acc, arrivals, lse};
    return static_cast<int>(tc::launch_all(p, hd, rows_per_tile, st));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
