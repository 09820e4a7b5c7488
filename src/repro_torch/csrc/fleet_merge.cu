// Fleet-wide merge remainder: every view's dense delta groups upserted into
// its stale sample, `(stale + ins) − del` per aggregate, with the
// delta-only groups (delete-cancellation included) as new rows, written in
// the sorted order of the per-view stable key sort.
//
// Replaces the Pallas kernel src/repro/kernels/fleet_merge/kernel.py:
// fleet_merge_tiles (body _fleet_merge_kernel) and the XLA key sort after
// it (src/repro/kernels/fleet_merge/ops.py:_sort_by_key).  The TPU version
// matches every stale key of a (256 rows, 128 views) tile against each of
// 128 groups as one-hot masks — O(R·G) work — and then sorts all R + G
// output rows of each view.  Here the output is a merge of two sorted
// lists, so only the R stale keys are sorted:
//
//   1. fleet_merge_sort — one block per view stably sorts its SENTINEL-masked
//      stale keys in shared memory (bitonic on key·2^32 + row; skipped when
//      they arrive in order, as merge slots built by `compact` do) and
//      records, for each tile of kTile groups, the first sorted rank whose
//      key reaches the tile (a lower bound).
//   2. fleet_merge_count — one block per (tile, view), one thread per word
//      of 32 groups: it marks in shared memory the groups the tile's stale
//      keys carry, flags the live groups no stale row carries (the
//      delta-only rows) as one bit each, from 16-byte loads of the delta
//      flags, and counts them.
//   3. fleet_merge_scatter — one block per (tile, view) turns the tiles'
//      counts and its flag words into an exclusive prefix sum and writes
//      every output slot of its tile exactly once: a delta-only group g
//      at (delta-only groups below g) + (stale keys below g), found by
//      binary search of the tile's sorted stale keys (staged in shared
//      memory up to kStage keys), the tile's delta-only groups listed in
//      shared memory so that every thread takes one; the stale row of
//      sorted rank j with key k at j + (delta-only groups below k) — 0
//      below 0, D at or above G, SENTINEL included (those out of [0, G)
//      dealt round all of the view's blocks); and, last, the tile's
//      other groups at one run of padding slots starting at
//      R + D + (g0 − delta-only groups below g0), filled with 16-byte
//      stores.  The rows with dependent loads go first, so their latency
//      overlaps the other warps' stores.  Stale rows therefore keep their stable order
//      among equal keys and precede a delta-only row of their key, as the
//      stable sort of the unsorted rows would.
//
// Bound: device memory — the (V, R + G) output is written once, the delta
// flags are read once (pass 2; pass 3 reads the 1-bit flags), delta
// aggregates only for delta-only groups and in-range stale rows.  Three
// launches, no memset, no sort of the output.
// kernels/fleet_merge/ref.py:fleet_merge_rank_ref is the same computation
// in plain PyTorch.
//
// The result must equal the plain PyTorch version bit for bit: the add and
// the subtract are round-to-nearest intrinsics, so nvcc can neither
// reassociate nor contract them, and the zero substitutions are those of
// kernels/fleet_merge/ref.py.  SENTINEL keys and keys outside [0, G) never
// index.
#include "svc_common.cuh"

namespace {

constexpr int kTile = 4096;             // groups per block of passes 2 and 3
constexpr int kWords = kTile / 32;      // flag words per tile: one thread each in pass 2
constexpr int kThreads = 256;           // pass 3
constexpr int kWarps = kThreads / 32;
constexpr int kStage = 2048;            // a tile's sorted stale keys staged in shared memory
constexpr int kSortMax = 16384;         // stale rows per view the block sort takes (128 KiB)
constexpr int kSortThreads = 1024;

__device__ __forceinline__ unsigned long long sort_word(int32_t key, uint32_t row) {
  return (static_cast<unsigned long long>(static_cast<uint32_t>(key) ^ 0x80000000u) << 32) | row;
}

__device__ __forceinline__ int lower_bound(const int32_t* a, int n, int64_t x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (static_cast<int64_t>(a[mid]) < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// One bit per byte of four: bit i set iff byte i of x is not 0.
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  const uint32_t r = __vcmpne4(x, 0u) & 0x01010101u;
  return (r | (r >> 7) | (r >> 14) | (r >> 21)) & 0xFu;
}

__device__ __forceinline__ uint32_t nonzero_bytes(uint4 x) {
  return nonzero_bytes(x.x) | (nonzero_bytes(x.y) << 4) | (nonzero_bytes(x.z) << 8) |
         (nonzero_bytes(x.w) << 12);
}

// n 32-bit words of `val` from p (4-byte aligned) by the whole block.
__device__ void fill_words(uint32_t* p, int64_t n, uint32_t val) {
  const int64_t head_max = ((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) / 4;
  const int64_t head = head_max < n ? head_max : n;
  const int64_t body = (n - head) / 4;
  for (int64_t i = threadIdx.x; i < head; i += blockDim.x) p[i] = val;
  uint4* q = reinterpret_cast<uint4*>(p + head);
  for (int64_t i = threadIdx.x; i < body; i += blockDim.x) q[i] = make_uint4(val, val, val, val);
  for (int64_t i = head + 4 * body + threadIdx.x; i < n; i += blockDim.x) p[i] = val;
}

// n zero bytes from p by the whole block.
__device__ void zero_bytes(uint8_t* p, int64_t n) {
  const int64_t head_max = (16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15;
  const int64_t head = head_max < n ? head_max : n;
  const int64_t body = (n - head) / 16;
  for (int64_t i = threadIdx.x; i < head; i += blockDim.x) p[i] = 0;
  uint4* q = reinterpret_cast<uint4*>(p + head);
  for (int64_t i = threadIdx.x; i < body; i += blockDim.x) q[i] = make_uint4(0, 0, 0, 0);
  for (int64_t i = head + 16 * body + threadIdx.x; i < n; i += blockDim.x) p[i] = 0;
}

__global__ void __launch_bounds__(kSortThreads)
fleet_merge_sort(const int32_t* __restrict__ skeys, const uint8_t* __restrict__ svalid,
                 int rows, int64_t groups, int tiles, int pow2, int32_t* __restrict__ sorted,
                 int32_t* __restrict__ perm, int32_t* __restrict__ bounds) {
  extern __shared__ unsigned long long words[];
  const int64_t v = blockIdx.x;
  const int32_t* k = skeys + v * rows;
  const uint8_t* ok = svalid + v * rows;
  for (int i = threadIdx.x; i < pow2; i += blockDim.x) {
    words[i] = i < rows ? sort_word(ok[i] ? k[i] : svc::SENTINEL_KEY, i) : ~0ull;
  }
  __syncthreads();
  // merge slots arrive compacted, keys ascending: then the stable sort is
  // the identity and the network is skipped
  int unsorted = 0;
  for (int i = threadIdx.x; i + 1 < rows; i += blockDim.x) unsorted |= words[i] > words[i + 1];
  if (__syncthreads_or(unsorted)) {
    for (int size = 2; size <= pow2; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int t = threadIdx.x; t < pow2 / 2; t += blockDim.x) {
          const int lo = 2 * t - (t & (stride - 1));
          const int hi = lo + stride;
          const unsigned long long a = words[lo], b = words[hi];
          if ((a > b) == ((lo & size) == 0)) {
            words[lo] = b;
            words[hi] = a;
          }
        }
        __syncthreads();
      }
    }
  }
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    const unsigned long long w = words[i];
    sorted[v * rows + i] = static_cast<int32_t>(static_cast<uint32_t>(w >> 32) ^ 0x80000000u);
    perm[v * rows + i] = static_cast<int32_t>(w & 0xFFFFFFFFull);
  }
  for (int t = threadIdx.x; t <= tiles; t += blockDim.x) {
    const int64_t start = static_cast<int64_t>(t) * kTile;
    const int64_t g = start < groups ? start : groups;
    const unsigned long long probe = sort_word(static_cast<int32_t>(g), 0);
    int lo = 0, hi = rows;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (words[mid] < probe) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    bounds[v * (tiles + 1) + t] = lo;
  }
}

// One thread per 32-group flag word: live = ins ∨ del from 16-byte loads
// where the view's row of flags is 16-byte aligned, present from the
// tile's sorted stale keys.
__global__ void __launch_bounds__(kWords)
fleet_merge_count(const int32_t* __restrict__ sorted, const int32_t* __restrict__ bounds,
                  const uint8_t* __restrict__ ivalid, const uint8_t* __restrict__ dvalid,
                  int rows, int64_t groups, int tiles, int64_t nwords,
                  uint32_t* __restrict__ flags, int32_t* __restrict__ counts) {
  __shared__ uint32_t present[kWords];
  __shared__ int warp_counts[kWords / 32];
  const int t = blockIdx.x;
  const int64_t v = blockIdx.y;
  const int64_t g0 = static_cast<int64_t>(t) * kTile;
  const int w = threadIdx.x;
  present[w] = 0;
  __syncthreads();
  const int32_t* sk = sorted + v * rows;
  const int lo = bounds[v * (tiles + 1) + t], hi = bounds[v * (tiles + 1) + t + 1];
  for (int j = lo + w; j < hi; j += kWords) {
    const int x = static_cast<int>(sk[j] - g0);
    atomicOr(&present[x >> 5], 1u << (x & 31));
  }
  __syncthreads();
  const int64_t gw = g0 + 32 * w;  // the word's first group
  const int64_t left = groups - gw;
  const int m = left <= 0 ? 0 : (left < 32 ? static_cast<int>(left) : 32);
  const int64_t base = v * groups + gw;
  uint32_t live = 0;
  const bool aligned = ((reinterpret_cast<uintptr_t>(ivalid + base) |
                         (dvalid != nullptr ? reinterpret_cast<uintptr_t>(dvalid + base) : 0)) &
                        15) == 0;
  if (m == 32 && aligned) {
    const uint4* iv = reinterpret_cast<const uint4*>(ivalid + base);
    live = nonzero_bytes(iv[0]) | (nonzero_bytes(iv[1]) << 16);
    if (dvalid != nullptr) {
      const uint4* dv = reinterpret_cast<const uint4*>(dvalid + base);
      live |= nonzero_bytes(dv[0]) | (nonzero_bytes(dv[1]) << 16);
    }
  } else {
    for (int b = 0; b < m; ++b) {
      const bool l = ivalid[base + b] != 0 || (dvalid != nullptr && dvalid[base + b] != 0);
      live |= static_cast<uint32_t>(l) << b;
    }
  }
  const uint32_t word = live & ~present[w];
  if (gw / 32 < nwords && m > 0) flags[v * nwords + gw / 32] = word;
  int count = __popc(word);
  for (int o = 16; o > 0; o >>= 1) count += __shfl_down_sync(0xFFFFFFFFu, count, o);
  if ((w & 31) == 0) warp_counts[w >> 5] = count;
  __syncthreads();
  if (w == 0) {
    int total = 0;
    for (int i = 0; i < kWords / 32; ++i) total += warp_counts[i];
    counts[v * tiles + t] = total;
  }
}

__global__ void __launch_bounds__(kThreads)
fleet_merge_scatter(const int32_t* __restrict__ sorted, const int32_t* __restrict__ perm,
                    const int32_t* __restrict__ bounds, const uint32_t* __restrict__ flags,
                    const int32_t* __restrict__ counts, const uint8_t* __restrict__ svalid,
                    const float* __restrict__ svals, const uint8_t* __restrict__ ivalid,
                    const float* __restrict__ ivals, const uint8_t* __restrict__ dvalid,
                    const float* __restrict__ dvals, int rows, int64_t groups, int tiles,
                    int64_t nwords, int aggs, int32_t* __restrict__ out_keys,
                    float* __restrict__ out_vals, uint8_t* __restrict__ out_valid) {
  __shared__ uint32_t word[kWords];
  __shared__ int prefix[kWords + 1];  // delta-only groups of the tile before each word
  __shared__ int32_t stage[kStage];
  __shared__ uint16_t only_x[kTile];  // the tile's delta-only groups, ascending
  __shared__ int part[2][kWarps];
  __shared__ int warp_incl[kWarps];
  const int t = blockIdx.x;
  const int64_t v = blockIdx.y;
  const int64_t g0 = static_cast<int64_t>(t) * kTile;
  const int n = static_cast<int>(groups - g0 < kTile ? groups - g0 : kTile);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // the delta-only groups before this tile, and the view's total D
  int before = 0, total = 0;
  for (int i = threadIdx.x; i < tiles; i += kThreads) {
    const int c = counts[v * tiles + i];
    total += c;
    if (i < t) before += c;
  }
  for (int o = 16; o > 0; o >>= 1) {
    before += __shfl_down_sync(0xFFFFFFFFu, before, o);
    total += __shfl_down_sync(0xFFFFFFFFu, total, o);
  }
  if (lane == 0) {
    part[0][warp] = before;
    part[1][warp] = total;
  }
  // the tile's flag words and their exclusive popcount prefix
  int pc = 0;
  if (threadIdx.x < kWords) {
    const int64_t fw = g0 / 32 + threadIdx.x;
    const uint32_t w = fw < nwords ? flags[v * nwords + fw] : 0u;
    word[threadIdx.x] = w;
    pc = __popc(w);
  }
  int incl = pc;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_incl[warp] = incl;
  // the tile's sorted stale keys, staged when they fit
  const int32_t* sk = sorted + v * rows;
  const int lo = bounds[v * (tiles + 1) + t], hi = bounds[v * (tiles + 1) + t + 1];
  const bool staged = hi - lo <= kStage;
  if (staged) {
    for (int j = lo + threadIdx.x; j < hi; j += kThreads) stage[j - lo] = sk[j];
  }
  __syncthreads();
  if (threadIdx.x < kWords) {
    int add = 0;
    for (int w = 0; w < warp; ++w) add += warp_incl[w];
    prefix[threadIdx.x] = incl - pc + add;
    if (threadIdx.x == kWords - 1) prefix[kWords] = incl + add;
  }
  int tile_off = 0, d = 0;
  for (int w = 0; w < kWarps; ++w) {
    tile_off += part[0][w];
    d += part[1][w];
  }
  __syncthreads();

  // the delta-only rows, one a thread: the i-th of the tile goes to
  // (delta-only groups below it: tile_off + i) + (stale keys below it)
  if (threadIdx.x < kWords) {
    uint32_t bits = word[threadIdx.x];
    int r = prefix[threadIdx.x];
    while (bits != 0u) {
      only_x[r++] = static_cast<uint16_t>(threadIdx.x * 32 + __ffs(bits) - 1);
      bits &= bits - 1u;
    }
  }
  __syncthreads();
  const int64_t out0 = v * (static_cast<int64_t>(rows) + groups);
  const int32_t* keys_in_tile = staged ? stage : sk + lo;
  for (int i = threadIdx.x; i < prefix[kWords]; i += kThreads) {
    const int64_t g = g0 + only_x[i];
    const int64_t o = out0 + tile_off + i + lo + lower_bound(keys_in_tile, hi - lo, g);
    const int64_t gi = v * groups + g;
    const bool iv = ivalid[gi] != 0;
    const bool dv = dvalid != nullptr && dvalid[gi] != 0;
    for (int a = 0; a < aggs; ++a) {
      const float add = iv ? ivals[gi * aggs + a] : 0.0f;
      const float sub = dv ? dvals[gi * aggs + a] : 0.0f;
      out_vals[o * aggs + a] = __fsub_rn(add, sub);
    }
    out_keys[o] = static_cast<int32_t>(g);
    out_valid[o] = 1;
  }

  // the stale rows: those keyed in this tile here; those keyed below 0
  // (slot j) or at or above G (slot j + D, the invalid rows' SENTINEL
  // among them) spread over all of the view's blocks, so no block takes
  // a view's whole tail of invalid rows
  const int32_t* pv = perm + v * rows;
  const int neg = bounds[v * (tiles + 1)];         // ranks [0, neg): keys < 0
  const int ge = bounds[v * (tiles + 1) + tiles];  // ranks [ge, rows): keys ≥ G
  const int own = hi - lo;
  const int64_t spread = neg + (rows - ge);
  const int64_t chunks = (spread + kThreads - 1) / kThreads;  // dealt round the tiles
  const int64_t mine = chunks > t ? (chunks - t + tiles - 1) / tiles : 0;
  for (int64_t q = threadIdx.x; q < own + mine * kThreads; q += kThreads) {
    int j, below;
    if (q < own) {
      j = lo + static_cast<int>(q);
      const int x = static_cast<int>(sk[j] - g0);
      below = tile_off + prefix[x >> 5] + __popc(word[x >> 5] & ((1u << (x & 31)) - 1u));
    } else {
      const int64_t r = q - own;  // this block's r-th spread row
      const int64_t idx = (r / kThreads) * tiles * kThreads + t * kThreads + r % kThreads;
      if (idx >= spread) continue;
      j = idx < neg ? static_cast<int>(idx) : ge + static_cast<int>(idx - neg);
      below = idx < neg ? 0 : d;
    }
    const int32_t k = sk[j];
    const int64_t o = out0 + j + below;
    const int64_t i = v * rows + pv[j];
    const bool sv = svalid[i] != 0;
    const bool in_range = sv && k >= 0 && static_cast<int64_t>(k) < groups;
    const int64_t g = v * groups + (in_range ? k : 0);
    const bool ih = in_range && ivalid[g] != 0;
    const bool dh = in_range && dvalid != nullptr && dvalid[g] != 0;
    for (int a = 0; a < aggs; ++a) {
      const float base = sv ? svals[i * aggs + a] : 0.0f;
      const float add = ih ? ivals[g * aggs + a] : 0.0f;
      const float sub = dh ? dvals[g * aggs + a] : 0.0f;
      const float val = __fsub_rn(__fadd_rn(base, add), sub);
      out_vals[o * aggs + a] = sv ? val : 0.0f;
    }
    out_keys[o] = sv ? k : svc::SENTINEL_KEY;
    out_valid[o] = sv ? 1 : 0;
  }

  // the tile's groups that are not delta-only take one contiguous run of
  // padding slots, R + D + (g − delta-only groups below g)
  const int64_t pad0 = out0 + rows + d + (g0 - tile_off);
  const int64_t npad = n - prefix[kWords];
  fill_words(reinterpret_cast<uint32_t*>(out_keys + pad0), npad,
             static_cast<uint32_t>(svc::SENTINEL_KEY));
  zero_bytes(out_valid + pad0, npad);
  fill_words(reinterpret_cast<uint32_t*>(out_vals + pad0 * aggs), npad * aggs, 0u);
}

}  // namespace

// Pass 1 alone: sorted masked stale keys, their rows, and the per-tile
// lower bounds (views × (tiles + 1)).  rows ≤ kSortMax.
extern "C" int svc_fleet_merge_sort(const int32_t* skeys, const uint8_t* svalid, int64_t views,
                                    int64_t rows, int64_t groups, int32_t* sorted, int32_t* perm,
                                    int32_t* bounds, void* stream) {
  if (rows > kSortMax || views > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = static_cast<int>((groups + kTile - 1) / kTile);
  int pow2 = 1;
  while (pow2 < rows) pow2 <<= 1;
  const size_t smem = static_cast<size_t>(pow2) * sizeof(unsigned long long);
  cudaError_t err = cudaFuncSetAttribute(fleet_merge_sort,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int half = pow2 / 2 < 32 ? 32 : pow2 / 2;
  const int block = half < kSortThreads ? half : kSortThreads;
  fleet_merge_sort<<<static_cast<unsigned>(views), block, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      skeys, svalid, static_cast<int>(rows), groups, tiles, pow2, sorted, perm, bounds);
  return static_cast<int>(cudaGetLastError());
}

// Passes 2 and 3 from the sorted stale keys.  dvalid/dvals may be null (no
// delete side).  flags: views × ceil(groups / 32) words; counts: views × tiles.
extern "C" int svc_fleet_merge(const int32_t* sorted, const int32_t* perm, const int32_t* bounds,
                               const uint8_t* svalid, const float* svals, const uint8_t* ivalid,
                               const float* ivals, const uint8_t* dvalid, const float* dvals,
                               int64_t views, int64_t rows, int64_t groups, int aggs,
                               uint32_t* flags, int32_t* counts, int32_t* out_keys,
                               float* out_vals, uint8_t* out_valid, void* stream) {
  if (views > 65535 || rows + groups > 0x7FFFFFFF) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = static_cast<int>((groups + kTile - 1) / kTile);
  const int64_t nwords = (groups + 31) / 32;
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(views));
  fleet_merge_count<<<grid, kWords, 0, s>>>(sorted, bounds, ivalid, dvalid,
                                               static_cast<int>(rows), groups, tiles, nwords,
                                               flags, counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fleet_merge_scatter<<<grid, kThreads, 0, s>>>(
      sorted, perm, bounds, flags, counts, svalid, svals, ivalid, ivals, dvalid, dvals,
      static_cast<int>(rows), groups, tiles, nwords, aggs, out_keys, out_vals, out_valid);
  return static_cast<int>(cudaGetLastError());
}
