// Group-by segment sums: out[g, c] = Σ_{i : gid[i] == g} vals[i, c], rows
// whose gid lies outside [0, G) dropped (the group-by's overflow slot G
// among them), as jax.ops.segment_sum drops them.  Two entries:
//
//   svc_segment_sorted — the group-by's: ids non-decreasing, a reduce-by-key
//     over runs of equal ids that also counts each group's rows in int32.
//   svc_segment_sum    — ids in any order (the exported library call).
//
// Both replace the Pallas kernel src/repro/kernels/segment_aggsum/kernel.py:
// segment_sum_tiles (body _segsum_kernel).  The TPU version builds a
// (rows × 128 groups) one-hot tile and multiplies it into the values on the
// MXU, revisiting each group tile across the sequential row grid — O(R·G)
// work that only a matrix unit makes cheap.
//
// Bound: device memory — 4 bytes of gid per row, 4 bytes per in-range
// value, 4 bytes per output count and sum, the zero fill of the outputs
// included.
//
// svc_segment_sorted.  The group-by sorts its rows by key before it numbers
// them, so the ids arrive in runs, and a Zipf-hot group is one run of
// millions of rows.  The outputs are zeroed, then one launch:
//   * A persistent grid (as many blocks as fit on the card) splits the rows
//     into equal ranges of chunks, 256·K rows a chunk.  A thread reads K
//     consecutive ids and their K·C values with 16-byte loads (values only
//     where one of its rows is in range; out-of-range ids read as key −1)
//     and sums its runs in float64, each run's rows in row order.  A run
//     that begins and ends inside the thread is final and goes to the
//     output at once.  Then it issues the next chunk's loads, which land
//     while the block joins this chunk's runs.
//   * A block-wide segmented scan (shuffles in a warp, warps in order
//     through shared memory) joins the runs that cross threads; again every
//     run that begins and ends inside the chunk goes out at once.  The runs
//     that touch a chunk's first or last row pass to the next chunk of the
//     range in a carry held by thread 0, in row order.
//   * The range's first and last runs become two records in a persistent
//     workspace.  The last block to arrive (a __threadfence, then a ticket,
//     which it resets) reduces the records by the same scan in block order,
//     so a group that spans ranges is summed in a fixed order too.
// Each group's total is rounded once, float64 → float32, and added to the
// zeroed output by exactly one atomic: no two adds meet on one address, so
// repeats are bit-equal and no hot address serialises.  (Ids out of order
// still give exact counts and every row's value once; only the sums' order,
// and so their last bits, then vary.)  Counts are int32, exact to 2^31 − 1
// rows a group.  A float32 atomic add flushes a subnormal result to zero,
// so a group whose sum lies below 2^-126 in magnitude reads 0.
//
// svc_segment_sum.  Lanes of a warp walk consecutive rows of one column, a
// segmented inclusive scan over the warp (shuffles, in lane order) sums each
// run of equal ids, and only the run's last lane adds into the zeroed output
// with a float atomic: one atomic per run and warp.  The sums depend on the
// order of the adds across warps and vary in their last bits run to run.
#include "svc_common.cuh"

namespace segsorted {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 8;       // columns one launch sums (ops.py splits wider panels)
constexpr int kRecordsPerThread = 4;  // records a thread takes per chunk of the last pass
constexpr unsigned kFull = 0xffffffffu;

// rows a thread takes per chunk: K ids and K·C values stay in registers
template <int NC>
__host__ __device__ constexpr int rows_per_thread() {
  return NC <= 2 ? 16 : (NC <= 4 ? 8 : 4);
}

struct Params {
  const int32_t* gid;  // (rows,) non-decreasing
  const float* vals;   // (rows, NC) row-major
  int64_t rows;
  int64_t groups;      // G
  int32_t* counts;     // (G,) zeroed, or null: no counts
  float* out;          // (G, NC) zeroed
  int32_t* ticket;     // 0 between launches
  int32_t* rec_key;    // (2·gridDim.x,) each range's first and last run
  int32_t* rec_cnt;
  double* rec_sum;     // (2·gridDim.x, NC)
  int64_t chunks;      // ⌈rows / (256·K)⌉
  bool vec;            // gid and vals 16-byte aligned
};

template <int NC>
struct Run {
  int key;  // −1: dropped rows
  int cnt;
  double s[NC > 0 ? NC : 1];
};

template <int NC>
__device__ __forceinline__ void add(Run<NC>& a, const Run<NC>& b) {
  a.cnt += b.cnt;
#pragma unroll
  for (int c = 0; c < NC; ++c) a.s[c] += b.s[c];
}

// A final run: its count and sums go to the zeroed outputs (each group gets
// exactly one when the ids are sorted).
template <int NC>
__device__ __forceinline__ void emit(const Params& p, const Run<NC>& r) {
  if (r.key < 0) return;
  if (p.counts != nullptr) atomicAdd(p.counts + r.key, r.cnt);
#pragma unroll
  for (int c = 0; c < NC; ++c)
    atomicAdd(p.out + static_cast<int64_t>(r.key) * NC + c, __double2float_rn(r.s[c]));
}

template <int NC>
struct Smem {
  int fkey[kThreads];  // each thread's first and last run keys
  int lkey[kThreads];
  unsigned char single[kThreads];  // the thread's elements are one run
  unsigned ballot[kWarps];         // threads ≥ 1 whose last run starts in them
  int warp_cnt[kWarps];            // each warp's scan at lane 31, before the cross-warp fix
  double warp_sum[kWarps][NC > 0 ? NC : 1];
  int warp_head[kWarps];
  int fin_cnt[kWarps];             // the same after it
  double fin_sum[kWarps][NC > 0 ? NC : 1];
  int fin_origin[kWarps];
  Run<NC> head, tail;              // the chunk's first and last run
  int whole;                       // the chunk is one run
  int last_block;
};

// One thread's K elements in order: runs wholly inside go out; returns
// whether all K are one run; `first` and `last` are the runs holding its
// first and last element.
template <int NC, int K, typename V>
__device__ __forceinline__ bool thread_runs(const Params& p, const int (&key)[K],
                                            const int (&cnt)[K], const V (&v)[K][NC > 0 ? NC : 1],
                                            Run<NC>& first, Run<NC>& last) {
  Run<NC> cur;
  cur.key = key[0];
  cur.cnt = cnt[0];
#pragma unroll
  for (int c = 0; c < NC; ++c) cur.s[c] = static_cast<double>(v[0][c]);
  bool split = false;
#pragma unroll
  for (int j = 1; j < K; ++j) {
    if (key[j] != cur.key) {
      if (split) emit(p, cur);
      else first = cur;
      split = true;
      cur.key = key[j];
      cur.cnt = cnt[j];
#pragma unroll
      for (int c = 0; c < NC; ++c) cur.s[c] = static_cast<double>(v[j][c]);
    } else {
      cur.cnt += cnt[j];
#pragma unroll
      for (int c = 0; c < NC; ++c) cur.s[c] += static_cast<double>(v[j][c]);
    }
  }
  if (!split) first = cur;
  last = cur;
  return !split;
}

// Join the threads' runs across the block (threads in order).  Runs that
// begin and end inside the chunk go out; the chunk's first and last run
// land in sm.head / sm.tail (sm.whole: they are one).  Ends on a barrier.
template <int NC>
__device__ void block_runs(const Params& p, Smem<NC>& sm, const Run<NC>& first,
                           const Run<NC>& last, bool single) {
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  sm.fkey[t] = first.key;
  sm.lkey[t] = last.key;
  sm.single[t] = single;
  __syncthreads();
  const int prev_lkey = t > 0 ? sm.lkey[t - 1] : 0;
  // thread t's last run starts in thread t, or continues thread t − 1's
  const bool head = t == 0 || !single || prev_lkey != last.key;
  const unsigned ballot = __ballot_sync(kFull, head && t > 0);
  // inclusive segmented scan of the last runs over the warp
  int sc = last.cnt;
  double ss[NC > 0 ? NC : 1];
#pragma unroll
  for (int c = 0; c < NC; ++c) ss[c] = last.s[c];
  int h = head;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int uc = __shfl_up_sync(kFull, sc, off);
    double us[NC > 0 ? NC : 1];
#pragma unroll
    for (int c = 0; c < NC; ++c) us[c] = __shfl_up_sync(kFull, ss[c], off);
    const int uh = __shfl_up_sync(kFull, h, off);
    if (lane >= off && !h) {
      sc += uc;
#pragma unroll
      for (int c = 0; c < NC; ++c) ss[c] = us[c] + ss[c];
      h = uh;
    }
  }
  if (lane == 31) {
    sm.warp_cnt[w] = sc;
#pragma unroll
    for (int c = 0; c < NC; ++c) sm.warp_sum[w][c] = ss[c];
    sm.warp_head[w] = h;
  }
  if (lane == 0) sm.ballot[w] = ballot;
  __syncthreads();
  if (!h) {  // the run began in an earlier warp: add the warps before, nearest first
    int ac = 0;
    double as[NC > 0 ? NC : 1];
#pragma unroll
    for (int c = 0; c < NC; ++c) as[c] = 0.0;
    for (int u = w - 1; u >= 0; --u) {
      ac += sm.warp_cnt[u];
#pragma unroll
      for (int c = 0; c < NC; ++c) as[c] = sm.warp_sum[u][c] + as[c];
      if (sm.warp_head[u]) break;
    }
    sc += ac;
#pragma unroll
    for (int c = 0; c < NC; ++c) ss[c] = as[c] + ss[c];
  }
  int first_head = kThreads;  // the first thread ≥ 1 whose last run starts in it
  for (int u = 0; u < kWarps; ++u) {
    if (sm.ballot[u] != 0) {
      first_head = 32 * u + __ffs(sm.ballot[u]) - 1;
      break;
    }
  }
  // the run through thread t's end holds the chunk's first element
  const int origin = sm.single[0] && t < first_head;
  if (lane == 31) {
    sm.fin_cnt[w] = sc;
#pragma unroll
    for (int c = 0; c < NC; ++c) sm.fin_sum[w][c] = ss[c];
    sm.fin_origin[w] = origin;
  }
  __syncthreads();
  // the scan through thread t − 1
  int pc = __shfl_up_sync(kFull, sc, 1);
  double ps[NC > 0 ? NC : 1];
#pragma unroll
  for (int c = 0; c < NC; ++c) ps[c] = __shfl_up_sync(kFull, ss[c], 1);
  int porigin = __shfl_up_sync(kFull, origin, 1);
  if (lane == 0 && w > 0) {
    pc = sm.fin_cnt[w - 1];
#pragma unroll
    for (int c = 0; c < NC; ++c) ps[c] = sm.fin_sum[w - 1][c];
    porigin = sm.fin_origin[w - 1];
  }
  const bool last_thread = t == kThreads - 1;
  const bool ends_here = last_thread || sm.fkey[t + 1] != last.key;
  if (!single) {
    Run<NC> f = first;
    const bool joined = t > 0 && prev_lkey == first.key;
    if (joined) {
      f.cnt += pc;
#pragma unroll
      for (int c = 0; c < NC; ++c) f.s[c] = ps[c] + f.s[c];
    }
    if (t == 0 || (joined && porigin)) sm.head = f;
    else emit(p, f);
    if (last_thread) sm.tail = last;
    else if (ends_here) emit(p, last);
  } else if (ends_here) {
    Run<NC> s;
    s.key = last.key;
    s.cnt = sc;
#pragma unroll
    for (int c = 0; c < NC; ++c) s.s[c] = ss[c];
    if (last_thread) sm.tail = s;
    if (origin) sm.head = s;
    else if (!last_thread) emit(p, s);
  }
  if (last_thread) sm.whole = single && origin;
  __syncthreads();
}

// Thread 0's walk over a range's chunks in row order: `carry` is the run
// through the last chunk's end; while `open`, it is also the range's first
// run, which stays out of the output (the range before may hold more of
// it); otherwise that run is `head`.
template <int NC>
struct Carry {
  Run<NC> carry, head;
  bool open = true;
  bool started = false;

  __device__ void close(const Params& p, const Run<NC>& r) {
    if (open) {
      head = r;
      open = false;
    } else {
      emit(p, r);
    }
  }

  // the next chunk: its first and last run, `whole` when they are one
  __device__ void push(const Params& p, const Run<NC>& h, const Run<NC>& tl, bool whole) {
    if (!started) {
      started = true;
      carry = h;
      if (!whole) {
        close(p, h);
        carry = tl;
      }
      return;
    }
    if (h.key == carry.key) {
      add(carry, h);
      if (whole) return;
      close(p, carry);
    } else {
      close(p, carry);
      if (whole) {
        carry = h;
        return;
      }
      close(p, h);
    }
    carry = tl;
  }
};

// Thread t's K rows of chunk ch: keys (−1 for a dropped row or a row past
// the end) and values; returns whether any row is in range.  Values are
// read only where one is; a dropped row's values add only into runs of key
// −1, which never reach the output.
template <int NC, int K>
__device__ __forceinline__ bool load_rows(const Params& p, int64_t ch, int (&key)[K],
                                          float (&v)[K][NC > 0 ? NC : 1]) {
  constexpr int64_t kChunk = static_cast<int64_t>(kThreads) * K;
  const int64_t r = ch * kChunk + static_cast<int64_t>(threadIdx.x) * K;
  bool any = false;
  if (p.vec && (ch + 1) * kChunk <= p.rows) {
    const int4* g4 = reinterpret_cast<const int4*>(p.gid + r);
#pragma unroll
    for (int q = 0; q < K / 4; ++q) {
      const int4 g = __ldg(g4 + q);
      key[4 * q] = g.x;
      key[4 * q + 1] = g.y;
      key[4 * q + 2] = g.z;
      key[4 * q + 3] = g.w;
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      key[j] = key[j] >= 0 && key[j] < p.groups ? key[j] : -1;
      any |= key[j] >= 0;
    }
    if (NC > 0 && any) {
      const float4* v4 = reinterpret_cast<const float4*>(p.vals + r * NC);
      float flat[K * (NC > 0 ? NC : 1)];
#pragma unroll
      for (int q = 0; q < K * NC / 4; ++q) {
        const float4 x = __ldg(v4 + q);
        flat[4 * q] = x.x;
        flat[4 * q + 1] = x.y;
        flat[4 * q + 2] = x.z;
        flat[4 * q + 3] = x.w;
      }
#pragma unroll
      for (int j = 0; j < K; ++j)
#pragma unroll
        for (int c = 0; c < NC; ++c) v[j][c] = flat[j * NC + c];
    } else {
#pragma unroll
      for (int j = 0; j < K; ++j)
#pragma unroll
        for (int c = 0; c < NC; ++c) v[j][c] = 0.0f;
    }
    return any;
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int64_t row = r + j;
    const int g = row < p.rows ? p.gid[row] : -1;
    key[j] = g >= 0 && g < p.groups ? g : -1;
    any |= key[j] >= 0;
#pragma unroll
    for (int c = 0; c < NC; ++c) v[j][c] = key[j] >= 0 ? p.vals[row * NC + c] : 0.0f;
  }
  return any;
}

template <int NC>
__global__ void __launch_bounds__(kThreads, 2) segment_sorted_kernel(const Params p) {
  constexpr int K = rows_per_thread<NC>();
  constexpr int NCA = NC > 0 ? NC : 1;
  __shared__ Smem<NC> sm;
  const int t = threadIdx.x;
  const int64_t c0 = p.chunks * blockIdx.x / gridDim.x;
  const int64_t c1 = p.chunks * (blockIdx.x + 1) / gridDim.x;
  Carry<NC> walk;  // thread 0's
  int unit[K];
#pragma unroll
  for (int j = 0; j < K; ++j) unit[j] = 1;

  int key[K];
  float v[K][NCA];
  bool any = c0 < c1 && load_rows<NC, K>(p, c0, key, v);
  for (int64_t ch = c0; ch < c1; ++ch) {
    if (__syncthreads_and(!any)) {  // every row dropped: one run of key −1
      if (t == 0) {
        Run<NC> none;
        none.key = -1;
        none.cnt = 0;
#pragma unroll
        for (int c = 0; c < NC; ++c) none.s[c] = 0.0;
        walk.push(p, none, none, true);
      }
      if (ch + 1 < c1) any = load_rows<NC, K>(p, ch + 1, key, v);
      continue;
    }
    Run<NC> first, last;
    const bool single = thread_runs<NC, K, float>(p, key, unit, v, first, last);
    // the next chunk's loads fly while the block joins this chunk's runs
    if (ch + 1 < c1) any = load_rows<NC, K>(p, ch + 1, key, v);
    block_runs<NC>(p, sm, first, last, single);
    if (t == 0) walk.push(p, sm.head, sm.tail, sm.whole);
  }

  // this range's first and last run become its two records
  if (t == 0) {
    Run<NC> h = walk.open ? walk.carry : walk.head;
    Run<NC> tl = walk.carry;
    if (walk.open) tl.cnt = 0;  // one run: the tail adds nothing
    const int64_t e = 2 * static_cast<int64_t>(blockIdx.x);
    p.rec_key[e] = h.key;
    p.rec_cnt[e] = h.cnt;
    p.rec_key[e + 1] = tl.key;
    p.rec_cnt[e + 1] = tl.cnt;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      p.rec_sum[e * NC + c] = h.s[c];
      p.rec_sum[(e + 1) * NC + c] = walk.open ? 0.0 : tl.s[c];
    }
    __threadfence();
    sm.last_block = atomicAdd(p.ticket, 1) == static_cast<int>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!sm.last_block) return;
  __threadfence();

  // the last block: every range's records, in block order
  constexpr int K2 = kRecordsPerThread;
  const int64_t n = 2 * static_cast<int64_t>(gridDim.x);
  Carry<NC> all;
  for (int64_t e0 = 0; e0 < n; e0 += static_cast<int64_t>(kThreads) * K2) {
    int key[K2], rcnt[K2];
    double s[K2][NCA];
#pragma unroll
    for (int j = 0; j < K2; ++j) {
      const int64_t e = e0 + static_cast<int64_t>(t) * K2 + j;
      const bool in = e < n;
      key[j] = in ? __ldcg(p.rec_key + e) : -1;
      rcnt[j] = in ? __ldcg(p.rec_cnt + e) : 0;
#pragma unroll
      for (int c = 0; c < NC; ++c) s[j][c] = in ? __ldcg(p.rec_sum + e * NC + c) : 0.0;
    }
    Run<NC> first, last;
    const bool single = thread_runs<NC, K2, double>(p, key, rcnt, s, first, last);
    block_runs<NC>(p, sm, first, last, single);
    if (t == 0) all.push(p, sm.head, sm.tail, sm.whole);
  }
  if (t == 0) {
    if (!all.open) emit(p, all.head);
    emit(p, all.carry);
    *p.ticket = 0;
  }
}

template <int NC>
int launch(const int32_t* gid, const float* vals, int64_t rows, int64_t groups, int32_t* counts,
           float* out, int32_t* ws_int, double* ws_f64, int max_records, cudaStream_t stream) {
  static int blocks_per_sm = 0;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, segment_sorted_kernel<NC>,
                                                  kThreads, 0);
    if (blocks_per_sm < 1) blocks_per_sm = 1;
  }
  const int64_t chunk = static_cast<int64_t>(kThreads) * rows_per_thread<NC>();
  Params p;
  p.gid = gid;
  p.vals = vals;
  p.rows = rows;
  p.groups = groups;
  p.counts = counts;
  p.out = out;
  p.ticket = ws_int;
  p.rec_key = ws_int + 1;
  p.rec_cnt = ws_int + 1 + max_records;
  p.rec_sum = ws_f64;
  p.chunks = (rows + chunk - 1) / chunk;
  p.vec = (reinterpret_cast<uintptr_t>(gid) & 15) == 0 &&
          (NC == 0 || (reinterpret_cast<uintptr_t>(vals) & 15) == 0);
  int64_t grid = static_cast<int64_t>(sms) * blocks_per_sm;
  if (grid > p.chunks) grid = p.chunks;
  if (grid > max_records / 2) grid = max_records / 2;
  segment_sorted_kernel<NC><<<static_cast<int>(grid), kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace segsorted

// counts (G,) int32 or null; out (G, ncols) f32; ws_int: the ticket (0 between
// calls), then two arrays of max_records int32; ws_f64: max_records · ncols.
extern "C" int svc_segment_sorted(const int32_t* gid, const float* vals, int64_t rows,
                                  int ncols, int64_t groups, int32_t* counts, float* out,
                                  int32_t* ws_int, double* ws_f64, int max_records,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ncols < 0 || ncols > segsorted::kMaxCols || max_records < 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (counts != nullptr && groups > 0)
    cudaMemsetAsync(counts, 0, static_cast<size_t>(groups) * sizeof(int32_t), s);
  if (ncols > 0 && groups > 0)
    cudaMemsetAsync(out, 0, static_cast<size_t>(groups) * ncols * sizeof(float), s);
  if (rows == 0 || groups == 0) return static_cast<int>(cudaGetLastError());
  switch (ncols) {
#define SVC_SEGMENT_SORTED_CASE(N) \
  case N:                          \
    return segsorted::launch<N>(gid, vals, rows, groups, counts, out, ws_int, ws_f64, max_records, s);
    SVC_SEGMENT_SORTED_CASE(0)
    SVC_SEGMENT_SORTED_CASE(1)
    SVC_SEGMENT_SORTED_CASE(2)
    SVC_SEGMENT_SORTED_CASE(3)
    SVC_SEGMENT_SORTED_CASE(4)
    SVC_SEGMENT_SORTED_CASE(5)
    SVC_SEGMENT_SORTED_CASE(6)
    SVC_SEGMENT_SORTED_CASE(7)
    SVC_SEGMENT_SORTED_CASE(8)
#undef SVC_SEGMENT_SORTED_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

__global__ void segment_sum_kernel(const int32_t* __restrict__ gid,
                                   const float* __restrict__ vals, int64_t rows, int ncols,
                                   int64_t groups, float* __restrict__ out) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const int64_t n = rows * ncols;
  // warp-aligned grid-stride loop: every lane of a warp takes the same
  // number of steps, so the shuffles below always see the whole warp
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * blockDim.x + (threadIdx.x & ~31);
       base < n; base += stride) {
    // element e = c·rows + i: consecutive lanes, consecutive rows of one column
    const int64_t e = base + lane;
    int64_t key = -1;  // (group, column) of an in-range element, else -1
    float v = 0.0f;
    if (e < n) {
      const int64_t c = e / rows;
      const int64_t i = e - c * rows;
      const int32_t g = gid[i];
      if (g >= 0 && static_cast<int64_t>(g) < groups) {
        key = static_cast<int64_t>(g) * ncols + c;
        v = vals[i * ncols + c];
      }
    }
    const int64_t prev = __shfl_up_sync(full, key, 1);
    const int64_t next = __shfl_down_sync(full, key, 1);
    bool head = lane == 0 || prev != key;  // first lane of its run
    // segmented inclusive scan: v becomes the sum from the run's head to here
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(full, v, off);
      const bool up_head = __shfl_up_sync(full, static_cast<int>(head), off) != 0;
      if (lane >= off && !head) {
        v += up;
        head = up_head;
      }
    }
    if (key >= 0 && (lane == 31 || next != key)) atomicAdd(out + key, v);
  }
}

extern "C" int svc_segment_sum(const int32_t* gid, const float* vals, int64_t rows, int ncols,
                               int64_t groups, float* out, void* stream) {
  const int block = 256;
  const int grid = svc::grid_for(rows * ncols, block);
  segment_sum_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      gid, vals, rows, ncols, groups, out);
  return static_cast<int>(cudaGetLastError());
}
