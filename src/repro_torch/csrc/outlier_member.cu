// Fused η hash-threshold + outlier-index membership (SVC §6.2).
//
// Replaces the Pallas kernel src/repro/kernels/outlier_member/kernel.py:
// outlier_member_tiles (body _outlier_member_kernel) and the XLA digest
// table it is handed (src/repro/kernels/outlier_member/ops.py:
// _sorted_digests).  The TPU version broadcast-compares each row tile
// against the whole (2, Kp) digest table in VMEM and falls back to XLA
// beyond 2048 keys.  Here each thread takes four consecutive probe rows at
// a time (16-byte loads, so enough bytes are in flight), folds every key
// column through one splitmix32 pass that feeds three hashes (η, and the
// hi/lo lanes of the 64-bit digest), and binary-searches the sorted digest
// table.  One kernel serves every K: a table of at most 2048 keys (16 KiB)
// is staged in shared memory per block, one entry per distinct digest (an
// outlier index's sessions repeat hot keys, and a search through a run of
// equal digests costs a step per doubling), with two structures built
// from it:
// a 2^16-bit Bloom filter (two bits per key, from the low 16 bits of each
// digest lane), so a row that is not a member searches with probability
// ~(2K/2^16)^2 — a warp runs a search whenever one lane does, so a
// one-bit filter's 1.5% at K = 1,000 cost more than the rest of the
// kernel — and the first table index of each value of the digest's top
// byte, so a search covers ~K/256 keys.  A larger table is searched whole
// in device memory, where its upper levels stay in L1/L2.
//
// The table is one int64 per key, (hi ^ 2^31)·2^32 + lo, so its signed
// order is the unsigned (hi, lo) order (kernels/outlier_member/ref.py:
// pack_digest).  The pin set that owns the table builds it once
// (core/outliers.PinSet), not once per probe, and three entries build it:
//
//   svc_outlier_pin_table — a pin's whole table in one launch over its key
//     arena (1.5M slots on visitView, ~100 of them valid).  Each lane
//     reads 16 validity bytes a load, each warp appends its valid slots'
//     digests with one atomicAdd and notes whether it saw an invalid
//     slot; the last block to arrive (a ticket, as in corr_diff.cu)
//     appends the all-SENTINEL tuple's digest once if any slot was
//     invalid, sorts the entries in shared memory and writes the table and its length, the length into mapped
//     host memory so that the host's one wait reads it.  Sorting makes the
//     table independent of the order of the appends.  It holds at most
//     kSmemKeys entries; past that the length alone says so and the
//     wrapper composes the table as before.  Bound: the arena's validity
//     read once and the valid slots' keys, so the bytes the arena holds,
//     not the table's sort.
//   svc_outlier_digest_sorted — K ≤ kSmemKeys key tuples digested and
//     sorted by one block: the same table as svc_outlier_digest and a sort.
//   svc_outlier_digest — K key tuples' digests, unsorted; the wrapper
//     sorts them (torch.sort).  The route past kSmemKeys.
//
// The in-block sort is a bitonic sort over the next power of two, padded
// with the largest digest, as the JAX package pads its table
// (src/repro/kernels/outlier_member/ops.py:_bsearch_member).
//
// Two probe entries: svc_outlier_member writes int32 codes (bit 0 keep =
// η ∨ member, bit 1 member); svc_outlier_pinned reads the relation's
// validity too and writes what the pinned hash needs in the same pass —
// the narrowed validity valid ∧ (η ∨ member) and the `__outlier` int8 flag
// member ∧ valid.  A row whose first key is SENTINEL_KEY, or that is
// invalid, is never a member.
//
// Bound: device memory for the probe stream (4 bytes per key column and 1
// byte of validity in, 2 bytes out per row, or 4 bytes of code); the
// log2 K search steps hit shared memory or cache.
#include "svc_common.cuh"

namespace {

constexpr int64_t kSmemKeys = 2048;
constexpr int kFilterWords = (1 << 16) / 32;  // one bit per value of a lane's low 16 bits
constexpr int kBuckets = 256;                 // the digest's top byte
constexpr int kProbeThreads = 1024;
constexpr int kProbeBlocksPerSm = 2;  // resident: ≤ 32 registers a thread
constexpr int kProbeGridPerSm = 4;
constexpr int64_t kMaxDigest = 0x7FFFFFFFFFFFFFFFll;  // pack_digest(~0u, ~0u)
constexpr int kSortThreads = 1024;  // the one block of svc_outlier_digest_sorted
constexpr int kPinThreads = 256;
constexpr int kPinUnroll = 2;       // 16-byte validity loads a lane has in flight
constexpr int kPinBlocksPerSm = 2;

__device__ __forceinline__ int64_t pack_digest(uint32_t hi, uint32_t lo) {
  return static_cast<int64_t>((static_cast<uint64_t>(hi ^ 0x80000000u) << 32) | lo);
}

// the top byte of a digest in the unsigned (hi, lo) order
__device__ __forceinline__ int bucket_of(int64_t d) {
  return static_cast<int>((static_cast<uint64_t>(d) ^ 0x8000000000000000ull) >> 56);
}

__device__ __forceinline__ bool filter_has(const uint32_t* filter, uint32_t f) {
  return (filter[(f & 0xFFFFu) >> 5] >> (f & 31u)) & 1u;
}

__device__ __forceinline__ bool digest_member(const int64_t* table, int64_t a, int64_t b,
                                              int64_t d) {
  const int64_t k = b;  // first index in [a, b) whose digest ≥ d
  while (a < b) {
    const int64_t mid = (a + b) >> 1;
    if (table[mid] < d) {
      a = mid + 1;
    } else {
      b = mid;
    }
  }
  return a < k && table[a] == d;
}

// the packed 64-bit digest of row i's N key values
template <int N>
__device__ __forceinline__ int64_t digest_row(const svc::KeyCols& cols, int64_t i,
                                              uint32_t seed_hi, uint32_t seed_lo) {
  uint32_t hh = seed_hi, hl = seed_lo;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const uint32_t mc = svc::splitmix32(static_cast<uint32_t>(i < 0 ? svc::SENTINEL_KEY
                                                                    : cols.c[j][i]));
    hh = svc::splitmix32(hh ^ mc);
    hl = svc::splitmix32(hl ^ mc);
  }
  return pack_digest(hh, hl);
}

template <int N>
__global__ void outlier_digest_kernel(svc::KeyCols cols, int64_t k, uint32_t seed_hi,
                                      uint32_t seed_lo, int64_t* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < k;
       i += stride) {
    out[i] = digest_row<N>(cols, i, seed_hi, seed_lo);
  }
}

// Sort s[0, n) (n ≤ kSmemKeys) ascending in shared memory with every
// thread of the block, then write it to out[0, n): a bitonic sort over the
// next power of two, the tail padded with the largest digest.  The caller
// has written s[0, n); the first barrier publishes it.
__device__ void block_sort_store(int64_t* s, int n, int64_t* __restrict__ out) {
  int p = 1;
  while (p < n) p <<= 1;
  for (int i = n + threadIdx.x; i < p; i += blockDim.x) s[i] = kMaxDigest;
  __syncthreads();
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < p; i += blockDim.x) {
        const int l = i ^ j;
        if (l > i) {
          const int64_t a = s[i], b = s[l];
          if ((a > b) == ((i & k) == 0)) {
            s[i] = b;
            s[l] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = s[i];
}

// K ≤ kSmemKeys key tuples: digest, sort and write the table, one block.
template <int N>
__global__ void __launch_bounds__(kSortThreads)
outlier_digest_sorted_kernel(svc::KeyCols cols, int k, uint32_t seed_hi, uint32_t seed_lo,
                             int64_t* __restrict__ out) {
  __shared__ int64_t s[kSmemKeys];
  for (int i = threadIdx.x; i < k; i += blockDim.x) s[i] = digest_row<N>(cols, i, seed_hi, seed_lo);
  block_sort_store(s, k, out);
}

// The pin table's workspace (per card and stream; zero between launches).
struct PinWs {
  unsigned long long* count;  // valid slots appended
  unsigned int* invalid;      // 1 once any block saw an invalid slot
  unsigned int* ticket;       // blocks arrived
};

// The nonzero bytes of v as 16 bits, byte b to bit b: __vcmpne4 sets
// each nonzero byte of a word to 0xFF, the mask keeps its low bit, and the
// multiply moves bits 0, 8, 16 and 24 to bits 21 to 24 (the partial
// products land on distinct bits, so nothing carries).
__device__ __forceinline__ uint32_t nonzero_bytes(uint4 v) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  uint32_t bits = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const uint32_t m = __vcmpne4(w[r], 0u) & 0x01010101u;
    bits |= (((m * 0x00204081u) >> 21) & 0xFu) << (4 * r);
  }
  return bits;
}

// Append the digests of this lane's valid slots (slot first + b for each
// set bit b of `bits`) with one atomicAdd a warp, placed by a warp scan of
// the lanes' counts; entries past kSmemKeys are counted, not written.
// Called by whole warps; returns whether this lane wrote an entry.
template <int N>
__device__ __forceinline__ bool append_slots(uint32_t bits, int64_t first,
                                             const svc::KeyCols& cols, uint32_t seed_hi,
                                             uint32_t seed_lo, int64_t* __restrict__ table,
                                             unsigned long long* count) {
  const unsigned full = 0xFFFFFFFFu;
  const int lane = threadIdx.x & 31;
  const int c = __popc(bits);
  int incl = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(full, incl, o);
    if (lane >= o) incl += y;
  }
  unsigned long long at = 0;
  if (lane == 31) at = atomicAdd(count, static_cast<unsigned long long>(incl));
  at = __shfl_sync(full, at, 31) + static_cast<unsigned long long>(incl - c);
  bool wrote = false;
  for (; bits != 0u; bits &= bits - 1u, ++at) {
    if (at < static_cast<unsigned long long>(kSmemKeys)) {
      table[at] = digest_row<N>(cols, first + __ffs(bits) - 1, seed_hi, seed_lo);
      wrote = true;
    }
  }
  return wrote;
}

// Each lane reads 16 validity bytes a load (one uint4; with `vec`, the
// validity 16-byte aligned), kPinUnroll loads in flight, so a warp's step
// covers kPinUnroll runs of 512 consecutive slots; a warp whose slots are
// all invalid (nearly every warp of a pin arena) only ballots.  The slots
// past the last whole 16, and every slot without `vec`, go one a lane.
// Loops and appends stay warp-uniform.  The lanes that wrote an entry or
// the invalid flag fence their writes, and one thread a block fences
// before it takes the block's ticket (as corr_diff.cu does).  Each block
// reserves the last block's 16 KiB of shared memory; at most
// kPinBlocksPerSm blocks of kPinThreads share an SM, so that limits no
// residency.
template <int N>
__global__ void __launch_bounds__(kPinThreads)
outlier_pin_table_kernel(svc::KeyCols cols, const uint8_t* __restrict__ valid, int64_t n,
                         bool vec, uint32_t seed_hi, uint32_t seed_lo,
                         int64_t* __restrict__ table, PinWs ws, int64_t* length) {
  __shared__ int64_t s[kSmemKeys];
  __shared__ int last;
  __shared__ unsigned long long total_count;
  __shared__ unsigned int saw_invalid;
  const unsigned full = 0xFFFFFFFFu;
  const int lane = threadIdx.x & 31;
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int64_t warps = static_cast<int64_t>(gridDim.x) * (blockDim.x >> 5);
  bool invalid = false, wrote = false;
  const int64_t quads = vec ? n / 16 : 0;
  const uint4* v4 = reinterpret_cast<const uint4*>(valid);
  for (int64_t base = warp * 32 * kPinUnroll; base < quads; base += warps * 32 * kPinUnroll) {
    uint4 v[kPinUnroll];
#pragma unroll
    for (int u = 0; u < kPinUnroll; ++u) {
      const int64_t q = base + u * 32 + lane;
      v[u] = q < quads ? v4[q] : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kPinUnroll; ++u) {
      const int64_t q = base + u * 32 + lane;
      const uint32_t bits = nonzero_bytes(v[u]);
      invalid |= q < quads && bits != 0xFFFFu;
      if (__any_sync(full, bits != 0u)) {
        wrote |= append_slots<N>(bits, 16 * q, cols, seed_hi, seed_lo, table, ws.count);
      }
    }
  }
  for (int64_t base = 16 * quads + warp * 32; base < n; base += warps * 32) {
    const int64_t i = base + lane;
    const bool ok = i < n && valid[i] != 0;
    invalid |= i < n && !ok;
    if (__any_sync(full, ok)) {
      wrote |= append_slots<N>(ok ? 1u : 0u, i, cols, seed_hi, seed_lo, table, ws.count);
    }
  }
  if (__any_sync(full, invalid) && lane == 0) {
    atomicOr(ws.invalid, 1u);
    wrote = true;
  }
  if (wrote) __threadfence();
  // the last block to arrive finishes the table
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(ws.ticket, 1u) == gridDim.x - 1;
    if (last) {
      __threadfence();
      total_count = atomicAdd(ws.count, 0ull);
      saw_invalid = atomicAdd(ws.invalid, 0u);
      *ws.count = 0ull;  // the workspace is zero again for the next launch
      *ws.invalid = 0u;
      *ws.ticket = 0u;
    }
  }
  __syncthreads();
  if (!last) return;
  const unsigned long long total = total_count + saw_invalid;
  if (threadIdx.x == 0) *length = static_cast<int64_t>(total);
  if (total > static_cast<unsigned long long>(kSmemKeys)) return;  // the wrapper composes
  const int count = static_cast<int>(total_count);
  for (int i = threadIdx.x; i < count; i += blockDim.x) s[i] = __ldcg(table + i);
  if (saw_invalid && threadIdx.x == 0) s[count] = digest_row<N>(cols, -1, seed_hi, seed_lo);
  block_sort_store(s, static_cast<int>(total), table);
}

// bit 0 keep (η ∨ member), bit 1 member, for one row's N key values
template <int N, bool SMEM>
__device__ __forceinline__ uint32_t row_code(const int32_t (&key)[N], const int64_t* table,
                                             int64_t k, const uint32_t* filter,
                                             const int32_t* bucket,
                                             uint32_t seed_eta, uint32_t seed_hi,
                                             uint32_t seed_lo, float thresh) {
  uint32_t he = seed_eta, hh = seed_hi, hl = seed_lo;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const uint32_t mc = svc::splitmix32(static_cast<uint32_t>(key[j]));
    he = svc::splitmix32(he ^ mc);
    hh = svc::splitmix32(hh ^ mc);
    hl = svc::splitmix32(hl ^ mc);
  }
  const bool eta = svc::u01(he) < thresh;
  bool member = key[0] != svc::SENTINEL_KEY;
  if (SMEM) {
    member = member && filter_has(filter, hl) && filter_has(filter, hh);
    if (member) {
      const int64_t d = pack_digest(hh, hl);
      const int b = bucket_of(d);
      member = digest_member(table, bucket[b], bucket[b + 1], d);
    }
  } else {
    member = member && digest_member(table, 0, k, pack_digest(hh, hl));
  }
  return static_cast<uint32_t>(eta || member) | (static_cast<uint32_t>(member) << 1);
}

// PINNED: read `valid`, write out_valid / out_flag; else write codes.
// With `vec` (every column 16-byte aligned, the byte arrays 4-byte
// aligned) a thread takes four consecutive rows per step with 16-byte
// loads, so more bytes are in flight; the rows past a multiple of four,
// and every row without `vec`, go one a thread.
template <int N, bool SMEM, bool PINNED>
__global__ void __launch_bounds__(kProbeThreads, kProbeBlocksPerSm)
outlier_probe_kernel(svc::KeyCols cols, const uint8_t* __restrict__ valid, int64_t rows,
                     bool vec, const int64_t* __restrict__ table, int64_t k, uint32_t seed_eta,
                     uint32_t seed_hi, uint32_t seed_lo, float thresh,
                     int32_t* __restrict__ codes, uint8_t* __restrict__ out_valid,
                     int8_t* __restrict__ out_flag) {
  extern __shared__ int64_t staged[];
  uint32_t* filter = reinterpret_cast<uint32_t*>(staged + k);
  int32_t* bucket = reinterpret_cast<int32_t*>(filter + kFilterWords);
  const int64_t* t = table;
  int64_t ku = k;  // distinct digests staged
  if (SMEM) {
    // stage the first digest of each run of equal ones (an index's keys
    // repeat: its sessions share hot videos), two a thread, placed by a
    // block-wide exclusive scan; blockDim.x == kProbeThreads, k ≤ 2·that
    __shared__ int warp_sums[kProbeThreads / 32];
    for (int j = threadIdx.x; j < kFilterWords; j += blockDim.x) filter[j] = 0u;
    const int64_t j0 = 2 * static_cast<int64_t>(threadIdx.x);
    const int64_t d0 = j0 < k ? table[j0] : 0;
    const int64_t d1 = j0 + 1 < k ? table[j0 + 1] : 0;
    const int first0 = j0 < k && (j0 == 0 || table[j0 - 1] != d0);
    const int first1 = j0 + 1 < k && d1 != d0;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int incl = first0 + first1;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xFFFFFFFFu, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < kProbeThreads / 32; ++w) {
      before += w < warp ? warp_sums[w] : 0;
      total += warp_sums[w];
    }
    const int at = before + incl - first0 - first1;
    if (first0) staged[at] = d0;
    if (first1) staged[at + first0] = d1;
    ku = total;
    __syncthreads();
    for (int64_t j = threadIdx.x; j < ku; j += blockDim.x) {
      const int64_t d = staged[j];
      const uint32_t lo = static_cast<uint32_t>(d);
      const uint32_t hi = static_cast<uint32_t>(static_cast<uint64_t>(d) >> 32) ^ 0x80000000u;
      atomicOr(&filter[(lo & 0xFFFFu) >> 5], 1u << (lo & 31u));
      atomicOr(&filter[(hi & 0xFFFFu) >> 5], 1u << (hi & 31u));
    }
    for (int b = threadIdx.x; b <= kBuckets; b += blockDim.x) {
      int lo = 0, hi = static_cast<int>(ku);  // first index whose top byte ≥ b
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (bucket_of(staged[mid]) < b) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      bucket[b] = lo;
    }
    __syncthreads();
    t = staged;
  }
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t quads = vec ? rows / 4 : 0;
  for (int64_t q = first; q < quads; q += stride) {
    int4 c[N];
#pragma unroll
    for (int j = 0; j < N; ++j) c[j] = reinterpret_cast<const int4*>(cols.c[j])[q];
    const uint32_t ok = PINNED ? reinterpret_cast<const uint32_t*>(valid)[q] : 0x01010101u;
    uint32_t code[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      int32_t key[N];
#pragma unroll
      for (int j = 0; j < N; ++j) key[j] = reinterpret_cast<const int32_t*>(&c[j])[r];
      code[r] = ((ok >> (8 * r)) & 0xFFu) != 0u
                    ? row_code<N, SMEM>(key, t, ku, filter, bucket, seed_eta, seed_hi, seed_lo,
                                        thresh)
                    : 0u;
    }
    if (PINNED) {
      uint32_t keep = 0, member = 0;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        keep |= (code[r] != 0u ? 1u : 0u) << (8 * r);  // η ∨ member
        member |= (code[r] >> 1) << (8 * r);
      }
      reinterpret_cast<uint32_t*>(out_valid)[q] = keep;
      reinterpret_cast<uint32_t*>(out_flag)[q] = member;
    } else {
      reinterpret_cast<int4*>(codes)[q] = make_int4(code[0], code[1], code[2], code[3]);
    }
  }
  for (int64_t i = 4 * quads + first; i < rows; i += stride) {
    if (PINNED && valid[i] == 0) {
      out_valid[i] = 0;
      out_flag[i] = 0;
      continue;
    }
    int32_t key[N];
#pragma unroll
    for (int j = 0; j < N; ++j) key[j] = cols.c[j][i];
    const uint32_t code =
        row_code<N, SMEM>(key, t, ku, filter, bucket, seed_eta, seed_hi, seed_lo, thresh);
    if (PINNED) {
      out_valid[i] = code != 0u ? 1 : 0;
      out_flag[i] = static_cast<int8_t>(code >> 1);
    } else {
      codes[i] = static_cast<int32_t>(code);
    }
  }
}

struct Probe {
  svc::KeyCols cols;
  const uint8_t* valid;
  int64_t rows;
  bool vec;
  const int64_t* table;
  int64_t k;
  uint32_t se, sh, sl;
  float thresh;
  int32_t* codes;
  uint8_t* out_valid;
  int8_t* out_flag;
};

template <int N, bool PINNED>
void launch_probe(const Probe& p, cudaStream_t s) {
  const int block = kProbeThreads;
  const int64_t want = (p.rows + 4 * block - 1) / (4 * block);
  const int grid = static_cast<int>(want < 1 ? 1 : (want < 132 * kProbeGridPerSm
                                                     ? want : 132 * kProbeGridPerSm));
  if (p.k <= kSmemKeys) {
    const size_t bytes = static_cast<size_t>(p.k) * sizeof(int64_t) +
                         kFilterWords * sizeof(uint32_t) + (kBuckets + 1) * sizeof(int32_t);
    outlier_probe_kernel<N, true, PINNED><<<grid, block, bytes, s>>>(
        p.cols, p.valid, p.rows, p.vec, p.table, p.k, p.se, p.sh, p.sl, p.thresh, p.codes,
        p.out_valid, p.out_flag);
  } else {
    outlier_probe_kernel<N, false, PINNED><<<grid, block, 0, s>>>(
        p.cols, p.valid, p.rows, p.vec, p.table, p.k, p.se, p.sh, p.sl, p.thresh, p.codes,
        p.out_valid, p.out_flag);
  }
}

template <bool PINNED>
int probe(int ncols, Probe p, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uintptr_t wide = 0, narrow = reinterpret_cast<uintptr_t>(p.valid) |
                               reinterpret_cast<uintptr_t>(p.out_valid) |
                               reinterpret_cast<uintptr_t>(p.out_flag);
  for (int j = 0; j < ncols && j < 4; ++j) wide |= reinterpret_cast<uintptr_t>(p.cols.c[j]);
  wide |= reinterpret_cast<uintptr_t>(p.codes);
  p.vec = (wide & 15) == 0 && (narrow & 3) == 0;
  switch (ncols) {
    case 1: launch_probe<1, PINNED>(p, s); break;
    case 2: launch_probe<2, PINNED>(p, s); break;
    case 3: launch_probe<3, PINNED>(p, s); break;
    case 4: launch_probe<4, PINNED>(p, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The K index key tuples' packed digests, unsorted.
extern "C" int svc_outlier_digest(const int32_t* c0, const int32_t* c1, const int32_t* c2,
                                  const int32_t* c3, int ncols, int64_t k, uint32_t seed_hi,
                                  uint32_t seed_lo, int64_t* out, void* stream) {
  svc::KeyCols cols{{c0, c1, c2, c3}};
  const int block = 256;
  const int grid = svc::grid_for(k, block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ncols) {
    case 1: outlier_digest_kernel<1><<<grid, block, 0, s>>>(cols, k, seed_hi, seed_lo, out); break;
    case 2: outlier_digest_kernel<2><<<grid, block, 0, s>>>(cols, k, seed_hi, seed_lo, out); break;
    case 3: outlier_digest_kernel<3><<<grid, block, 0, s>>>(cols, k, seed_hi, seed_lo, out); break;
    case 4: outlier_digest_kernel<4><<<grid, block, 0, s>>>(cols, k, seed_hi, seed_lo, out); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The K ≤ 2048 index key tuples' packed digests, sorted, in one launch.
extern "C" int svc_outlier_digest_sorted(const int32_t* c0, const int32_t* c1,
                                         const int32_t* c2, const int32_t* c3, int ncols,
                                         int64_t k, uint32_t seed_hi, uint32_t seed_lo,
                                         int64_t* out, void* stream) {
  if (k < 0 || k > kSmemKeys) return static_cast<int>(cudaErrorInvalidValue);
  svc::KeyCols cols{{c0, c1, c2, c3}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kk = static_cast<int>(k);
  switch (ncols) {
    case 1: outlier_digest_sorted_kernel<1><<<1, kSortThreads, 0, s>>>(cols, kk, seed_hi, seed_lo, out); break;
    case 2: outlier_digest_sorted_kernel<2><<<1, kSortThreads, 0, s>>>(cols, kk, seed_hi, seed_lo, out); break;
    case 3: outlier_digest_sorted_kernel<3><<<1, kSortThreads, 0, s>>>(cols, kk, seed_hi, seed_lo, out); break;
    case 4: outlier_digest_sorted_kernel<4><<<1, kSortThreads, 0, s>>>(cols, kk, seed_hi, seed_lo, out); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// A pin's sorted digest table over its n-slot key arena, in one launch:
// table (kSmemKeys int64) receives the sorted table, *length (mapped host
// memory) its length, which exceeds kSmemKeys when the table did not fit
// (the table is then not written).  valid: the slots' validity.  ws: two
// uint64 words and two uint32 words of the wrapper's per-(card, stream)
// workspace, zeroed once; every launch leaves them at 0.
extern "C" int svc_outlier_pin_table(const int32_t* c0, const int32_t* c1, const int32_t* c2,
                                     const int32_t* c3, int ncols, const uint8_t* valid,
                                     int64_t n, uint32_t seed_hi, uint32_t seed_lo,
                                     int64_t* table, void* ws, int64_t* length, int sms,
                                     void* stream) {
  if (n <= 0 || sms <= 0 || valid == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  svc::KeyCols cols{{c0, c1, c2, c3}};
  unsigned long long* w = static_cast<unsigned long long*>(ws);
  const PinWs p{w, reinterpret_cast<unsigned int*>(w + 1),
                reinterpret_cast<unsigned int*>(w + 1) + 1};
  const bool vec = (reinterpret_cast<uintptr_t>(valid) & 15) == 0;
  const int64_t per_block = static_cast<int64_t>(kPinThreads) * (vec ? 16 * kPinUnroll : 1);
  const int64_t want = (n + per_block - 1) / per_block;
  const int grid = static_cast<int>(want < sms * kPinBlocksPerSm ? want : sms * kPinBlocksPerSm);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ncols) {
    case 1: outlier_pin_table_kernel<1><<<grid, kPinThreads, 0, s>>>(cols, valid, n, vec, seed_hi, seed_lo, table, p, length); break;
    case 2: outlier_pin_table_kernel<2><<<grid, kPinThreads, 0, s>>>(cols, valid, n, vec, seed_hi, seed_lo, table, p, length); break;
    case 3: outlier_pin_table_kernel<3><<<grid, kPinThreads, 0, s>>>(cols, valid, n, vec, seed_hi, seed_lo, table, p, length); break;
    case 4: outlier_pin_table_kernel<4><<<grid, kPinThreads, 0, s>>>(cols, valid, n, vec, seed_hi, seed_lo, table, p, length); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// int32 codes per probe row against a sorted digest table.
extern "C" int svc_outlier_member(const int32_t* c0, const int32_t* c1, const int32_t* c2,
                                  const int32_t* c3, int ncols, int64_t rows,
                                  const int64_t* table, int64_t k, uint32_t seed_eta,
                                  uint32_t seed_hi, uint32_t seed_lo, float thresh, int32_t* out,
                                  void* stream) {
  const Probe p{{{c0, c1, c2, c3}}, nullptr, rows, false, table, k, seed_eta, seed_hi, seed_lo,
                thresh, out, nullptr, nullptr};
  return probe<false>(ncols, p, stream);
}

// The pinned hash: narrowed validity and the `__outlier` flag per row.
extern "C" int svc_outlier_pinned(const int32_t* c0, const int32_t* c1, const int32_t* c2,
                                  const int32_t* c3, int ncols, const uint8_t* valid,
                                  int64_t rows, const int64_t* table, int64_t k,
                                  uint32_t seed_eta, uint32_t seed_hi, uint32_t seed_lo,
                                  float thresh, uint8_t* out_valid, int8_t* out_flag,
                                  void* stream) {
  const Probe p{{{c0, c1, c2, c3}}, valid, rows, false, table, k, seed_eta, seed_hi, seed_lo,
                thresh, nullptr, out_valid, out_flag};
  return probe<true>(ncols, p, stream);
}
