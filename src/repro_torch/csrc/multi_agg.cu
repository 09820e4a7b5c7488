// Batched multi-query moment pass: one scan of the sample panel answers Q
// sum/count/avg queries (SVC §5, the batched query engine).
//
// Replaces the Pallas kernels src/repro/kernels/multi_agg/kernel.py:
// multi_agg_tiles_two (two-sided: clean ∥ stale ∥ diff) and
// multi_agg_tiles_one (one-sided).  The TPU version selects each query's
// value and predicate columns with one-hot matmuls on the MXU and carries a
// (16, Q) accumulator across the sequential row grid.  Here the query batch
// hands over each one-hot selector as a column index (−1 for an all-zero
// selector, read as 0.0), decoded once on the host, and one launch does the
// rest:
//
//   K/S/SS/HT per side — count, Σt, Σt², Σ(1−π)t² of the §5.2.1 trans
//   value t; and of the diff d = t_new − t_old: K_D (joined valid rows,
//   query independent), Σd, Σd², HT_D = Σ min(1−π_new, 1−π_old)·d².
//
// Design.  A persistent grid (two blocks an SM) walks tiles of kTile rows
// through a ring of kStages tiles in shared memory, filled with cp.async so
// that up to two tiles are in flight while one is reduced, with one barrier
// a step: valid, w and 1−π as 16-byte copies, x as 4-byte copies that
// transpose the row-major (R, C) panel into columns, padded so that a warp
// reading one column across 32 rows meets no bank conflict.  Two constant
// columns (zeros, ones) follow the C data columns, so an all-zero selector
// and a count's value are plain column reads.  Every row is read from device
// memory once for all the queries of a launch's query chunk (16; blockIdx.y
// takes the next 16 when Q is larger).
//
// Each warp owns QG queries of the chunk (query q ≡ warp mod 8) and keeps
// their selectors and bounds in registers, loaded once per block: the four
// bounds of a predicate term become one closed interval [lo, hi] (tv > gt ⟺
// tv ≥ nextafter(gt, +∞) in float32, NaN bounds never pass), unused
// predicate slots that every row passes are dropped, and terms past the
// first PM sit in a shared table.  The warp's lanes take the tile's rows,
// eight a lane, unrolled at fixed offsets from one address a column, with
// the predicate tests specialised on the most terms a query of the warp has.
//
// The engine's panels keep their valid rows in front (a sample's arena, an
// outer join's output), and a row invalid on both sides adds nothing, so a
// full tile without a valid row is staged but not reduced.
//
// The reference selects with a product x · sel, so a row with an inf or NaN
// in any column reads NaN (inf · 0) for every other column.  The barrier
// that publishes a tile also says whether any staged x is non-finite; such a
// tile (none of chip_smoke.py's panels has one) takes that rule row by row.
//
// Precision.  A lane sums at most kFold · kTile / 32 = 32 rows in float32,
// then adds those sums into float64 carries kept in shared memory: the
// serial float32 run stays 32 adds long whatever R is (a relative error of
// at most ~2e-6), and the float64 carry does not grow with the tiles a block
// takes.  Counts are integers.  A block reduces its lanes with a fixed
// xor-shuffle tree and writes float64 partials; the last block of each group
// of 16 to arrive (a __threadfence, then an atomic ticket) sums its group's
// in block order, and the last group sums the groups' in group order,
// resetting the tickets: one launch gives the same bits every run, with no
// float atomics, and no single block reads every partial.  The tickets and
// partials live in a persistent per-device workspace (ops.py).
//
// Bound: ~40 instructions per row and query two-sided (2 × (a value read,
// ≤ P interval tests, t, 4 moments), the diff's 5, a share of the row's
// loads), so at the query engine's 16 queries instruction issue and
// shared-memory reads, not the 21 bytes a row of each side moves, set the
// time; PERF.md §6 has the measured split.
#include <cfloat>
#include <cmath>
#include <type_traits>

#include "svc_common.cuh"

namespace multi_agg {

constexpr int kMoments = 12;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 256;               // rows a block stages per step
constexpr int kStages = 3;               // tiles of the ring
constexpr int kFold = 4;                 // tiles a lane sums in float32 before float64
constexpr int kGroup = 16;               // blocks whose partials one block sums first
constexpr int kMaxSmem = 200 * 1024;     // dynamic shared memory a block may ask for
constexpr int kPm = 9 * kTile;           // byte offset of x in a side's staged tile

struct Side {
  const float* x;        // (R, C) row-major panel
  const uint8_t* valid;  // (R,) bool
  const float* w;        // (R,) 1/π weights
  const float* ompi;     // (R,) 1−π factors
};

struct Params {
  Side side[2];
  int64_t rows;
  int ncols;               // C
  int ld;                  // shared-memory stride of one staged column
  int side_bytes;          // bytes of one side's staged tile
  const int32_t* sel_idx;  // (1+P, Q) column indices, −1: all-zero selector
  const float* meta;       // (2+4P, Q) [is_count; is_avg; (ge, gt, le, lt) per term]
  int npred;               // P
  int nq;                  // Q
  int chunk;               // queries per grid row: kWarps · QG
  double* partials;        // (12, Q, gridDim.x) by block, then (12, Q, groups) by group
  int* tickets;            // (gridDim.y, groups + 1), 0 between launches
  float* out;              // (12, Q)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// all but the newest kStages − 2 groups of copies have landed: at the top
// of a step, the tile it reduces
__device__ __forceinline__ void cp_wait_ring() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}

// Σ src[0 .. n) in index order, kGroup loads in flight at a time
__device__ __forceinline__ double sum_in_order(const double* src, int n) {
  double s = 0.0;
  for (int b0 = 0; b0 < n; b0 += kGroup) {
    double v[kGroup];
#pragma unroll
    for (int b = 0; b < kGroup; ++b) v[b] = b0 + b < n ? __ldcg(src + b0 + b) : 0.0;
#pragma unroll
    for (int b = 0; b < kGroup; ++b) s += v[b];
  }
  return s;
}

// rows of tile t: kTile, fewer in the last
__device__ __forceinline__ int tile_rows(int64_t rows, int64_t t) {
  const int64_t left = rows - t * kTile;
  return left < kTile ? static_cast<int>(left) : kTile;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// tv ≥ ge ∧ tv > gt ⟺ tv ≥ lo, and tv ≤ le ∧ tv < lt ⟺ tv ≤ hi, for every
// float32 tv (NaN tv passes neither side); a NaN bound never passes.
__device__ __forceinline__ float lower_bound(float ge, float gt) {
  if (isnan(ge) || isnan(gt) || gt == INFINITY) return NAN;
  return fmaxf(ge, gt == -INFINITY ? -FLT_MAX : nextafterf(gt, INFINITY));
}

__device__ __forceinline__ float upper_bound(float le, float lt) {
  if (isnan(le) || isnan(lt) || lt == -INFINITY) return NAN;
  return fminf(le, lt == INFINITY ? FLT_MAX : nextafterf(lt, -INFINITY));
}

// One query's selectors in registers: the value column's offset in a staged
// side, the op, and the first PM predicate terms (offset, lo, hi).
template <int PM>
struct Query {
  int voff;
  int np;        // predicate terms kept (the rest of P passed every row)
  int slot;      // the query's row in the shared table of terms
  bool avg;
  bool active;
  bool count;    // value 1, not a column (no one-hot product)
  bool dropped;  // a zero-column term was dropped (it fails rows with a non-finite x)
  int poff[PM];
  float lo[PM], hi[PM];
};

// A lane's registers for one query: float32 sums over up to kFold tiles
// (their float64 carries live in shared memory, `carry`), indexed 0 S_NEW,
// 1 SS_NEW, 2 HT_NEW, 3 S_OLD, 4 SS_OLD, 5 HT_OLD, 6 S_D, 7 SS_D, 8 HT_D.
struct Acc {
  float tile[9];
  int kn, ko;  // rows that pass (the count of an avg query)
};

// Stage tile rows [r0, r0 + n) of every side into `buf`.
template <int S>
__device__ __forceinline__ void stage(const Params& p, uint8_t* buf, int64_t r0, int n,
                                      int row0, int col0, int drow, int dcol) {
  const int tid = threadIdx.x;
  const int C = p.ncols;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const Side& sd = p.side[s];
    uint8_t* base = buf + s * p.side_bytes;
    float* W = reinterpret_cast<float*>(base);
    float* O = W + kTile;
    uint8_t* V = base + 8 * kTile;
    float* X = reinterpret_cast<float*>(base + kPm);
    const float* w = sd.w + r0;
    const float* o = sd.ompi + r0;
    const uint8_t* v = sd.valid + r0;
    if (n == kTile && aligned16(w) && aligned16(o) && aligned16(v)) {
      // kTile / 4 chunks of w, as many of 1−π, kTile / 16 of valid
      constexpr int kW = kTile / 4, kV = kTile / 16;
      for (int i = tid; i < 2 * kW + kV; i += kThreads) {
        if (i < kW) cp16(W + 4 * i, w + 4 * i);
        else if (i < 2 * kW) cp16(O + 4 * (i - kW), o + 4 * (i - kW));
        else cp16(V + 16 * (i - 2 * kW), v + 16 * (i - 2 * kW));
      }
    } else {
      for (int i = tid; i < n; i += kThreads) {
        cp4(W + i, w + i);
        cp4(O + i, o + i);
        V[i] = v[i];
      }
    }
    // x: element e = tid + k·kThreads of the flat tile is (row, col) =
    // (e / C, e % C), stepped without a division
    const float* x = sd.x + r0 * C;
    const int total = n * C;
    int row = row0, col = col0;
    for (int e = tid; e < total; e += kThreads) {
      cp4(X + col * p.ld + row, x + e);
      row += drow;
      col += dcol;
      if (col >= C) {
        col -= C;
        ++row;
      }
    }
  }
}

// The one-hot product x · sel of the reference: x[j] exactly when every
// other column of the row is finite; an inf or NaN elsewhere in the row
// makes it NaN (inf · 0).  nf counts the row's non-finite columns (2: two
// or more); the zero column j = C reads 0 · x.
__device__ __forceinline__ float one_hot(float xv, int nf) {
  return (nf == 0 || (nf == 1 && !isfinite(xv))) ? xv : __int_as_float(0x7fc00000);
}

// Whether a row passes query q's conjunction.  On a clean row (every x
// finite) the first NP ≤ PM terms are tested without a branch — NP is the
// most terms any query of the warp has — and a query with fewer has its
// spare slots read the zero column against (−∞, +∞).
// Whether any x element this thread staged for the tile in `buf` is inf
// or NaN (a thread sees its own cp.async writes after its wait).
template <int S>
__device__ __forceinline__ bool staged_nonfinite(const Params& p, const uint8_t* buf, int n,
                                                 int row0, int col0, int drow, int dcol) {
  const int C = p.ncols;
  bool bad = false;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float* X = reinterpret_cast<const float*>(buf + s * p.side_bytes + kPm);
    int row = row0, col = col0;
    for (int e = threadIdx.x; e < n * C; e += kThreads) {
      bad |= !isfinite(X[col * p.ld + row]);
      row += drow;
      col += dcol;
      if (col >= C) {
        col -= C;
        ++row;
      }
    }
  }
  return bad;
}

template <int PM, bool TAIL, bool DIRTY, int NP>
__device__ __forceinline__ bool passes(const Query<PM>& q, const float* X, int r, bool valid,
                                       int nf, const int* t_off, const float* t_lo,
                                       const float* t_hi, int npred) {
  bool c = valid;
  if (DIRTY && q.dropped && nf != 0) c = false;
#pragma unroll
  for (int k = 0; k < (DIRTY ? PM : NP); ++k) {
    if (!DIRTY || k < q.np) {
      float tv = X[q.poff[k] + r];
      if (DIRTY) tv = one_hot(tv, nf);
      c = c & (tv >= q.lo[k]) & (tv <= q.hi[k]);
    }
  }
  if (TAIL) {
    for (int k = PM; k < q.np; ++k) {
      const int j = q.slot * npred + k;
      float tv = X[t_off[j] + r];
      if (DIRTY) tv = one_hot(tv, nf);
      c = c & (tv >= t_lo[j]) & (tv <= t_hi[j]);
    }
  }
  return c;
}

// t of one row for query q: the §5.2.1 trans value (0 where the row fails)
template <int PM, bool DIRTY>
__device__ __forceinline__ float trans(const Query<PM>& q, const float* X, int r, bool cond,
                                       float w, int nf) {
  float v = X[q.voff + r];
  if (DIRTY && !q.count) v = one_hot(v, nf);
  return cond ? v * (q.avg ? 1.0f : w) : 0.0f;
}

template <bool TWO, int QG, int PM, bool TAIL>
__global__ void __launch_bounds__(kThreads, 2) multi_agg_kernel(Params p) {
  constexpr int S = TWO ? 2 : 1;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ bool is_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = p.ncols, P = p.npred, nq = p.nq;
  const int chunk = p.chunk;
  int* t_off = reinterpret_cast<int*>(smem + kStages * S * p.side_bytes);
  float* t_lo = reinterpret_cast<float*>(t_off + chunk * P);
  float* t_hi = t_lo + chunk * P;
  int* t_np = reinterpret_cast<int*>(t_hi + chunk * P);
  // float64 carries: (warp, query of the warp, moment, lane)
  double* carry = reinterpret_cast<double*>(smem + kStages * S * p.side_bytes +
                                            ((chunk * (3 * P + 1) * 4 + 15) / 16) * 16);

  // the first tile's copy is in flight while the block reads its queries
  const int row0 = tid / C, col0 = tid % C, drow = kThreads / C, dcol = kThreads % C;
  const int64_t ntiles = (p.rows + kTile - 1) / kTile;
  int64_t t = blockIdx.x;
#pragma unroll
  for (int b = 0; b < kStages - 1; ++b) {
    const int64_t tb = t + static_cast<int64_t>(b) * gridDim.x;
    if (tb < ntiles) {
      stage<S>(p, smem + b * S * p.side_bytes, tb * kTile, tile_rows(p.rows, tb), row0, col0,
               drow, dcol);
    }
    cp_commit();
  }

  // constant columns C (zeros) and C + 1 (ones) of every staged side
  for (int i = tid; i < kStages * S * kTile; i += kThreads) {
    float* X = reinterpret_cast<float*>(smem + (i / kTile) * p.side_bytes + kPm);
    X[C * p.ld + i % kTile] = 0.0f;
    X[(C + 1) * p.ld + i % kTile] = 1.0f;
  }
  // the warp's queries: lane g compacts query g's predicate terms
  Query<PM> q[QG];
  if (lane < QG) {
    const int slot = warp + kWarps * lane;
    const int qi = blockIdx.y * chunk + slot;
    int np = 0, dropped = 0;
    if (qi < nq) {
      for (int k = 0; k < P; ++k) {
        int idx = p.sel_idx[(1 + k) * nq + qi];
        const float* b = p.meta + (2 + 4 * k) * nq + qi;
        const float lo = lower_bound(b[0], b[nq]);
        const float hi = upper_bound(b[2 * nq], b[3 * nq]);
        if (idx < 0 || idx >= C) {
          if (0.0f >= lo && 0.0f <= hi) {  // a zero column passes every finite row
            dropped = 1;
            continue;
          }
          idx = C;
        }
        t_off[slot * P + np] = idx * p.ld;
        t_lo[slot * P + np] = lo;
        t_hi[slot * P + np] = hi;
        ++np;
      }
    }
    t_np[slot] = np | (dropped << 16);
  }
  __syncwarp();
#pragma unroll
  for (int g = 0; g < QG; ++g) {
    const int slot = warp + kWarps * g;
    const int qi = blockIdx.y * chunk + slot;
    q[g].active = qi < nq;
    q[g].slot = slot;
    q[g].np = t_np[slot] & 0xffff;
    q[g].dropped = (t_np[slot] >> 16) != 0;
    int vidx = q[g].active ? p.sel_idx[qi] : -1;
    if (vidx >= C) vidx = -1;
    const bool count = q[g].active && p.meta[qi] > 0.0f;
    q[g].avg = q[g].active && p.meta[nq + qi] > 0.0f;
    q[g].count = count;
    q[g].voff = (count ? C + 1 : (vidx < 0 ? C : vidx)) * p.ld;
#pragma unroll
    for (int k = 0; k < PM; ++k) {
      const bool used = k < q[g].np;
      const int j = slot * P + (used ? k : 0);
      q[g].poff[k] = used ? t_off[j] : C * p.ld;
      q[g].lo[k] = used ? t_lo[j] : -INFINITY;
      q[g].hi[k] = used ? t_hi[j] : INFINITY;
    }
  }
  int np_warp = 0;  // the most terms a query of this warp tests
#pragma unroll
  for (int g = 0; g < QG; ++g) np_warp = max(np_warp, q[g].np);
  Acc acc[QG];
#pragma unroll
  for (int g = 0; g < QG; ++g) {
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      acc[g].tile[k] = 0.0f;
      carry[((warp * QG + g) * 9 + k) * 32 + lane] = 0.0;
    }
    acc[g].kn = acc[g].ko = 0;
  }
  int kd = 0, kvn = 0, kvo = 0;  // joined, new-valid and old-valid rows
  // a lane's float32 sums over kFold tiles (≤ 32 rows) go into float64
  int unfolded = 0;
  auto fold = [&]() {
#pragma unroll
    for (int g = 0; g < QG; ++g) {
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        carry[((warp * QG + g) * 9 + k) * 32 + lane] += static_cast<double>(acc[g].tile[k]);
        acc[g].tile[k] = 0.0f;
      }
    }
  };

  for (int buf = 0; t < ntiles; t += gridDim.x, buf = buf + 1 == kStages ? 0 : buf + 1) {
    cp_wait_ring();
    const int n = tile_rows(p.rows, t);
    const uint8_t* bn = smem + buf * S * p.side_bytes;
    // the one barrier of a step publishes tile t, says whether any of its x
    // is inf or NaN (such a tile takes the reference's inf · 0 rule row by
    // row), and frees the slot reduced last step, which is restaged at once
    const bool dirty =
        __syncthreads_or(staged_nonfinite<S>(p, bn, n, row0, col0, drow, dcol)) != 0;
    const int64_t tn = t + static_cast<int64_t>(kStages - 1) * gridDim.x;
    if (tn < ntiles) {
      const int nb = buf == 0 ? kStages - 1 : buf - 1;
      stage<S>(p, smem + nb * S * p.side_bytes, tn * kTile, tile_rows(p.rows, tn), row0, col0,
               drow, dcol);
    }
    cp_commit();
    const uint8_t* bo = bn + p.side_bytes;
    const float* Wn = reinterpret_cast<const float*>(bn);
    const float* On = Wn + kTile;
    const uint8_t* Vn = bn + 8 * kTile;
    const float* Xn = reinterpret_cast<const float*>(bn + kPm);
    const float* Wo = reinterpret_cast<const float*>(bo);
    const float* Oo = Wo + kTile;
    const uint8_t* Vo = bo + 8 * kTile;
    const float* Xo = reinterpret_cast<const float*>(bo + kPm);
    // one row for the warp's queries; an inactive query (past Q) reads the
    // zero column and its sums are never written
    auto row = [&](int r, auto dirty_tag, auto np_tag) {
      constexpr bool DIRTY = decltype(dirty_tag)::value;
      constexpr int NP = decltype(np_tag)::value;
      int nfn = 0, nfo = 0;  // the row's non-finite x columns, per side
      if (DIRTY) {
        for (int c = 0; c < C; ++c) {
          nfn += isfinite(Xn[c * p.ld + r]) ? 0 : 1;
          if (TWO) nfo += isfinite(Xo[c * p.ld + r]) ? 0 : 1;
        }
      }
      const bool vn = Vn[r] != 0;
      const float wn = Wn[r], on = On[r];
      bool vo = false;
      float wo = 0.0f, oo = 0.0f;
      if (TWO) {
        vo = Vo[r] != 0;
        wo = Wo[r];
        oo = Oo[r];
        kd += (vn || vo) ? 1 : 0;
        kvo += vo ? 1 : 0;
      }
      kvn += vn ? 1 : 0;
#pragma unroll
      for (int g = 0; g < QG; ++g) {
        const bool cn = passes<PM, TAIL, DIRTY, NP>(q[g], Xn, r, vn, nfn, t_off, t_lo, t_hi, P);
        const float tn_ = trans<PM, DIRTY>(q[g], Xn, r, cn, wn, nfn);
        acc[g].kn += cn ? 1 : 0;
        const float ttn = tn_ * tn_;
        acc[g].tile[0] += tn_;
        acc[g].tile[1] += ttn;
        acc[g].tile[2] = fmaf(on, ttn, acc[g].tile[2]);
        if (TWO) {
          const bool co = passes<PM, TAIL, DIRTY, NP>(q[g], Xo, r, vo, nfo, t_off, t_lo, t_hi,
                                                      P);
          const float to_ = trans<PM, DIRTY>(q[g], Xo, r, co, wo, nfo);
          acc[g].ko += co ? 1 : 0;
          const float tto = to_ * to_;
          acc[g].tile[3] += to_;
          acc[g].tile[4] += tto;
          acc[g].tile[5] = fmaf(oo, tto, acc[g].tile[5]);
          const float d = tn_ - to_;
          const float dd = d * d;
          acc[g].tile[6] += d;
          acc[g].tile[7] += dd;
          acc[g].tile[8] = fmaf(fminf(on, oo), dd, acc[g].tile[8]);
        }
      }
    };
    // a full tile whose x is finite everywhere (all but adversarial data)
    // skips the reference's inf · 0 rule, and its eight rows a lane unroll
    // into loads at fixed offsets from one address a column
    auto clean_tile = [&](auto np_tag) {
#pragma unroll
      for (int j = 0; j < kTile / 32; ++j) row(lane + 32 * j, std::false_type{}, np_tag);
    };
    // a full tile with no valid row on either side adds nothing (t = 0 on
    // every row, w and 1−π finite): the query engine's panels keep their
    // valid rows in front, so most of a panel's tiles are skipped
    static_assert(kTile == 64 * sizeof(uint32_t), "a lane reads two words of a side's flags");
    const uint32_t* vwn = reinterpret_cast<const uint32_t*>(Vn);
    const uint32_t* vwo = reinterpret_cast<const uint32_t*>(Vo);
    const bool any_valid =
        __any_sync(0xffffffffu, (vwn[lane] | vwn[lane + 32] |
                                 (TWO ? vwo[lane] | vwo[lane + 32] : 0u)) != 0);
    if (n == kTile && !dirty && !any_valid) {
      // nothing to add
    } else if (n == kTile && !dirty) {
      if (np_warp == 0) clean_tile(std::integral_constant<int, 0>{});
      else if (np_warp == 1 || PM == 1) clean_tile(std::integral_constant<int, 1>{});
      else if (np_warp == 2 || PM == 2) clean_tile(std::integral_constant<int, (PM < 2 ? PM : 2)>{});
      else clean_tile(std::integral_constant<int, PM>{});
    } else {
      for (int r = lane; r < n; r += 32) {
        row(r, std::true_type{}, std::integral_constant<int, PM>{});
      }
    }
    if (++unfolded == kFold) {
      fold();
      unfolded = 0;
    }
  }
  fold();

  // the block's partials, output-major ((12, Q, blocks)): a fixed xor tree
  // over the lanes of each warp
  const int nb = gridDim.x;
#pragma unroll
  for (int g = 0; g < QG; ++g) {
    double m[kMoments];
    m[0] = q[g].avg ? acc[g].kn : kvn;  // sum/count: the valid rows
    m[1] = carry[((warp * QG + g) * 9 + 0) * 32 + lane];
    m[2] = carry[((warp * QG + g) * 9 + 1) * 32 + lane];
    m[3] = carry[((warp * QG + g) * 9 + 2) * 32 + lane];
    m[4] = q[g].avg ? acc[g].ko : kvo;
    m[5] = carry[((warp * QG + g) * 9 + 3) * 32 + lane];
    m[6] = carry[((warp * QG + g) * 9 + 4) * 32 + lane];
    m[7] = carry[((warp * QG + g) * 9 + 5) * 32 + lane];
    m[8] = 0.0;
    m[9] = carry[((warp * QG + g) * 9 + 6) * 32 + lane];
    m[10] = carry[((warp * QG + g) * 9 + 7) * 32 + lane];
    m[11] = carry[((warp * QG + g) * 9 + 8) * 32 + lane];
#pragma unroll
    for (int k = 0; k < kMoments; ++k) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m[k] += __shfl_xor_sync(0xffffffffu, m[k], off);
    }
    const int qi = blockIdx.y * chunk + warp + kWarps * g;
    if (lane == 0 && q[g].active) {
#pragma unroll
      for (int k = 0; k < kMoments; ++k) {
        if (k != 8) p.partials[(static_cast<int64_t>(k) * nq + qi) * nb + blockIdx.x] = m[k];
      }
    }
  }
  if (TWO && warp == 0) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) kd += __shfl_xor_sync(0xffffffffu, kd, off);
    for (int j = lane; j < chunk; j += 32) {
      const int qi = blockIdx.y * chunk + j;
      if (qi < nq) {
        p.partials[(static_cast<int64_t>(8) * nq + qi) * nb + blockIdx.x] = static_cast<double>(kd);
      }
    }
  }

  // The partials are summed in two rounds, each by the last block to
  // arrive: the last of each group of kGroup blocks sums its group's, then
  // the last group sums the groups'.  Both rounds add in block (group)
  // order, whichever block arrives last.
  const int ngroups = (nb + kGroup - 1) / kGroup;
  const int grp = blockIdx.x / kGroup;
  const int gsize = min(kGroup, nb - grp * kGroup);
  int* tk = p.tickets + static_cast<int64_t>(blockIdx.y) * (ngroups + 1);
  double* gpart = p.partials + static_cast<int64_t>(kMoments) * nq * nb;
  const int nout = kMoments * chunk;
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(tk + grp, 1) == gsize - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int o = tid; o < nout; o += kThreads) {
    const int k = o / chunk, qi = blockIdx.y * chunk + o % chunk;
    if (qi >= nq || (!TWO && k >= 4)) continue;
    const int64_t oi = static_cast<int64_t>(k) * nq + qi;
    gpart[oi * ngroups + grp] = sum_in_order(p.partials + oi * nb + grp * kGroup, gsize);
  }
  if (tid == 0) tk[grp] = 0;
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(tk + ngroups, 1) == ngroups - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  for (int o = tid; o < nout; o += kThreads) {
    const int k = o / chunk, qi = blockIdx.y * chunk + o % chunk;
    if (qi >= nq) continue;
    const int64_t oi = static_cast<int64_t>(k) * nq + qi;
    p.out[oi] = (!TWO && k >= 4) ? 0.0f
                                 : static_cast<float>(sum_in_order(gpart + oi * ngroups, ngroups));
  }
  if (tid == 0) tk[ngroups] = 0;
}

template <bool TWO, int QG, int PM, bool TAIL>
cudaError_t launch(const Params& p, int nblocks, int smem, cudaStream_t stream) {
  // the dynamic shared memory granted so far on each card, beyond the 48 KB
  // every kernel may take (0: nothing granted)
  static svc::PerDevice<int> granted;
  int* allowed = granted.slot();
  if (smem > 48 * 1024 && (allowed == nullptr || smem > *allowed)) {
    const cudaError_t err = cudaFuncSetAttribute(
        multi_agg_kernel<TWO, QG, PM, TAIL>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (allowed != nullptr) *allowed = smem;
  }
  const dim3 grid(nblocks, (p.nq + p.chunk - 1) / p.chunk);
  multi_agg_kernel<TWO, QG, PM, TAIL><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// PM: the predicate slots held in registers, 1, 2 or 4; past 4 (a query
// with five or more distinct predicate columns) the rest come from the
// shared table (TAIL).
template <bool TWO, int QG>
cudaError_t dispatch_pm(const Params& p, int nblocks, int smem, cudaStream_t s) {
  if (p.npred <= 1) return launch<TWO, QG, 1, false>(p, nblocks, smem, s);
  if (p.npred <= 2) return launch<TWO, QG, 2, false>(p, nblocks, smem, s);
  if (p.npred <= 4) return launch<TWO, QG, 4, false>(p, nblocks, smem, s);
  return launch<TWO, QG, 4, true>(p, nblocks, smem, s);
}

template <bool TWO>
cudaError_t dispatch(const Params& p, int qg, int nblocks, int smem, cudaStream_t s) {
  return qg == 1 ? dispatch_pm<TWO, 1>(p, nblocks, smem, s)
                 : dispatch_pm<TWO, 2>(p, nblocks, smem, s);
}

}  // namespace multi_agg

// One launch: (12, Q) moments into `out`.  With groups = ⌈nblocks / 16⌉,
// `partials` holds (nblocks + groups)·12·Q doubles and `tickets`
// ⌈Q / chunk⌉·(groups + 1) ints, 0 on entry and left 0 on exit.
extern "C" int svc_multi_agg(const float* xn, const uint8_t* vn, const float* wn,
                             const float* on, const float* xo, const uint8_t* vo,
                             const float* wo, const float* oo, int64_t rows, int ncols,
                             const int32_t* sel_idx, const float* meta, int npred, int nq,
                             int nblocks, double* partials, int* tickets, float* out,
                             void* stream) {
  using namespace multi_agg;
  const bool two = xo != nullptr;
  const int qg = nq <= kWarps ? 1 : 2;
  Params p{};
  p.side[0] = Side{xn, vn, wn, on};
  p.side[1] = Side{xo, vo, wo, oo};
  p.rows = rows;
  p.ncols = ncols;
  // pad a column so that a warp's 4-byte copies of consecutive flat
  // elements land in 32 different banks: col·pad + row distinct mod 32
  p.ld = kTile + ((32 + ncols - 1) / ncols) % 32;
  const int64_t side_bytes = (kPm + static_cast<int64_t>(ncols + 2) * p.ld * 4 + 15) / 16 * 16;
  p.side_bytes = static_cast<int>(side_bytes);
  p.sel_idx = sel_idx;
  p.meta = meta;
  p.npred = npred;
  p.nq = nq;
  p.chunk = kWarps * qg;
  p.partials = partials;
  p.tickets = tickets;
  p.out = out;
  const int64_t smem = kStages * (two ? 2 : 1) * side_bytes +
                       (static_cast<int64_t>(p.chunk) * (3 * npred + 1) * 4 + 15) / 16 * 16 +
                       static_cast<int64_t>(p.chunk) * 9 * 32 * 8;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = two ? dispatch<true>(p, qg, nblocks, static_cast<int>(smem), s)
                              : dispatch<false>(p, qg, nblocks, static_cast<int>(smem), s);
  return static_cast<int>(err);
}
