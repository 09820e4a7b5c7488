// The sLSTM's recurrence over time (xLSTM, arXiv:2405.04517), forward and
// backward, on two routes: a resident route, one cooperative launch a
// call whose blocks loop over the time steps, and a per-step route, one
// launch a time step from a C loop.
//
//   forward — for t = 0..S−1, step t computes
//       g_t = wx_t + rec(h_{t−1}),   rec: gate block hd (z, i, f, o for
//             hd = 0..3) = h[:, hd·d/4:(hd+1)·d/4] @ R[hd]
//     and the exp-gated cell (JAX's order of operations):
//       z = tanh(g_z), o = σ(g_o), logf = log σ(g_f)
//       m_t = max(logf + m_{t−1}, g_i)
//       i' = exp(g_i − m_t), f' = exp(logf + m_{t−1} − m_t)
//       c_t = f'·c_{t−1} + i'·z,  n_t = f'·n_{t−1} + i',  h_t = o·c_t / max(n_t, 1)
//     writing h_t into hs[:, t] and (c, n, m) of the last step, and, when
//     the caller saves for the backward, g_t and (c_t, n_t, m_t).
//   backward — for t = S−1..0, step t forms
//       dh_t = dhs_t + Σ_e dg_{t+1}[hd(u)·d + e] · R[hd(u), u mod d/4, e]
//     (no sum at t = S−1), runs the cell's backward with the carried dc,
//     dn, dm and writes dg_t (the gradient of wx_t).  At max(logf + m, g_i)
//     and max(n, 1) a tie sends half the gradient down each branch, as
//     jnp.maximum does.  dR = Σ_t h_{t−1}ᵀ·dg_t is not computed here: the
//     wrapper takes it as one batched product over all steps after the
//     loop, as JAX's scan transposes its einsum into a dot.
//
// Replaces no Pallas kernel: the body of XLA's lax.scan at
// src/repro/models/xlstm.py:242-256 (the einsum bhd,hde->bhe with R, then
// _slstm_cell at :213-225), and the VJP JAX's autodiff takes of it.  The
// plain PyTorch version (kernels/slstm/ref.py) makes ~30 launches a step
// forward and more backward.
//
// Bound: operations, 2·B·4·(d/4)·d a step for R·h (67 MFLOP at B = 8,
// d = 2,048: 1.0 µs at the float32 CUDA-core peak).  Every step depends on
// the whole of the step before, so what bounds a step in practice is
// latency: the exchange of h_t (or dg_{t+1}) between the blocks and the
// wait until every block has written it.
//
// Work split (both routes): a forward block owns kUnits = 16 units j of
// all four gates (R's columns j of every gate), a backward block 16 units
// of one head (R's rows; d/4 is a multiple of 16), for row tiles of
// kRows = 8 batch rows: d/16 blocks, 128 at d = 2,048.
//   * Forward products: h_{t−1} of the tile's rows is staged in shared
//     memory (8·d floats, zero past B); each of 16 k-groups q (a half-warp)
//     sums, for 4 gates × 8 rows in registers, the chunks p ≡ q (mod 16) of
//     four k's (k = 4p..4p+3), each a float4 of h and four fmaf in k order;
//     the 16 partials are added in group order with __fadd_rn by the
//     thread of (row, unit), which then runs the cell.
//   * Backward products: dg_{t+1}'s head block of the tile's rows is staged
//     in shared memory; a warp takes 4 units and half of e, its lanes
//     consecutive e's (e = half·d/2 + lane + 32·m, m in order) of R's
//     contiguous rows; lane sums reduce by a fixed xor butterfly, the halves
//     in order; the thread of (row, unit) runs the cell's backward.
//   * The cell's arithmetic is the plain version's order with every
//     rounding pinned by an intrinsic (__fadd_rn, __fmul_rn, __fdiv_rn: no
//     multiply-add is contracted), IEEE expf, tanhf and log1pf (the build
//     has no fast math); the dot products use fused multiply-adds in their
//     own order.  No atomics in any sum: two calls give the same bits, and
//     the two routes, which take every sum in the same order, give each
//     other's bits.
//
// Per-step route (svc_slstm_fwd, svc_slstm_bwd; every decode, S = 1, and
// the shapes the resident route does not take): grid (d/16, ⌈B/8⌉), one
// launch a step; R is re-read from L2 by every launch (__ldg), h_{t−1} or
// dg_{t+1} staged with __ldg (written by an earlier launch), the state and
// carries in (B, d) buffers between launches.  ~9.4 µs a step at
// (8, 512, 2,048) on an NVIDIA H100 80GB HBM3 at 700 W: R's 16.8 MB from
// L2 and the launch gap.
//
// Resident route (svc_slstm_fwd_resident, svc_slstm_bwd_resident): one
// cooperative launch of d/16 blocks, one an SM, that loops over the steps
// and, inside each step, over the ⌈B/8⌉ row tiles:
//   * R's slice is read once into registers: a backward thread (256 a
//     block) holds its 4 units × d/64 e's, d/16 floats (128 at d = 2,048,
//     the register file's share of a 256-thread block); a forward block has
//     512 threads, each the 2 gates × (d/256 chunks of 4 k's) of its unit
//     and k-group, d/32 floats, so that each SM scheduler has four warps to
//     hide the latency of its fmaf chains instead of two.  So the route
//     takes d ≤ 2,048, with d/16 ≤ the card's SMs.
//   * The state (c, n, m) and the carries (dc, dn, dm) of up to kMaxTiles
//     row tiles stay in the cell threads' registers from the first step to
//     the last (B ≤ 32); the forward writes the last state once.
//   * Between steps, one grid-wide barrier: a monotonic 64-bit arrival
//     counter in a per-(card, stream) workspace the wrapper keeps, which
//     one thread a block raises with red.release.gpu after __syncthreads
//     and then polls with ld.acquire.gpu until every block of this step has
//     arrived (CUTLASS's GenericBarrier pattern; the wrapper passes the
//     count before the launch, so the counter is never reset).  A poll that
//     waits longer than kBarrierTimeoutNs traps: a kernel error, never a
//     hang.  The cooperative launch makes the runtime refuse a grid the card
//     cannot hold at once, which the entry returns and the wrapper raises.
//   * h_t and dg_{t+1} are written by other blocks of the same launch, so
//     they are staged with cp.async.cg (L2, never the incoherent L1 or the
//     read-only path), spread over every warp, in commit groups (the
//     forward's two pairs of heads, the backward's four quarters of each
//     half of e) so that the products on the first group run while the
//     rest arrive; __ldg only for R, wx, the given state and the saved
//     tensors, which no launch writes.
//   * At d = 2,048 the products run unguarded (kFull), every k-group or
//     lane owning all its chunks.
//   * Shared memory: 8·d floats of h plus the forward's partials, 96 KB at
//     d = 2,048 (64 KB + 1 KB backward); one block an SM.
//   * A step at (8, 512, 2,048) on an NVIDIA H100 80GB HBM3 at 700 W took
//     ~5.2 µs forward and ~5.6 backward (chip_smoke.py's slstm lines), of
//     which one barrier alone ~1.0 µs (their barrier_us); the rest is the
//     products' fmaf chains (~1.2 µs at the float32 peak), the staging of
//     64 KB a block from L2 and the cell.

#include <cuda_runtime.h>

#include "svc_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kResGates = 2;  // gates a resident forward thread takes
constexpr int kResFwdThreads = kThreads * 4 / kResGates;  // 512
constexpr int kUnits = 16;   // units of each gate a block owns
constexpr int kRows = 8;     // batch rows of a tile
constexpr int kGroups = 16;  // forward k-groups: 8 warps × 2 half-warps
constexpr int kBwdUnitsPerWarp = 4;
constexpr int kStageWords = 8;  // 16-byte words a thread has in flight while staging rows
// resident route
constexpr int kMaxTiles = 4;     // row tiles whose state a block keeps in registers: B ≤ 32
constexpr int kResChunks = 8;    // forward: float4 chunks of k a k-group owns per gate (d ≤ 2,048)
constexpr int kResSteps = 32;    // backward: e's a lane owns per unit, d/64 (d ≤ 2,048)
constexpr int kResMaxD = 4 * kGroups * 4 * kResChunks;  // 2,048
constexpr int kStageGroups = 4;  // cp.async commit groups a staging
constexpr unsigned long long kBarrierTimeoutNs = 10ull * 1000 * 1000 * 1000;

// dst[r·d + k] = src[r·stride + k] for rows r < nb, 0 for nb ≤ r < kRows
// (and for every row when src is null), by a block of kT threads: 16-byte
// words, kStageWords of them in flight a thread, where src and its rows are
// aligned to 16 bytes, else one float at a time.  Reads through the
// read-only path: only for data no block of this launch writes.
template <int kT>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, long long stride, int nb,
                                           int d) {
  const int tid = threadIdx.x;
  if (src == nullptr || ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (stride & 3) == 0)) {
    const int row_words = d >> 2, words = kRows * row_words;
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (int base = tid; base < words; base += kT * kStageWords) {
      float4 v[kStageWords];
#pragma unroll
      for (int i = 0; i < kStageWords; ++i) {
        const int w = base + i * kT;
        const int r = w / row_words;
        v[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (src != nullptr && w < words && r < nb) {
          v[i] = __ldg(reinterpret_cast<const float4*>(src + r * stride) + (w - r * row_words));
        }
      }
#pragma unroll
      for (int i = 0; i < kStageWords; ++i) {
        const int w = base + i * kT;
        if (w < words) dst4[w] = v[i];
      }
    }
    return;
  }
  for (int r = 0; r < kRows; ++r) {
    for (int k = tid; k < d; k += kT) dst[r * d + k] = r < nb ? src[r * stride + k] : 0.0f;
  }
}

// 16 bytes global → shared through L2 (cp.async.cg); zeros when !valid
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most ``left`` of this thread's commit groups are in flight
__device__ __forceinline__ void cp_async_wait(int left) {
  switch (left) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

// rows r < kRows, columns [c0, c0 + n) of src (row r at src + r·stride;
// 16-byte aligned, n a multiple of 4, n/4 ≤ kT) into dst (row pitch d) by
// cp.async from a block of kT threads, zeros for rows r ≥ nb; the caller
// commits the group.  The copies are spread over every warp (kT / (n/4)
// rows a pass): a few warps issuing them all took twice a step's time.
template <int kT>
__device__ __forceinline__ void stage_cols_async(float* dst, const float* src, long long stride,
                                                 int nb, int d, int c0, int n) {
  const int words = n >> 2;
  const int rows = kT / words;  // rows a pass
  const int r0 = threadIdx.x / words;
  const int k = c0 + ((threadIdx.x - r0 * words) << 2);
  if (r0 >= rows) return;
  for (int r = r0; r < kRows; r += rows) {
    const bool ok = r < nb;
    cp_async16(dst + r * d + k, ok ? src + r * stride + k : src, ok);
  }
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Every block of the grid has arrived here for the ``target``-th time
// (counting from the workspace's zero): thread 0 adds this block's arrival
// with release semantics after the block's writes, then polls with acquire
// semantics; the block waits for thread 0.  Traps after
// kBarrierTimeoutNs of polling.
__device__ __forceinline__ void grid_barrier(unsigned long long* count,
                                             unsigned long long target) {
  __syncthreads();
  if (threadIdx.x == 0) {  // the release orders the block's writes, which __syncthreads made its
    asm volatile("red.release.gpu.global.add.u64 [%0], %1;\n" ::"l"(count), "l"(1ull) : "memory");
    unsigned long long seen;
    const unsigned long long t0 = global_ns();
    for (int polls = 1;; ++polls) {
      asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n" : "=l"(seen) : "l"(count) : "memory");
      if (seen >= target) break;
      if ((polls & 1023) == 0 && global_ns() - t0 > kBarrierTimeoutNs) __trap();
    }
  }
  __syncthreads();
}

// torch.maximum: NaN when either is NaN, else the larger
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}

// the share of max(x, y)'s gradient that goes to x: 1, ½ at a tie, 0
__device__ __forceinline__ float tie_split(float x, float y) {
  return x > y ? 1.0f : (x == y ? 0.5f : 0.0f);
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// log σ(x) = −softplus(−x) = −(max(−x, 0) + log1p(exp(−|x|)))
__device__ __forceinline__ float log_sigmoid_f(float x) {
  return -__fadd_rn(max_nan(-x, 0.0f), log1pf(expf(-fabsf(x))));
}

// g[gt] = wx[gt] + Σ_q part[q][gt][b][v], the 16 k-groups' partials added
// in group order
__device__ __forceinline__ void gate_sums(const float* part, const float wxv[4], int b, int v,
                                          float g[4]) {
#pragma unroll
  for (int gt = 0; gt < 4; ++gt) {
    float s = part[(gt * kRows + b) * kUnits + v];
    for (int p = 1; p < kGroups; ++p) s = __fadd_rn(s, part[((p * 4 + gt) * kRows + b) * kUnits + v]);
    g[gt] = __fadd_rn(wxv[gt], s);
  }
}

// the exp-gated cell: (c_p, n_p, m_p) and the gates g → (c, n, m) and h
__device__ __forceinline__ void fwd_cell(const float g[4], float c_p, float n_p, float m_p,
                                         float& c, float& n, float& m, float& h) {
  const float z = tanhf(g[0]);
  const float o = sigmoid_f(g[3]);
  const float logf_ = log_sigmoid_f(g[2]);
  m = max_nan(__fadd_rn(logf_, m_p), g[1]);
  const float ip = expf(__fsub_rn(g[1], m));
  const float fp = expf(__fsub_rn(__fadd_rn(logf_, m_p), m));
  c = __fadd_rn(__fmul_rn(fp, c_p), __fmul_rn(ip, z));
  n = __fadd_rn(__fmul_rn(fp, n_p), ip);
  h = __fdiv_rn(__fmul_rn(o, c), max_nan(n, 1.0f));
}

// The cell's backward at one (row, unit): the gate pre-activations (zr,
// ir, fr, orr), the step's (c, n, m) and the previous (c_p, n_p, m_p), dh
// and the carries (dc, dn, dm) → dg (z, i, f, o) and the new carries.
__device__ __forceinline__ void bwd_cell(float dh_, float zr, float ir, float fr, float orr,
                                         float c, float n, float m, float c_p, float n_p,
                                         float m_p, float& dc, float& dn, float& dm,
                                         float dg[4]) {
  const float z = tanhf(zr);
  const float o = sigmoid_f(orr);
  const float logf_ = log_sigmoid_f(fr);
  const float av = __fadd_rn(logf_, m_p);
  const float ip = expf(__fsub_rn(ir, m));
  const float fp = expf(__fsub_rn(av, m));
  const float nc = max_nan(n, 1.0f);
  const float h = __fdiv_rn(__fmul_rn(o, c), nc);
  const float t1 = __fdiv_rn(dh_, nc);  // d(o·c)
  const float do_ = __fmul_rn(t1, c);
  const float dct = __fadd_rn(dc, __fmul_rn(t1, o));
  const float dnt = __fsub_rn(dn, __fmul_rn(__fmul_rn(t1, h), tie_split(n, 1.0f)));
  const float dfp = __fadd_rn(__fmul_rn(dct, c_p), __fmul_rn(dnt, n_p));
  const float dip = __fadd_rn(__fmul_rn(dct, z), dnt);
  const float dz = __fmul_rn(dct, ip);
  const float da_arg = __fmul_rn(dfp, fp);  // d(logf + m_{t−1} − m_t)
  const float di_arg = __fmul_rn(dip, ip);  // d(g_i − m_t)
  const float dmt = __fsub_rn(__fsub_rn(dm, da_arg), di_arg);
  const float wa = tie_split(av, ir);
  const float da = __fadd_rn(da_arg, __fmul_rn(dmt, wa));
  const float dir = __fadd_rn(di_arg, __fmul_rn(dmt, __fsub_rn(1.0f, wa)));
  const float dfr = __fmul_rn(da, expf(__fsub_rn(logf_, fr)));  // σ(−f) = exp(log σ(f) − f)
  const float dor = __fmul_rn(__fmul_rn(do_, o), __fsub_rn(1.0f, o));
  const float dzr = __fmul_rn(dz, __fsub_rn(1.0f, __fmul_rn(z, z)));
  dg[0] = dzr;
  dg[1] = dir;
  dg[2] = dfr;
  dg[3] = dor;
  dc = __fmul_rn(dct, fp);
  dn = __fmul_rn(dnt, fp);
  dm = da;
}

// one backward warp's lane sums over its 4 units × 8 rows, reduced by the
// fixed butterfly into red[half][unit][row]
__device__ __forceinline__ void bwd_reduce(float acc[kBwdUnitsPerWarp][kRows], float* red,
                                           int half, int uw, int lane) {
#pragma unroll
  for (int i = 0; i < kBwdUnitsPerWarp; ++i) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      float s = acc[i][r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) red[(half * kUnits + uw + i) * kRows + r] = s;
    }
  }
}

struct FwdArgs {
  const float* wx;      // (B, S, 4d)
  const float* R;       // (4, d/4, d)
  const float* h_prev;  // row b of h_{t−1} at h_prev + b·h_stride; null: zeros
  long long h_stride;
  const float* c_prev;  // (B, d) each; null: zeros
  const float* n_prev;
  const float* m_prev;
  float* hs;            // (B, S, d): writes [:, t]
  float* c_out;         // (B, d) each: the state after step t
  float* n_out;
  float* m_out;
  float* g_save;        // (B, S, 4d) or null
  float* c_save;        // (B, S, d) each, or null
  float* n_save;
  float* m_save;
  int B, S, d, t;
};

__global__ void __launch_bounds__(kThreads) slstm_fwd_step(FwdArgs a) {
  extern __shared__ float4 smem4[];
  float* hsm = reinterpret_cast<float*>(smem4);  // [kRows][d]: h_{t−1}
  const int d = a.d, dh = d >> 2;
  float* part = hsm + kRows * d;                 // [kGroups][4][kRows][kUnits]
  const int j0 = blockIdx.x * kUnits;
  const int b0 = blockIdx.y * kRows;
  const int nb = min(kRows, a.B - b0);
  const int tid = threadIdx.x;
  // the cell's thread (row b, unit v) reads its inputs before the products
  const int b = tid / kUnits, v = tid % kUnits;
  const bool cell = tid < kRows * kUnits && b < nb;
  const long long row = static_cast<long long>(b0 + b);
  const int jj = j0 + v;
  const long long st = row * a.S + a.t;  // (b, t) in the (B, S, ·) tensors
  const long long si = row * d + jj;
  float wxv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float c_p = 0.0f, n_p = 0.0f, m_p = 0.0f;
  if (cell) {
#pragma unroll
    for (int gt = 0; gt < 4; ++gt) wxv[gt] = __ldg(a.wx + st * 4 * d + gt * d + jj);
    if (a.c_prev != nullptr) c_p = a.c_prev[si];
    if (a.n_prev != nullptr) n_p = a.n_prev[si];
    if (a.m_prev != nullptr) m_p = a.m_prev[si];
  }
  stage_rows<kThreads>(hsm, a.h_prev == nullptr ? nullptr : a.h_prev + b0 * a.h_stride,
                       a.h_stride, nb, d);
  __syncthreads();

  const int lane = tid & 31;
  const int q = (tid >> 5) * 2 + (lane >> 4);  // this half-warp's k-group
  const int u = lane & 15;
  const int j = j0 + u;
  float acc[4][kRows];
#pragma unroll
  for (int gt = 0; gt < 4; ++gt) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[gt][r] = 0.0f;
  }
#pragma unroll 2
  for (int p = q; p < (dh >> 2); p += kGroups) {
    const int k = p << 2;
    float rv[4][4];
#pragma unroll
    for (int gt = 0; gt < 4; ++gt) {
      const float* r = a.R + (static_cast<long long>(gt) * dh + k) * d + j;
#pragma unroll
      for (int i = 0; i < 4; ++i) rv[gt][i] = __ldg(r + i * d);
    }
#pragma unroll
    for (int gt = 0; gt < 4; ++gt) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 h4 = *reinterpret_cast<const float4*>(hsm + r * d + gt * dh + k);
        float s = acc[gt][r];
        s = fmaf(h4.x, rv[gt][0], s);
        s = fmaf(h4.y, rv[gt][1], s);
        s = fmaf(h4.z, rv[gt][2], s);
        s = fmaf(h4.w, rv[gt][3], s);
        acc[gt][r] = s;
      }
    }
  }
#pragma unroll
  for (int gt = 0; gt < 4; ++gt) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) part[((q * 4 + gt) * kRows + r) * kUnits + u] = acc[gt][r];
  }
  __syncthreads();

  if (!cell) return;
  float g[4], c, n, m, h;
  gate_sums(part, wxv, b, v, g);
  fwd_cell(g, c_p, n_p, m_p, c, n, m, h);
  a.hs[st * d + jj] = h;
  a.c_out[si] = c;
  a.n_out[si] = n;
  a.m_out[si] = m;
  if (a.g_save != nullptr) {
#pragma unroll
    for (int gt = 0; gt < 4; ++gt) a.g_save[st * 4 * d + gt * d + jj] = g[gt];
    a.c_save[st * d + jj] = c;
    a.n_save[st * d + jj] = n;
    a.m_save[st * d + jj] = m;
  }
}

// The forward's resident route: grid d/16 of kResFwdThreads threads, the
// given state in h_prev (stride d), c_prev, n_prev, m_prev; the arrival
// counter and its value before this launch.  Twice the per-step block's
// threads: warps 0–7 take gates z and i (heads 0 and 1), warps 8–15 gates
// f and o, each thread the same k-group q and unit u of two gates, so that
// a thread holds half the slice of R and an SM twice the warps; every
// (row, unit, gate) sum is the per-step route's, in its order.  kFull:
// d = kResMaxD, every k-group owns kResChunks chunks (no guard in the
// products, which lets the compiler schedule their loads across chunks).
template <bool kFull>
__global__ void __launch_bounds__(kResFwdThreads, 1)
    slstm_fwd_resident(FwdArgs a, unsigned long long* count, unsigned long long base) {
  constexpr int G = kResGates, kT = kResFwdThreads;
  extern __shared__ float4 smem4[];
  float* hsm = reinterpret_cast<float*>(smem4);  // [kRows][d]: h_{t−1} of one tile
  const int d = a.d, dh = d >> 2, S = a.S, Bn = a.B;
  float* part = hsm + kRows * d;                 // [kGroups][4][kRows][kUnits]
  const int chunks = dh >> 2;                    // float4 chunks of k in a head
  const int tiles = (Bn + kRows - 1) / kRows;
  const int j0 = blockIdx.x * kUnits;
  const int tid = threadIdx.x;
  const int b = tid / kUnits, v = tid % kUnits;  // a cell thread's (row of the tile, unit)
  const bool cell_thread = tid < kRows * kUnits;
  const int jj = j0 + v;
  const int warp = tid >> 5, lane = tid & 31;
  const int g0 = (warp >> 3) * G;                // this thread's gates: g0 .. g0 + G − 1
  const int q = (warp & 7) * 2 + (lane >> 4);    // its k-group
  const int u = lane & 15;
  const int j = j0 + u;

  // R's slice, once: chunk c of k-group q is p = q + 16c, k = 4p..4p+3
  float rv[kResChunks][G][4];
#pragma unroll
  for (int c = 0; c < kResChunks; ++c) {
    const int p = q + c * kGroups;
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        rv[c][g][i] =
            p < chunks ? __ldg(a.R + (static_cast<long long>(g0 + g) * dh + 4 * p + i) * d + j) : 0.0f;
      }
    }
  }
  // the state of each row tile (cell threads)
  float cst[kMaxTiles], nst[kMaxTiles], mst[kMaxTiles];
#pragma unroll
  for (int rt = 0; rt < kMaxTiles; ++rt) {
    cst[rt] = nst[rt] = mst[rt] = 0.0f;
    const int row = rt * kRows + b;
    if (cell_thread && rt < tiles && row < Bn) {
      const long long si = static_cast<long long>(row) * d + jj;
      if (a.c_prev != nullptr) cst[rt] = __ldg(a.c_prev + si);
      if (a.n_prev != nullptr) nst[rt] = __ldg(a.n_prev + si);
      if (a.m_prev != nullptr) mst[rt] = __ldg(a.m_prev + si);
    }
  }

  for (int t = 0; t < S; ++t) {
    if (t > 0) grid_barrier(count, base + static_cast<unsigned long long>(t) * gridDim.x);
    for (int rt = 0; rt < tiles; ++rt) {
      const int b0 = rt * kRows;
      const int nb = min(kRows, Bn - b0);
      if (t > 0) {  // h_{t−1}, written by every block of this launch: group g
        // holds head g of every warp group's gates (heads g, g + G, …)
        const long long stride = static_cast<long long>(S) * d;
        const float* src = a.hs + b0 * stride + static_cast<long long>(t - 1) * d;
#pragma unroll
        for (int g = 0; g < G; ++g) {
#pragma unroll
          for (int hd = g; hd < 4; hd += G) stage_cols_async<kT>(hsm, src, stride, nb, d, hd * dh, dh);
          cp_async_commit();
        }
      }
      const bool cell = cell_thread && b < nb;
      const long long st = static_cast<long long>(b0 + b) * S + t;
      float wxv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (cell) {
#pragma unroll
        for (int gt = 0; gt < 4; ++gt) wxv[gt] = __ldg(a.wx + st * 4 * d + gt * d + jj);
      }
      if (t == 0) {
        stage_rows<kT>(hsm, a.h_prev == nullptr ? nullptr : a.h_prev + b0 * a.h_stride,
                       a.h_stride, nb, d);
      }
      float acc[G][kRows];
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[g][r] = 0.0f;
      }
      // gate g0 + g reads head g0 + g of h: its products start once that head is in
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (t > 0) cp_async_wait(G - 1 - g);
        __syncthreads();
        const float* hg = hsm + (g0 + g) * dh;
#pragma unroll
        for (int c = 0; c < kResChunks; ++c) {
          const int p = q + c * kGroups;
          if (kFull || p < chunks) {
            const int k = p << 2;
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              const float4 h4 = *reinterpret_cast<const float4*>(hg + r * d + k);
              float s = acc[g][r];
              s = fmaf(h4.x, rv[c][g][0], s);
              s = fmaf(h4.y, rv[c][g][1], s);
              s = fmaf(h4.z, rv[c][g][2], s);
              s = fmaf(h4.w, rv[c][g][3], s);
              acc[g][r] = s;
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) part[((q * 4 + g0 + g) * kRows + r) * kUnits + u] = acc[g][r];
      }
      __syncthreads();
      if (cell) {
        float c_p = 0.0f, n_p = 0.0f, m_p = 0.0f;
#pragma unroll
        for (int i = 0; i < kMaxTiles; ++i) {
          if (i == rt) {
            c_p = cst[i];
            n_p = nst[i];
            m_p = mst[i];
          }
        }
        float g[4], c, n, m, h;
        gate_sums(part, wxv, b, v, g);
        fwd_cell(g, c_p, n_p, m_p, c, n, m, h);
#pragma unroll
        for (int i = 0; i < kMaxTiles; ++i) {
          if (i == rt) {
            cst[i] = c;
            nst[i] = n;
            mst[i] = m;
          }
        }
        a.hs[st * d + jj] = h;
        if (a.g_save != nullptr) {
#pragma unroll
          for (int gt = 0; gt < 4; ++gt) a.g_save[st * 4 * d + gt * d + jj] = g[gt];
          a.c_save[st * d + jj] = c;
          a.n_save[st * d + jj] = n;
          a.m_save[st * d + jj] = m;
        }
      }
      // the next tile's staging rewrites hsm and its products part: every
      // thread is past this tile's products, and the next tile's first
      // __syncthreads keeps its products behind this tile's cells
    }
  }
#pragma unroll
  for (int rt = 0; rt < kMaxTiles; ++rt) {
    const int row = rt * kRows + b;
    if (cell_thread && rt < tiles && row < Bn) {
      const long long si = static_cast<long long>(row) * d + jj;
      a.c_out[si] = cst[rt];
      a.n_out[si] = nst[rt];
      a.m_out[si] = mst[rt];
    }
  }
}

struct BwdArgs {
  const float* dhs;  // (B, S, d)
  const float* R;    // (4, d/4, d)
  const float* g;    // saved (B, S, 4d)
  const float* cs;   // saved (B, S, d) each
  const float* ns;
  const float* ms;
  float* dG;         // (B, S, 4d): writes [:, t]
  float* dc;         // (B, d) each: the carries (read from t = S−2 on; per-step route)
  float* dn;
  float* dm;
  int B, S, d, t;
};

// the saved inputs of the cell's backward at (row, unit j), step t
struct BwdCellIn {
  float dh, zr, ir, fr, orr, c, n, m, c_p, n_p, m_p;
};

__device__ __forceinline__ BwdCellIn bwd_cell_inputs(const BwdArgs& a, long long st, int j, int t) {
  const int d = a.d;
  BwdCellIn x;
  x.dh = __ldg(a.dhs + st * d + j);
  const float* g = a.g + st * 4 * d + j;
  x.zr = __ldg(g);
  x.ir = __ldg(g + d);
  x.fr = __ldg(g + 2 * d);
  x.orr = __ldg(g + 3 * d);
  x.c = __ldg(a.cs + st * d + j);
  x.n = __ldg(a.ns + st * d + j);
  x.m = __ldg(a.ms + st * d + j);
  x.c_p = x.n_p = x.m_p = 0.0f;
  if (t > 0) {  // the sequence starts from the zero state
    x.c_p = __ldg(a.cs + (st - 1) * d + j);
    x.n_p = __ldg(a.ns + (st - 1) * d + j);
    x.m_p = __ldg(a.ms + (st - 1) * d + j);
  }
  return x;
}

__global__ void __launch_bounds__(kThreads) slstm_bwd_step(BwdArgs a) {
  extern __shared__ float4 smem4[];
  float* gsm = reinterpret_cast<float*>(smem4);  // [kRows][d]: dg_{t+1}'s head block
  const int d = a.d, dh = d >> 2, S = a.S, t = a.t;
  float* red = gsm + kRows * d;                  // [2][kUnits][kRows]
  const int u0 = blockIdx.x * kUnits;
  const int hd = u0 / dh, k0 = u0 - hd * dh;
  const int b0 = blockIdx.y * kRows;
  const int nb = min(kRows, a.B - b0);
  const int tid = threadIdx.x;
  const bool later = t + 1 < S;  // dg_{t+1} exists
  // the cell's thread (row b, unit v) reads its inputs before the products
  const int b = tid / kUnits, v = tid % kUnits;
  const bool cell = tid < kRows * kUnits && b < nb;
  const long long row = static_cast<long long>(b0 + b);
  const int j = u0 + v;
  const long long st = row * S + t;
  const long long si = row * d + j;
  BwdCellIn x{};
  float dc = 0.0f, dn = 0.0f, dm = 0.0f;
  if (cell) {
    x = bwd_cell_inputs(a, st, j, t);
    if (later) {
      dc = a.dc[si];
      dn = a.dn[si];
      dm = a.dm[si];
    }
  }
  if (later) {
    const long long stride = static_cast<long long>(S) * 4 * d;
    stage_rows<kThreads>(gsm, a.dG + static_cast<long long>(b0) * stride +
                                  static_cast<long long>(t + 1) * 4 * d + static_cast<long long>(hd) * d,
                         stride, nb, d);
    __syncthreads();
    const int warp = tid >> 5, lane = tid & 31;
    const int half = warp >> 2;
    const int uw = (warp & 3) * kBwdUnitsPerWarp;
    float acc[kBwdUnitsPerWarp][kRows];
#pragma unroll
    for (int i = 0; i < kBwdUnitsPerWarp; ++i) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[i][r] = 0.0f;
    }
    const float* rr = a.R + (static_cast<long long>(hd) * dh + k0 + uw) * d;
    const int e_end = (half + 1) * (d >> 1);
#pragma unroll 4
    for (int e = half * (d >> 1) + lane; e < e_end; e += 32) {
      float rv[kBwdUnitsPerWarp];
#pragma unroll
      for (int i = 0; i < kBwdUnitsPerWarp; ++i) rv[i] = __ldg(rr + static_cast<long long>(i) * d + e);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float gv = gsm[r * d + e];
#pragma unroll
        for (int i = 0; i < kBwdUnitsPerWarp; ++i) acc[i][r] = fmaf(gv, rv[i], acc[i][r]);
      }
    }
    bwd_reduce(acc, red, half, uw, lane);
    __syncthreads();
  }

  if (!cell) return;
  if (later) {
    x.dh = __fadd_rn(x.dh, __fadd_rn(red[v * kRows + b], red[(kUnits + v) * kRows + b]));
  }
  float dg[4];
  bwd_cell(x.dh, x.zr, x.ir, x.fr, x.orr, x.c, x.n, x.m, x.c_p, x.n_p, x.m_p, dc, dn, dm, dg);
  float* out = a.dG + st * 4 * d + j;
#pragma unroll
  for (int gt = 0; gt < 4; ++gt) out[gt * d] = dg[gt];
  a.dc[si] = dc;
  a.dn[si] = dn;
  a.dm[si] = dm;
}

// The backward's resident route: grid d/16; the carries stay in registers
// (a.dc, a.dn, a.dm unused); the arrival counter and its value before this
// launch.  kFull: d = kResMaxD, every lane owns kResSteps e's of each unit
// (no guard in the products).
template <bool kFull>
__global__ void __launch_bounds__(kThreads, 1)
    slstm_bwd_resident(BwdArgs a, unsigned long long* count, unsigned long long base) {
  constexpr int U = kBwdUnitsPerWarp, kT = kThreads;
  extern __shared__ float4 smem4[];
  float* gsm = reinterpret_cast<float*>(smem4);  // [kRows][d]: dg_{t+1}'s head block, one tile
  const int d = a.d, dh = d >> 2, S = a.S, Bn = a.B;
  float* red = gsm + kRows * d;                  // [2][kUnits][kRows]
  const int tiles = (Bn + kRows - 1) / kRows;
  const int u0 = blockIdx.x * kUnits;
  const int hd = u0 / dh, k0 = u0 - hd * dh;
  const int tid = threadIdx.x;
  const int b = tid / kUnits, v = tid % kUnits;  // a cell thread's (row of the tile, unit)
  const bool cell_thread = tid < kRows * kUnits;
  const int j = u0 + v;
  const int warp = tid >> 5, lane = tid & 31;
  const int half = warp >> 2;
  const int uw = (warp & 3) * U;
  const int steps = d >> 6;                      // e's a lane takes per unit: d/2 over 32 lanes
  const int e0 = half * (d >> 1) + lane;

  // R's rows of this warp's 4 units at the lane's e's, once
  float rv[kResSteps][U];
  {
    const float* rr = a.R + (static_cast<long long>(hd) * dh + k0 + uw) * d;
#pragma unroll
    for (int m = 0; m < kResSteps; ++m) {
#pragma unroll
      for (int i = 0; i < U; ++i) {
        rv[m][i] = m < steps ? __ldg(rr + static_cast<long long>(i) * d + e0 + 32 * m) : 0.0f;
      }
    }
  }
  // the carries of each row tile (cell threads): zero after the last step
  float dcs[kMaxTiles], dns[kMaxTiles], dms[kMaxTiles];
#pragma unroll
  for (int rt = 0; rt < kMaxTiles; ++rt) dcs[rt] = dns[rt] = dms[rt] = 0.0f;

  // a staging group: 256 e's of each half (fewer at d < 2,048), in m order
  const int group_cols = 32 * (kResSteps / kStageGroups);
  for (int t = S - 1; t >= 0; --t) {
    const bool later = t + 1 < S;  // dg_{t+1} exists
    if (later) grid_barrier(count, base + static_cast<unsigned long long>(S - 1 - t) * gridDim.x);
    for (int rt = 0; rt < tiles; ++rt) {
      const int b0 = rt * kRows;
      const int nb = min(kRows, Bn - b0);
      if (later) {  // dg_{t+1}: written by every block of this launch
        const long long stride = static_cast<long long>(S) * 4 * d;
        const float* src = a.dG + b0 * stride + static_cast<long long>(t + 1) * 4 * d +
                           static_cast<long long>(hd) * d;
#pragma unroll
        for (int gq = 0; gq < kStageGroups; ++gq) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int c0 = hf * (d >> 1) + gq * group_cols;
            const int n = min(group_cols, max(0, (d >> 1) - gq * group_cols));
            if (n > 0) stage_cols_async<kT>(gsm, src, stride, nb, d, c0, n);
          }
          cp_async_commit();
        }
      }
      const bool cell = cell_thread && b < nb;
      const long long st = static_cast<long long>(b0 + b) * S + t;
      BwdCellIn x{};
      if (cell) x = bwd_cell_inputs(a, st, j, t);
      if (later) {
        float acc[U][kRows];
#pragma unroll
        for (int i = 0; i < U; ++i) {
#pragma unroll
          for (int r = 0; r < kRows; ++r) acc[i][r] = 0.0f;
        }
#pragma unroll
        for (int gq = 0; gq < kStageGroups; ++gq) {
          cp_async_wait(kStageGroups - 1 - gq);
          __syncthreads();
#pragma unroll
          for (int mm = 0; mm < kResSteps / kStageGroups; ++mm) {
            const int m = gq * (kResSteps / kStageGroups) + mm;
            if (kFull || m < steps) {
              const int e = e0 + 32 * m;
#pragma unroll
              for (int r = 0; r < kRows; ++r) {
                const float gv = gsm[r * d + e];
#pragma unroll
                for (int i = 0; i < U; ++i) acc[i][r] = fmaf(gv, rv[m][i], acc[i][r]);
              }
            }
          }
        }
        bwd_reduce(acc, red, half, uw, lane);
        __syncthreads();
      }
      if (cell) {
        if (later) {
          x.dh = __fadd_rn(x.dh, __fadd_rn(red[v * kRows + b], red[(kUnits + v) * kRows + b]));
        }
        float dc = 0.0f, dn = 0.0f, dm = 0.0f;
#pragma unroll
        for (int i = 0; i < kMaxTiles; ++i) {
          if (i == rt) {
            dc = dcs[i];
            dn = dns[i];
            dm = dms[i];
          }
        }
        float dg[4];
        bwd_cell(x.dh, x.zr, x.ir, x.fr, x.orr, x.c, x.n, x.m, x.c_p, x.n_p, x.m_p, dc, dn, dm,
                 dg);
#pragma unroll
        for (int i = 0; i < kMaxTiles; ++i) {
          if (i == rt) {
            dcs[i] = dc;
            dns[i] = dn;
            dms[i] = dm;
          }
        }
        float* out = a.dG + st * 4 * d + j;
#pragma unroll
        for (int gt = 0; gt < 4; ++gt) out[gt * d] = dg[gt];
      }
      // as the forward: the next tile's first __syncthreads orders the reuse
      // of gsm and red
    }
  }
}

// A cooperative grid of ``blocks`` blocks that passes ``barriers`` grid
// barriers and does nothing else: the barrier's cost, timed by the caller.
__global__ void __launch_bounds__(kThreads, 1)
    slstm_barrier_probe(int barriers, unsigned long long* count, unsigned long long base) {
  for (int k = 1; k <= barriers; ++k) {
    grid_barrier(count, base + static_cast<unsigned long long>(k) * gridDim.x);
  }
}

int fwd_smem(int d) { return (kRows * d + kGroups * 4 * kRows * kUnits) * 4; }
int bwd_smem(int d) { return (kRows * d + 2 * kUnits * kRows) * 4; }

// the shared memory a block may have on the current card, granted to
// ``kernel`` once per card
template <typename K>
cudaError_t grant(svc::PerDevice<int>& limit, svc::PerDevice<cudaError_t>& granted, K kernel,
                  int need) {
  const int most = limit.get([](int dev) {
    int v = 0;
    cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    return v;
  });
  if (need > most) return cudaErrorInvalidValue;
  return svc::allow_smem(granted, kernel, most);
}

// One cooperative launch of ``kernel`` (a resident route's: its arguments,
// the arrival counter and its count before the launch) over d/16 blocks of
// ``threads``, its shared memory granted once per card in ``granted`` (the
// caller's table for this kernel).  The runtime's refusal of the grid is
// returned and cleared.
template <typename Args>
int launch_resident(void (*kernel)(Args, unsigned long long*, unsigned long long),
                    svc::PerDevice<int>& limit, svc::PerDevice<cudaError_t>& granted, Args& P,
                    unsigned long long* count, unsigned long long base, int smem, int threads,
                    cudaStream_t stream) {
  cudaError_t err = grant(limit, granted, kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&P, &count, &base};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(P.d / kUnits),
                                    dim3(threads), args, smem, stream);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the caller raises
    return static_cast<int>(err);
  }
  return 0;
}

bool bad_shape(int B, int S, int d) {
  return B < 1 || S < 1 || d < 4 * kUnits || d % (4 * kUnits) != 0;
}

// what the resident route does not take (the wrappers' route rule keeps
// such shapes on the per-step route)
bool bad_resident(int B, int S, int d, const void* written) {
  return bad_shape(B, S, d) || d > kResMaxD || (B + kRows - 1) / kRows > kMaxTiles ||
         (reinterpret_cast<uintptr_t>(written) & 15) != 0;
}

bool bad_saves(const float* g_save, const float* c_save, const float* n_save,
               const float* m_save) {
  return (g_save == nullptr) != (c_save == nullptr) || (g_save == nullptr) != (n_save == nullptr) ||
         (g_save == nullptr) != (m_save == nullptr);
}

}  // namespace

// wx (B, S, 4d), R (4, d/4, d); h0, c0, n0, m0 (B, d) each or null (the
// zero state); hs (B, S, d); c_out, n_out, m_out (B, d) each: the state
// after the last step (h's is hs[:, S−1]); g_save (B, S, 4d) and c_save,
// n_save, m_save (B, S, d) each, all null or all given.  All float32,
// contiguous, on the current card.  Enqueues S launches on ``stream``.
extern "C" int svc_slstm_fwd(const float* wx, const float* R, const float* h0, const float* c0,
                             const float* n0, const float* m0, float* hs, float* c_out,
                             float* n_out, float* m_out, float* g_save, float* c_save,
                             float* n_save, float* m_save, int B, int S, int d, void* stream) {
  if (bad_shape(B, S, d) || bad_saves(g_save, c_save, n_save, m_save)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static svc::PerDevice<int> limit;
  static svc::PerDevice<cudaError_t> granted;
  const int smem = fwd_smem(d);
  cudaError_t err = grant(limit, granted, slstm_fwd_step, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(d / kUnits, (B + kRows - 1) / kRows);
  FwdArgs P{wx, R, nullptr, 0, nullptr, nullptr, nullptr, hs, c_out, n_out, m_out,
            g_save, c_save, n_save, m_save, B, S, d, 0};
  for (int t = 0; t < S; ++t) {
    P.t = t;
    if (t == 0) {
      P.h_prev = h0;
      P.h_stride = d;
      P.c_prev = c0;
      P.n_prev = n0;
      P.m_prev = m0;
    } else {
      P.h_prev = hs + static_cast<long long>(t - 1) * d;
      P.h_stride = static_cast<long long>(S) * d;
      P.c_prev = c_out;
      P.n_prev = n_out;
      P.m_prev = m_out;
    }
    slstm_fwd_step<<<grid, kThreads, smem, s>>>(P);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// svc_slstm_fwd's arguments on the resident route, plus ``count``, the
// (card, stream)'s arrival counter (uint64, zeroed once), and ``base``, the
// arrivals it has counted before this launch (the wrapper adds (S − 1)·d/16
// after each).  hs must be 16-byte aligned; B ≤ 32, d ≤ 2,048.  One
// cooperative launch on ``stream``; the runtime's refusal of the grid is
// returned.
extern "C" int svc_slstm_fwd_resident(const float* wx, const float* R, const float* h0,
                                      const float* c0, const float* n0, const float* m0,
                                      float* hs, float* c_out, float* n_out, float* m_out,
                                      float* g_save, float* c_save, float* n_save, float* m_save,
                                      int B, int S, int d, unsigned long long* count,
                                      unsigned long long base, void* stream) {
  if (bad_resident(B, S, d, hs) || bad_saves(g_save, c_save, n_save, m_save) || count == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static svc::PerDevice<int> limit;
  static svc::PerDevice<cudaError_t> granted_full, granted;
  FwdArgs P{wx, R, h0, d, c0, n0, m0, hs, c_out, n_out, m_out,
            g_save, c_save, n_save, m_save, B, S, d, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d == kResMaxD ? launch_resident(slstm_fwd_resident<true>, limit, granted_full, P, count,
                                         base, fwd_smem(d), kResFwdThreads, s)
                       : launch_resident(slstm_fwd_resident<false>, limit, granted, P, count, base,
                                         fwd_smem(d), kResFwdThreads, s);
}

// dhs (B, S, d), R (4, d/4, d); g_save (B, S, 4d), c_save, n_save, m_save
// (B, S, d) each: the forward's, from the zero state; dG (B, S, 4d): gets
// every step's dg (the gradient of wx); dc, dn, dm (B, d) each: scratch for
// the carries (need no zeroing).  All float32,
// contiguous, on the current card.  Enqueues S launches on ``stream``.
extern "C" int svc_slstm_bwd(const float* dhs, const float* R, const float* g_save,
                             const float* c_save, const float* n_save, const float* m_save,
                             float* dG, float* dc, float* dn, float* dm, int B, int S, int d,
                             void* stream) {
  if (bad_shape(B, S, d)) return static_cast<int>(cudaErrorInvalidValue);
  static svc::PerDevice<int> limit;
  static svc::PerDevice<cudaError_t> granted;
  const int smem = bwd_smem(d);
  cudaError_t err = grant(limit, granted, slstm_bwd_step, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(d / kUnits, (B + kRows - 1) / kRows);
  BwdArgs P{dhs, R, g_save, c_save, n_save, m_save, dG, dc, dn, dm, B, S, d, 0};
  for (int t = S - 1; t >= 0; --t) {
    P.t = t;
    slstm_bwd_step<<<grid, kThreads, smem, s>>>(P);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// svc_slstm_bwd's arguments on the resident route, without the carries'
// scratch (they stay in registers), plus ``count`` and ``base`` as
// svc_slstm_fwd_resident's.  dG must be 16-byte aligned; B ≤ 32,
// d ≤ 2,048.  One cooperative launch on ``stream``.
extern "C" int svc_slstm_bwd_resident(const float* dhs, const float* R, const float* g_save,
                                      const float* c_save, const float* n_save,
                                      const float* m_save, float* dG, int B, int S, int d,
                                      unsigned long long* count, unsigned long long base,
                                      void* stream) {
  if (bad_resident(B, S, d, dG) || count == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  static svc::PerDevice<int> limit;
  static svc::PerDevice<cudaError_t> granted_full, granted;
  BwdArgs P{dhs, R, g_save, c_save, n_save, m_save, dG, nullptr, nullptr, nullptr, B, S, d, 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return d == kResMaxD ? launch_resident(slstm_bwd_resident<true>, limit, granted_full, P, count,
                                         base, bwd_smem(d), kThreads, s)
                       : launch_resident(slstm_bwd_resident<false>, limit, granted, P, count, base,
                                         bwd_smem(d), kThreads, s);
}

// ``barriers`` grid barriers across ``blocks`` cooperative blocks of the
// resident route's shape and nothing else, on ``stream``; ``count`` and
// ``base`` as above (the caller adds barriers·blocks after).
extern "C" int svc_slstm_barrier_probe(int blocks, int barriers, unsigned long long* count,
                                       unsigned long long base, void* stream) {
  if (blocks < 1 || barriers < 0 || count == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&barriers, &count, &base};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(slstm_barrier_probe), dim3(blocks), dim3(kThreads), args, 0,
      static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  return 0;
}
