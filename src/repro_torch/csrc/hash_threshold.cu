// η_{a,m} hash-threshold mask (SVC §4.4), and apply_hash's narrowed
// validity in the same pass.
//
// Replaces the Pallas kernel src/repro/kernels/hash_threshold/kernel.py:
// hash_threshold_tiles (body _hash_threshold_kernel).  The TPU version tiles
// key columns as (64, 128) VMEM blocks and writes the mask; the caller then
// ANDs it into the relation's validity in a second pass.
//
//   out[i] = u(h(cols[i])) < thresh                    (valid == nullptr)
//   out[i] = valid[i] && u(h(cols[i])) < thresh        (apply_hash without a pin)
//
// Bound: device memory.  Per row it reads 4 bytes per key column (and one
// byte of validity when given) and writes one byte, with ~10 integer
// operations per column in between, far below the card's integer rate.
//
// Two routes; the wrapper picks one from the pointers:
//   vector — every key column 16-byte aligned, the validity and the output
//     4-byte aligned.  A lane loads four rows of each column as one 16-byte
//     word, consecutive lanes on consecutive words, and issues kWords such
//     words per column before it hashes any of them; it stores its four mask
//     bytes as one 4-byte word, so a warp writes 128 contiguous bytes.  A
//     persistent grid (as many blocks as fit on the card) strides over the
//     words; block 0 takes the last n mod 4 rows, one a thread.
//   scalar — any alignment (a column viewed at a storage offset, columns of
//     different alignments): one row a thread in a grid-stride loop.
//
// The threshold arrives as the float32 value of m: the JAX package compares
// u < f32(m), and comparing against a double would flip hashes that land
// just under the threshold.
#include "svc_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWords = 4;  // 16-byte words of each column a lane keeps in flight

// one key column folded into a row's hash
__device__ __forceinline__ uint32_t fold(uint32_t h, int32_t key) {
  return svc::splitmix32(h ^ svc::splitmix32(static_cast<uint32_t>(key)));
}

template <int N>
__device__ __forceinline__ bool row_keep(const svc::KeyCols& cols, int64_t i, uint32_t seed_mix,
                                         float thresh) {
  uint32_t h = seed_mix;
#pragma unroll
  for (int j = 0; j < N; ++j) h = fold(h, __ldg(cols.c[j] + i));
  return svc::u01(h) < thresh;
}

template <int N, bool V>
__global__ void __launch_bounds__(kThreads)
hash_threshold_vec(svc::KeyCols cols, const uint8_t* __restrict__ valid, int64_t n,
                   uint32_t seed_mix, float thresh, uint8_t* __restrict__ out) {
  const int64_t words = n >> 2;
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads * kWords;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads * kWords + threadIdx.x;
       base < words; base += step) {
    int4 key[kWords][N];
    uint32_t ok[kWords];
#pragma unroll
    for (int u = 0; u < kWords; ++u) {
      const int64_t w = base + static_cast<int64_t>(u) * kThreads;
      const bool in = w < words;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        key[u][j] = in ? __ldg(reinterpret_cast<const int4*>(cols.c[j]) + w) : make_int4(0, 0, 0, 0);
      }
      if (V) ok[u] = in ? __ldg(reinterpret_cast<const uint32_t*>(valid) + w) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kWords; ++u) {
      const int64_t w = base + static_cast<int64_t>(u) * kThreads;
      if (w < words) {
        uint32_t h0 = seed_mix, h1 = seed_mix, h2 = seed_mix, h3 = seed_mix;
#pragma unroll
        for (int j = 0; j < N; ++j) {
          h0 = fold(h0, key[u][j].x);
          h1 = fold(h1, key[u][j].y);
          h2 = fold(h2, key[u][j].z);
          h3 = fold(h3, key[u][j].w);
        }
        // row 4w + r is byte r of the little-endian word
        uint32_t bits = (svc::u01(h0) < thresh ? 1u : 0u) | (svc::u01(h1) < thresh ? 1u << 8 : 0u) |
                        (svc::u01(h2) < thresh ? 1u << 16 : 0u) |
                        (svc::u01(h3) < thresh ? 1u << 24 : 0u);
        if (V) bits &= __vcmpne4(ok[u], 0u);  // 0xFF in each byte whose row is valid
        reinterpret_cast<uint32_t*>(out)[w] = bits;
      }
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < (n & 3)) {
    const int64_t i = (words << 2) + threadIdx.x;
    out[i] = (!V || valid[i] != 0) && row_keep<N>(cols, i, seed_mix, thresh) ? 1 : 0;
  }
}

template <int N, bool V>
__global__ void __launch_bounds__(kThreads)
hash_threshold_scalar(svc::KeyCols cols, const uint8_t* __restrict__ valid, int64_t n,
                      uint32_t seed_mix, float thresh, uint8_t* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    out[i] = (!V || valid[i] != 0) && row_keep<N>(cols, i, seed_mix, thresh) ? 1 : 0;
  }
}

template <int N, bool V>
int launch(const svc::KeyCols& cols, const uint8_t* valid, int64_t n, uint32_t seed_mix,
           float thresh, uint8_t* out, bool vec, cudaStream_t s) {
  if (!vec) {
    hash_threshold_scalar<N, V><<<svc::grid_for(n, kThreads), kThreads, 0, s>>>(
        cols, valid, n, seed_mix, thresh, out);
    return static_cast<int>(cudaGetLastError());
  }
  static svc::PerDevice<int> cards;  // blocks each card holds at once
  const int resident = cards.get([](int dev) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, hash_threshold_vec<N, V>, kThreads, 0);
    return sms * (per_sm < 1 ? 1 : per_sm);
  });
  const int64_t chunk = static_cast<int64_t>(kThreads) * kWords;
  int64_t grid = ((n >> 2) + chunk - 1) / chunk;
  if (grid > resident) grid = resident;
  if (grid < 1) grid = 1;  // n < 4: block 0 takes the rows
  hash_threshold_vec<N, V><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
      cols, valid, n, seed_mix, thresh, out);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int launch_cols(const svc::KeyCols& cols, const uint8_t* valid, int64_t n, uint32_t seed_mix,
                float thresh, uint8_t* out, bool vec, cudaStream_t s) {
  return valid != nullptr ? launch<N, true>(cols, valid, n, seed_mix, thresh, out, vec, s)
                          : launch<N, false>(cols, valid, n, seed_mix, thresh, out, vec, s);
}

}  // namespace

// c0..c3: the key columns (ncols of them, the rest null); valid: the bool
// validity to narrow, or null for the bare mask; vec: 1 for the vector route
// (the wrapper checks its alignments), 0 for the scalar one.
extern "C" int svc_hash_threshold(const int32_t* c0, const int32_t* c1, const int32_t* c2,
                                  const int32_t* c3, int ncols, int64_t n, uint32_t seed_mix,
                                  float thresh, const uint8_t* valid, uint8_t* out, int vec,
                                  void* stream) {
  const svc::KeyCols cols{{c0, c1, c2, c3}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (ncols) {
    case 1: return launch_cols<1>(cols, valid, n, seed_mix, thresh, out, vec != 0, s);
    case 2: return launch_cols<2>(cols, valid, n, seed_mix, thresh, out, vec != 0, s);
    case 3: return launch_cols<3>(cols, valid, n, seed_mix, thresh, out, vec != 0, s);
    case 4: return launch_cols<4>(cols, valid, n, seed_mix, thresh, out, vec != 0, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
