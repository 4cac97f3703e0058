// Packed mixed-precision GEMMs for Hopper (sm_90a), f32 in, f32 out.
//
// Two kernels share one device routine, `tile_gemm`:
//
// * `fused_kernel` replaces the Pallas kernel `_fused_kernel` of
//   src/repro/kernels/quant_matmul.py (2-D form, `quant_matmul_fused_2d`,
//   dequant_first=False).  One launch serves a whole deployed weight whose
//   output tiles mix 2-, 4- and 8-bit channels: one block per
//   (M tile, output tile t).  The block reads its tile's bit-width and byte
//   offset from a small int32 table (built once at deploy, kept on the
//   QTensor) and dispatches to the bit-templated routine; this replaces the
//   Python-unrolled `pl.when` chain of the TPU kernel.
// * `pergroup_kernel` replaces the Pallas kernel `_kernel`
//   (`quant_matmul_2d`): one precision group, packed (N, K/f), any K.
//
// Arithmetic.  y[m, n] = (sum_k x[m, k] * w_int[n, k]) * scale[n].  Each
// output's K terms are accumulated by one thread in ascending k with fmaf,
// starting from 0, and multiplied by the scale after the loop.  Both
// kernels run the same routine, so a weight served through the fused layout
// equals its per-group form bitwise (the port's version of the TPU kernels'
// bit-exactness contract).
//
// What bounds it.  At the MLPerf-Tiny serving shapes (K <= 2048, N <= 128 per
// tile) the arithmetic intensity is low: the f32 activations dominate the
// bytes, the packed weights are a few KB.  The TPU kernel kept all of Kp in
// VMEM; a Hopper block has 227 KB of shared memory, so here K is walked in
// BK = 32 chunks staged through shared memory (x transposed, weights
// unpacked to f32 once per block and chunk), with the next chunk's global
// loads in flight while the current one is computed: a first version that
// issued one load at a time ran at a fifth of the card's memory rate.  The
// design is the plain SIMT register-tiled GEMM: each thread owns RM x CN
// outputs.  Tensor cores (wgmma), TMA and a deeper ring are later work.
//
// Edges handled in the kernel, not by padding: ragged M (rows >= M read as
// 0 and are not stored), x narrower than K (columns >= Kx read as 0, which
// is the reference's zero padding of x to Kp), ragged N (per-group), any
// power-of-two tile width 1..128, and tile byte segments at any offset.
//
// C interface (bound with ctypes): each entry point launches on the given
// stream, allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 32;  // K chunk staged through shared memory

// Thread layout for a block that computes BM x TILE_N outputs.
template <int TILE_N>
struct Geom {
  static constexpr int kThreadsN = TILE_N < 16 ? TILE_N : 16;
  static constexpr int kCN = TILE_N / kThreadsN;        // columns per thread
  static constexpr int kThreadsM = kThreads / kThreadsN;
  static constexpr int kBM = kThreadsM * 4 < 256 ? kThreadsM * 4 : 256;
  static constexpr int kRM = kBM / kThreadsM;           // rows per thread
  static constexpr int kXStride = kBM + 1;              // padded: no bank conflicts
  static constexpr int kXIters = kBM * kBK / kThreads;  // x loads per thread per chunk
};

template <int BITS>
__device__ __forceinline__ float unpack_value(uint8_t byte, int j) {
  if constexpr (BITS == 8) {
    return static_cast<float>(static_cast<int8_t>(byte));
  } else {
    constexpr int kMask = (1 << BITS) - 1;
    constexpr int kSign = 1 << (BITS - 1);
    const int u = (byte >> (j * BITS)) & kMask;
    return static_cast<float>(u >= kSign ? u - (1 << BITS) : u);
  }
}

// acc[i][j] += x[row i] * w[col j] at one k: the only arithmetic of the
// K loop, so every output is one ascending fmaf chain.
template <int TILE_N>
__device__ __forceinline__ void fma_step(const float* xs, const float* ws, int kk, int tm, int tn,
                                         float (&acc)[Geom<TILE_N>::kRM][Geom<TILE_N>::kCN]) {
  using G = Geom<TILE_N>;
  float xv[G::kRM], wv[G::kCN];
#pragma unroll
  for (int i = 0; i < G::kRM; ++i) xv[i] = xs[kk * G::kXStride + tm + i * G::kThreadsM];
#pragma unroll
  for (int j = 0; j < G::kCN; ++j) wv[j] = ws[kk * TILE_N + tn + j * G::kThreadsN];
#pragma unroll
  for (int i = 0; i < G::kRM; ++i)
#pragma unroll
    for (int j = 0; j < G::kCN; ++j) acc[i][j] = fmaf(xv[i], wv[j], acc[i][j]);
}

// Chunk staging.  Every global load of a chunk is issued before any of
// its values is used (unrolled into registers), and the next chunk's loads
// are issued before the current chunk's FMAs, so they are in flight while
// the block computes.
template <int TILE_N>
__device__ __forceinline__ void load_x(const float* __restrict__ x, int64_t M, int Kx,
                                       int64_t m0, int k0, float (&xr)[Geom<TILE_N>::kXIters]) {
  using G = Geom<TILE_N>;
#pragma unroll
  for (int it = 0; it < G::kXIters; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    const int64_t m = m0 + idx / kBK;
    const int k = k0 + idx % kBK;
    xr[it] = (m < M && k < Kx) ? x[m * Kx + k] : 0.0f;
  }
}

template <int TILE_N>
__device__ __forceinline__ void store_x(float* xs, const float (&xr)[Geom<TILE_N>::kXIters]) {
  using G = Geom<TILE_N>;
#pragma unroll
  for (int it = 0; it < G::kXIters; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    xs[(idx % kBK) * G::kXStride + idx / kBK] = xr[it];   // transposed to k-major
  }
}

template <int BITS, int TILE_N>
struct WChunk {
  static constexpr int kBytes = kBK / (8 / BITS);           // packed bytes per row
  static constexpr int kIters = (TILE_N * kBytes + kThreads - 1) / kThreads;
};

template <int BITS, int TILE_N>
__device__ __forceinline__ void load_w(const uint8_t* __restrict__ w, int w_row_bytes,
                                       int n_valid, int k0,
                                       uint8_t (&wr)[WChunk<BITS, TILE_N>::kIters]) {
  using C = WChunk<BITS, TILE_N>;
#pragma unroll
  for (int it = 0; it < C::kIters; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    const int n = idx % TILE_N;
    const int kb = k0 / (8 / BITS) + idx / TILE_N;
    wr[it] = (idx < TILE_N * C::kBytes && n < n_valid && kb < w_row_bytes)
                 ? w[int64_t(n) * w_row_bytes + kb] : uint8_t(0);
  }
}

template <int BITS, int TILE_N>
__device__ __forceinline__ void store_w(float* ws,
                                        const uint8_t (&wr)[WChunk<BITS, TILE_N>::kIters]) {
  using C = WChunk<BITS, TILE_N>;
  constexpr int F = 8 / BITS;
#pragma unroll
  for (int it = 0; it < C::kIters; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    if (idx < TILE_N * C::kBytes) {
      const int n = idx % TILE_N;
      const int b = idx / TILE_N;
#pragma unroll
      for (int j = 0; j < F; ++j) ws[(b * F + j) * TILE_N + n] = unpack_value<BITS>(wr[it], j);
    }
  }
}

// One (BM x TILE_N) output tile of y = (x @ w_int^T) * scale.
//   x      (M, Kx) row-major f32; columns Kx..K-1 read as 0
//   w      TILE_N rows of K/F packed bytes each (row stride w_row_bytes);
//          rows >= n_valid read as 0 and are not stored
//   out    row stride ldo; column 0 of the tile at `out`
template <int BITS, int TILE_N>
__device__ __forceinline__ void tile_gemm(
    const float* __restrict__ x, int64_t M, int Kx, int K,
    const uint8_t* __restrict__ w, int w_row_bytes, int n_valid,
    const float* __restrict__ scale, float* __restrict__ out, int64_t ldo,
    int64_t m0, float* xs, float* ws) {
  using G = Geom<TILE_N>;
  const int tid = threadIdx.x;
  const int tn = tid % G::kThreadsN;
  const int tm = tid / G::kThreadsN;

  float acc[G::kRM][G::kCN];
#pragma unroll
  for (int i = 0; i < G::kRM; ++i)
#pragma unroll
    for (int j = 0; j < G::kCN; ++j) acc[i][j] = 0.0f;

  float xr[G::kXIters];
  uint8_t wr[WChunk<BITS, TILE_N>::kIters];
  load_x<TILE_N>(x, M, Kx, m0, 0, xr);
  load_w<BITS, TILE_N>(w, w_row_bytes, n_valid, 0, wr);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    store_x<TILE_N>(xs, xr);
    store_w<BITS, TILE_N>(ws, wr);
    __syncthreads();
    if (k0 + kBK < K) {                 // next chunk in flight during the FMAs
      load_x<TILE_N>(x, M, Kx, m0, k0 + kBK, xr);
      load_w<BITS, TILE_N>(w, w_row_bytes, n_valid, k0 + kBK, wr);
    }
    const int kc = K - k0 < kBK ? K - k0 : kBK;
    if (kc == kBK) {
#pragma unroll 8
      for (int kk = 0; kk < kBK; ++kk) fma_step<TILE_N>(xs, ws, kk, tm, tn, acc);
    } else {
      for (int kk = 0; kk < kc; ++kk) fma_step<TILE_N>(xs, ws, kk, tm, tn, acc);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < G::kRM; ++i) {
    const int64_t m = m0 + tm + i * G::kThreadsM;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < G::kCN; ++j) {
      const int n = tn + j * G::kThreadsN;
      if (n < n_valid) out[m * ldo + n] = __fmul_rn(acc[i][j], scale[n]);
    }
  }
}

// grid (ceil(M / BM), T): block (i, t) computes rows [i*BM, i*BM+BM) of
// output tile t.  table[2t] = bits, table[2t+1] = byte offset of the tile.
template <int TILE_N>
__global__ void __launch_bounds__(kThreads)
fused_kernel(const float* __restrict__ x, int64_t M, int Kx, int Kp,
             const uint8_t* __restrict__ packed, const int* __restrict__ table,
             const float* __restrict__ scales, float* __restrict__ out, int64_t ldo) {
  using G = Geom<TILE_N>;
  __shared__ float xs[kBK * G::kXStride];
  __shared__ float ws[kBK * TILE_N];
  const int t = blockIdx.y;
  const int bits = table[2 * t];
  const uint8_t* w = packed + table[2 * t + 1];
  const int64_t m0 = int64_t(blockIdx.x) * G::kBM;
  const float* s = scales + int64_t(t) * TILE_N;
  float* o = out + int64_t(t) * TILE_N;
  if (bits == 2) {
    tile_gemm<2, TILE_N>(x, M, Kx, Kp, w, Kp / 4, TILE_N, s, o, ldo, m0, xs, ws);
  } else if (bits == 4) {
    tile_gemm<4, TILE_N>(x, M, Kx, Kp, w, Kp / 2, TILE_N, s, o, ldo, m0, xs, ws);
  } else {
    tile_gemm<8, TILE_N>(x, M, Kx, Kp, w, Kp, TILE_N, s, o, ldo, m0, xs, ws);
  }
}

constexpr int kPerGroupTileN = 64;

// grid (ceil(M / BM), ceil(N / 64)); packed (N, K / F), out (M, N).
template <int BITS>
__global__ void __launch_bounds__(kThreads)
pergroup_kernel(const float* __restrict__ x, int64_t M, int Kx, int K,
                const uint8_t* __restrict__ packed, int N,
                const float* __restrict__ scale, float* __restrict__ out) {
  using G = Geom<kPerGroupTileN>;
  constexpr int F = 8 / BITS;
  __shared__ float xs[kBK * G::kXStride];
  __shared__ float ws[kBK * kPerGroupTileN];
  const int n0 = blockIdx.y * kPerGroupTileN;
  const int n_valid = N - n0 < kPerGroupTileN ? N - n0 : kPerGroupTileN;
  const int64_t m0 = int64_t(blockIdx.x) * G::kBM;
  tile_gemm<BITS, kPerGroupTileN>(x, M, Kx, K, packed + int64_t(n0) * (K / F), K / F,
                                  n_valid, scale + n0, out + n0, N, m0, xs, ws);
}

template <int TILE_N>
void launch_fused(const float* x, int64_t M, int Kx, int Kp, const uint8_t* packed,
                  const int* table, const float* scales, int T, float* out,
                  cudaStream_t stream) {
  using G = Geom<TILE_N>;
  const dim3 grid(static_cast<unsigned>((M + G::kBM - 1) / G::kBM), static_cast<unsigned>(T));
  fused_kernel<TILE_N><<<grid, kThreads, 0, stream>>>(x, M, Kx, Kp, packed, table, scales,
                                                      out, int64_t(T) * TILE_N);
}

template <int BITS>
void launch_pergroup(const float* x, int64_t M, int Kx, int K, const uint8_t* packed,
                     int N, const float* scale, float* out, cudaStream_t stream) {
  using G = Geom<kPerGroupTileN>;
  const dim3 grid(static_cast<unsigned>((M + G::kBM - 1) / G::kBM),
                  static_cast<unsigned>((N + kPerGroupTileN - 1) / kPerGroupTileN));
  pergroup_kernel<BITS><<<grid, kThreads, 0, stream>>>(x, M, Kx, K, packed, N, scale, out);
}

}  // namespace

extern "C" int qmm_fused_f32(const void* x, long long M, int Kx, int Kp,
                             const void* packed, const void* table, const void* scales,
                             int T, int tile_n, void* out, void* stream) {
  const auto* xf = static_cast<const float*>(x);
  const auto* p = static_cast<const uint8_t*>(packed);
  const auto* tb = static_cast<const int*>(table);
  const auto* s = static_cast<const float*>(scales);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (tile_n) {
    case 1: launch_fused<1>(xf, M, Kx, Kp, p, tb, s, T, o, st); break;
    case 2: launch_fused<2>(xf, M, Kx, Kp, p, tb, s, T, o, st); break;
    case 4: launch_fused<4>(xf, M, Kx, Kp, p, tb, s, T, o, st); break;
    case 8: launch_fused<8>(xf, M, Kx, Kp, p, tb, s, T, o, st); break;
    case 16: launch_fused<16>(xf, M, Kx, Kp, p, tb, s, T, o, st); break;
    case 32: launch_fused<32>(xf, M, Kx, Kp, p, tb, s, T, o, st); break;
    case 64: launch_fused<64>(xf, M, Kx, Kp, p, tb, s, T, o, st); break;
    case 128: launch_fused<128>(xf, M, Kx, Kp, p, tb, s, T, o, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int qmm_pergroup_f32(const void* x, long long M, int Kx, int K,
                                const void* packed, int N, const void* scale, int bits,
                                void* out, void* stream) {
  const auto* xf = static_cast<const float*>(x);
  const auto* p = static_cast<const uint8_t*>(packed);
  const auto* s = static_cast<const float*>(scale);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  switch (bits) {
    case 2: launch_pergroup<2>(xf, M, Kx, K, p, N, s, o, st); break;
    case 4: launch_pergroup<4>(xf, M, Kx, K, p, N, s, o, st); break;
    case 8: launch_pergroup<8>(xf, M, Kx, K, p, N, s, o, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
