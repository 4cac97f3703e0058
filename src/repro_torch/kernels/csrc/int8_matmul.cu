// Dynamic int8 x int8 -> int32 GEMM with a fused dequant epilogue, for
// Hopper (sm_90a): the three products of every dense layer of int8 training.
//
// Replaces the Pallas kernel `_int8_mm_kernel` of
// src/repro/kernels/int8_matmul.py (`scaled_int8_mm`):
//
//   out[m, n] = float(sum_k a[m, k] * b[n, k]) * sa[m] * sb[n]
//
// with a (M, K) and b (N, K) int8, both contiguous along K, and the epilogue
// `__fmul_rn(__fmul_rn(__int2float_rn(acc), sa[m]), sb[n])` in that order.
// The int32 sum of int8 products is exact in any order (K <= 133144 keeps
// |sum| <= 127 * 127 * K below 2^31; the wrapper raises above it), so this
// kernel equals its plain version and the reference bitwise, whatever its
// tiling or split of K.
//
// What bounds it.  The forward and grad-input products of training are
// short-K and very tall (M = B * Ho * Wo up to 65536, K <= 576, N <= 576):
// a few MB of int8 in, an f32 (M, N) out, and under a GFLOP each, so at the
// card's rates they are bound by their bytes, the f32 output first.  The
// grad-weight product is tall-K (K = B * Ho * Wo) with a small (c_out, C*k*k)
// output: an output-tile grid alone gives one to a few blocks on 132 SMs.
//
// Design (simple and right first; tensor cores, TMA and a deeper pipeline are
// later work).  One block of 256 threads computes a BM x BN tile, each thread
// 4 x 4 outputs with `__dp4a` over 4-byte words.  K is walked in 32-byte
// chunks staged through shared memory as int32 words, k-major, so that every
// row of a and of b is read from device memory once per block (not once per
// output).  The tile width follows N (16, 32 or 64 columns; BM = 4096 / BN)
// so that the narrow products do not compute mostly padding.  When the tile
// grid is small against the card and K is deep, the wrapper splits K over
// `gridDim.z`: each block adds its int32 partial sums into a zeroed int32
// workspace with `atomicAdd` (integer addition is exact, so the order of the
// atomics does not matter), and a second kernel applies the epilogue once.
//
// Edges are masked in the kernel, not padded: ragged M and N (rows and
// columns past the end read as 0 and are not stored), any K >= 1 (bytes past
// the end of the K range read as 0), M = 1.  Rows whose length is a multiple
// of 4 bytes load whole words; other rows are assembled byte by byte.
//
// C interface (bound with ctypes): launches on the given stream, allocates
// nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 32;              // K bytes staged per chunk
constexpr int kBKW = kBK / 4;        // ... as int32 words
constexpr int kTM = 4, kTN = 4;      // outputs per thread

// One 4-byte word of row `row` at byte offset `k` (k is a multiple of 4):
// bytes at or past `kend`, and rows at or past `rows`, read as 0.
template <bool VEC>
__device__ __forceinline__ int load_word(const int8_t* __restrict__ base, int64_t row,
                                         int64_t rows, int64_t ld, int64_t k, int64_t kend) {
  if (row >= rows || k >= kend) return 0;
  const int8_t* p = base + row * ld + k;
  if (VEC) return __ldg(reinterpret_cast<const int*>(p));   // kend - k >= 4 here
  int word = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (k + e < kend) word |= static_cast<int>(static_cast<uint8_t>(__ldg(p + e))) << (8 * e);
  }
  return word;
}

__device__ __forceinline__ float dequant(int acc, float sa, float sb) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), sa), sb);
}

template <int BM, int BN, bool VEC>
__global__ void __launch_bounds__(kThreads)
int8_mm_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
               const float* __restrict__ sa, const float* __restrict__ sb,
               int64_t M, int N, int64_t K, int64_t kchunk,
               int* __restrict__ ws, float* __restrict__ out) {
  constexpr int kThreadsN = BN / kTN;
  constexpr int kThreadsM = kThreads / kThreadsN;
  static_assert(kThreadsM * kTM == BM, "tile shape");
  __shared__ int as[kBKW][BM];
  __shared__ int bs[kBKW][BN];

  const int tid = threadIdx.x;
  const int tx = tid % kThreadsN, ty = tid / kThreadsN;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  const int64_t kbeg = static_cast<int64_t>(blockIdx.z) * kchunk;
  const int64_t kend = kbeg + kchunk < K ? kbeg + kchunk : K;

  int acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0;

  for (int64_t k0 = kbeg; k0 < kend; k0 += kBK) {
    for (int w = tid; w < BM * kBKW; w += kThreads) {
      const int r = w / kBKW, kw = w % kBKW;
      as[kw][r] = load_word<VEC>(a, m0 + r, M, K, k0 + 4 * kw, kend);
    }
    for (int w = tid; w < BN * kBKW; w += kThreads) {
      const int r = w / kBKW, kw = w % kBKW;
      bs[kw][r] = load_word<VEC>(b, n0 + r, N, K, k0 + 4 * kw, kend);
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < kBKW; ++kw) {
      int av[kTM], bv[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) av[i] = as[kw][ty + i * kThreadsM];
#pragma unroll
      for (int j = 0; j < kTN; ++j) bv[j] = bs[kw][tx + j * kThreadsN];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int64_t m = m0 + ty + i * kThreadsM;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = n0 + tx + j * kThreadsN;
      if (n >= N) continue;
      if (ws != nullptr) {
        atomicAdd(ws + m * N + n, acc[i][j]);
      } else {
        out[m * N + n] = dequant(acc[i][j], sa[m], sb[n]);
      }
    }
  }
}

// The epilogue of a split-K product, once over the summed workspace.
__global__ void __launch_bounds__(kThreads)
dequant_kernel(const int* __restrict__ ws, const float* __restrict__ sa,
               const float* __restrict__ sb, int64_t M, int N, float* __restrict__ out) {
  const int64_t total = M * N;
  for (int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; idx < total;
       idx += static_cast<int64_t>(gridDim.x) * kThreads) {
    out[idx] = dequant(ws[idx], sa[idx / N], sb[idx % N]);
  }
}

template <int BN, bool VEC>
void launch(const int8_t* a, const int8_t* b, const float* sa, const float* sb, int64_t M,
            int N, int64_t K, int64_t kchunk, int* ws, float* out, cudaStream_t stream) {
  constexpr int BM = 4096 / BN;
  const dim3 grid(static_cast<unsigned>((M + BM - 1) / BM),
                  static_cast<unsigned>((N + BN - 1) / BN),
                  static_cast<unsigned>((K + kchunk - 1) / kchunk));
  int8_mm_kernel<BM, BN, VEC><<<grid, kThreads, 0, stream>>>(a, b, sa, sb, M, N, K, kchunk,
                                                            ws, out);
}

template <int BN>
void launch_bn(bool vec, const int8_t* a, const int8_t* b, const float* sa, const float* sb,
               int64_t M, int N, int64_t K, int64_t kchunk, int* ws, float* out,
               cudaStream_t stream) {
  if (vec) {
    launch<BN, true>(a, b, sa, sb, M, N, K, kchunk, ws, out, stream);
  } else {
    launch<BN, false>(a, b, sa, sb, M, N, K, kchunk, ws, out, stream);
  }
}

}  // namespace

// a (M, K) int8, b (N, K) int8, sa (M,) f32, sb (N,) f32 -> out (M, N) f32.
// bn: the tile width, 16, 32 or 64.  kchunk: the K range of one block, a
// multiple of 32; below K, ws must be a zeroed (M, N) int32 workspace.
extern "C" int i8mm_f32(const void* a, const void* b, const void* sa, const void* sb,
                        long long M, int N, long long K, int bn, long long kchunk,
                        void* ws, void* out, void* stream) {
  const auto* a8 = static_cast<const int8_t*>(a);
  const auto* b8 = static_cast<const int8_t*>(b);
  const auto* saf = static_cast<const float*>(sa);
  const auto* sbf = static_cast<const float*>(sb);
  auto* o = static_cast<float*>(out);
  auto* w = static_cast<int*>(ws);
  auto st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || kchunk <= 0 || kchunk % kBK != 0 ||
      (kchunk < K) != (w != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(a) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 4 == 0;
  switch (bn) {
    case 16: launch_bn<16>(vec, a8, b8, saf, sbf, M, N, K, kchunk, w, o, st); break;
    case 32: launch_bn<32>(vec, a8, b8, saf, sbf, M, N, K, kchunk, w, o, st); break;
    case 64: launch_bn<64>(vec, a8, b8, saf, sbf, M, N, K, kchunk, w, o, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (w != nullptr) {
    const int64_t total = M * static_cast<int64_t>(N);
    const int64_t blocks = (total + kThreads - 1) / kThreads;
    const unsigned grid = static_cast<unsigned>(blocks < 4096 ? blocks : 4096);
    dequant_kernel<<<grid, kThreads, 0, st>>>(w, saf, sbf, M, N, o);
  }
  return static_cast<int>(cudaGetLastError());
}
