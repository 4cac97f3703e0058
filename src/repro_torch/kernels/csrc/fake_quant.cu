// The search phase's Eq. 5 weight mixture in one pass, for Hopper (sm_90a).
//
// Replaces the Pallas kernel `_kernel` of src/repro/kernels/fake_quant.py
// (`fused_mix_2d`, public wrapper `ops.fused_mix`):
//
//   out[n, k] = sum_p gamma[n, p] * FQ(w[n, k]; max(alpha[n], 1e-6), b_p)
//   FQ(w; a, b) = rint(clip(w, -a, a) / step) * step,  step = a / (2^(b-1) - 1)
//
// for w (N, K) f32 or bf16 (widened to f32 on load), gamma (N, |P|) f32,
// alpha (N,) f32 and out (N, K) f32, with 1 to 3 bit-widths from {2, 4, 8}
// passed as arguments.
//
// Bitwise contract.  The kernel equals its plain version
// (`kernels/ref.fused_mix_ref`, the reference's eager oracle op for op) bit
// for bit, so every rounding is spelled out: `fmaxf` for the 1e-6 floor; the
// clip as `fminf(fmaxf(w, -a), a)` (torch.minimum(torch.maximum(...)));
// IEEE divisions `__fdiv_rn` for the step and for y / step (never a product
// with a reciprocal); `rintf`, which rounds half to even like torch.round;
// `__fmul_rn` for r * step and gamma * q; `__fadd_rn` into an accumulator
// that starts at 0.0f, for p = 0, 1, 2 in turn.  nvcc contracts a * b + c
// into an FMA by default (`--fmad=true`), which would round once where
// PyTorch rounds twice; the intrinsics are never contracted.
//
// What bounds it.  One read of w and one write of out, 8 (f32) or 6 (bf16)
// bytes an element, against 3 divisions, 3 rounds and ~12 other f32
// operations an element: at 3.35 TB/s and 67 TFLOP/s f32 the bytes and the
// operations take about as long, so the pass is bound by its bytes only if
// the divisions stay off the critical path.
//
// Design (simple and right first).  One elementwise pass: a grid-stride loop
// over 64-bit flat indices (N * K exceeds 2^31 for a large weight), sized to
// fill every SM once.  Where K % 4 == 0 and the pointers allow, each step
// loads 4 contiguous elements of one row (a float4, or 8 bytes of bf16) and
// stores a float4, with streaming hints (each byte is touched once); else
// one element a step.  A thread tracks its row and column by adding the
// grid's stride (no 64-bit division in the loop) and reloads alpha, gamma
// and the |P| steps only when its row changes: once a row a thread.
//
// C interface (bound with ctypes): launches on the given stream, allocates
// nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Levels {
  float half[3];   // 2^(b_p - 1) - 1 per bit-width, exact in f32
};

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);   // bf16 -> f32, exact
}

template <int NB>
__device__ __forceinline__ float mix(float w, float a, const float (&g)[NB],
                                     const float (&step)[NB]) {
  const float y = fminf(fmaxf(w, -a), a);
  float acc = 0.0f;
#pragma unroll
  for (int p = 0; p < NB; ++p) {
    const float q = __fmul_rn(rintf(__fdiv_rn(y, step[p])), step[p]);
    acc = __fadd_rn(acc, __fmul_rn(g[p], q));
  }
  return acc;
}

// 4 contiguous elements of w at vector index i (i * 4 elements in).
__device__ __forceinline__ void load4(const float* w, int64_t i, float (&v)[4]) {
  const float4 t = __ldcs(reinterpret_cast<const float4*>(w) + i);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const uint16_t* w, int64_t i, float (&v)[4]) {
  const uint2 t = __ldcs(reinterpret_cast<const uint2*>(w) + i);
  v[0] = __uint_as_float(t.x << 16);
  v[1] = __uint_as_float(t.x & 0xffff0000u);
  v[2] = __uint_as_float(t.y << 16);
  v[3] = __uint_as_float(t.y & 0xffff0000u);
}

// VEC elements per item: items are rows of Kv = K / VEC, item i at row
// i / Kv, column i % Kv.
template <typename T, int NB, int VEC>
__global__ void __launch_bounds__(kThreads)
fused_mix_kernel(const T* __restrict__ w, const float* __restrict__ gamma,
                 const float* __restrict__ alpha, int64_t N, int64_t Kv, Levels lv,
                 float* __restrict__ out) {
  const int64_t total = N * Kv;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  int64_t row = i / Kv, col = i - row * Kv;
  const int64_t srow = stride / Kv, scol = stride - srow * Kv;
  int64_t cached = -1;
  float a = 0.0f, g[NB], step[NB];
  for (; i < total; i += stride) {
    if (row != cached) {
      cached = row;
      a = fmaxf(__ldg(alpha + row), 1e-6f);
#pragma unroll
      for (int p = 0; p < NB; ++p) {
        g[p] = __ldg(gamma + row * NB + p);
        step[p] = __fdiv_rn(a, lv.half[p]);
      }
    }
    if (VEC == 4) {
      float v[4];
      load4(w, i, v);
      float4 o;
      o.x = mix<NB>(v[0], a, g, step);
      o.y = mix<NB>(v[1], a, g, step);
      o.z = mix<NB>(v[2], a, g, step);
      o.w = mix<NB>(v[3], a, g, step);
      __stcs(reinterpret_cast<float4*>(out) + i, o);
    } else {
      out[i] = mix<NB>(widen(w[i]), a, g, step);
    }
    col += scol;
    row += srow;
    if (col >= Kv) {
      col -= Kv;
      ++row;
    }
  }
}

template <typename T, int NB, int VEC>
void launch(const T* w, const float* gamma, const float* alpha, int64_t N, int64_t K,
            Levels lv, float* out, cudaStream_t st) {
  static int per_sm = 0;                 // resident blocks an SM, once per instance
  if (per_sm == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_mix_kernel<T, NB, VEC>,
                                                  kThreads, 0);
    if (per_sm < 1) per_sm = 1;
  }
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t Kv = K / VEC;
  const int64_t blocks = (N * Kv + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(per_sm) * (sms > 0 ? sms : 1);
  const unsigned grid = static_cast<unsigned>(blocks < cap ? blocks : cap);
  fused_mix_kernel<T, NB, VEC><<<grid, kThreads, 0, st>>>(w, gamma, alpha, N, Kv, lv, out);
}

template <typename T, int VEC>
void launch_nb(int nb, const T* w, const float* gamma, const float* alpha, int64_t N,
               int64_t K, Levels lv, float* out, cudaStream_t st) {
  switch (nb) {
    case 1: launch<T, 1, VEC>(w, gamma, alpha, N, K, lv, out, st); break;
    case 2: launch<T, 2, VEC>(w, gamma, alpha, N, K, lv, out, st); break;
    default: launch<T, 3, VEC>(w, gamma, alpha, N, K, lv, out, st); break;
  }
}

template <typename T>
void launch_t(int nb, const void* w, const float* gamma, const float* alpha, int64_t N,
              int64_t K, Levels lv, float* out, cudaStream_t st) {
  const T* wt = static_cast<const T*>(w);
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(w) % (4 * sizeof(T)) == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    launch_nb<T, 4>(nb, wt, gamma, alpha, N, K, lv, out, st);
  } else {
    launch_nb<T, 1>(nb, wt, gamma, alpha, N, K, lv, out, st);
  }
}

}  // namespace

extern "C" int fused_mix_f32(const void* w, int w_bf16, const void* gamma, const void* alpha,
                             long long N, long long K, int nb, int b0, int b1, int b2,
                             void* out, void* stream) {
  const int bits[3] = {b0, b1, b2};
  if (N <= 0 || K <= 0 || nb < 1 || nb > 3) return static_cast<int>(cudaErrorInvalidValue);
  Levels lv{{0.0f, 0.0f, 0.0f}};
  for (int p = 0; p < nb; ++p) {
    if (bits[p] != 2 && bits[p] != 4 && bits[p] != 8) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    lv.half[p] = static_cast<float>((1 << (bits[p] - 1)) - 1);
  }
  const auto* g = static_cast<const float*>(gamma);
  const auto* a = static_cast<const float*>(alpha);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (w_bf16) {
    launch_t<uint16_t>(nb, w, g, a, N, K, lv, o, st);
  } else {
    launch_t<float>(nb, w, g, a, N, K, lv, o, st);
  }
  return static_cast<int>(cudaGetLastError());
}
