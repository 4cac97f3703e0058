// One-token GQA decode attention over the channel-wise packed KV ring, for
// Hopper (sm_90a).
//
// Replaces the Pallas kernel `_kernel` of src/repro/kernels/decode_attention.py
// (via `decode_attention`, one `pallas_call` over the grid (B, KV)).  Inputs:
// q (B, KV, rep, hd) f32 or bf16; the packed rings k/v (B, KV, S, NB) uint8,
// contiguous channel groups at 2/4/8 bits (value j of byte b at bit j*bits,
// sign-extended); their scales (B, KV, S, G) f32, one per token and group;
// pos (B,) int32.  Output (B, KV, rep, hd) in f32 or bf16 ("out" below).
//
// Arithmetic, the reference's order of roundings:
//   k[t][d] = out(f32(code) * scale[t][group of d])      (dequant, rounded)
//   s[r][t] = dot(q[r], k[t]) summed in f32, then divided by sqrt(hd) as
//             an f32 division.  With q and k both bf16 the reference's dot
//             is bf16-typed, but it is cast to f32 at once and XLA folds
//             that cast into the dot: the reference as it runs keeps the
//             f32 sum, and so does this kernel.
//   mask t > pos[b] with -inf; softmax over the row in f32:
//   w[r][t] = out(expf(s - max) / sum)                     (normalised, rounded)
//   o[r][d] = out(sum_t w[r][t] * v[t][d])                 (f32 sums, one rounding)
// An online (flash) softmax would round unnormalised weights, which is not
// the reference's rounding, so the row takes two passes: pass 1 writes the
// scores to a scratch buffer (B, KV, rep, S) f32 that the wrapper allocates
// (the block reads them back from L2), then the max and the sum; pass 2
// forms the normalised weights and the value dot.  expf, IEEE division:
// this file is compiled without --use_fast_math.
//
// What bounds it.  Decode attention moves the packed ring entries <= pos
// (NB bytes plus G scales a token, K and V) and does 4 * rep * hd flops a
// token: at rep <= 16 that is far below the card's ~20 flops a byte, so the
// bound is the bytes of the entries <= pos.  The kernel reads only those
// (the loops stop at pos[b]).  The design is the simplest that keeps
// the reference's roundings: one block of 256 threads per (b, kv-head),
// a warp per token in pass 1 (lanes over channels, a shuffle reduction per
// query head), and in pass 2 a tile of 32 tokens dequantised into shared
// memory that each thread contracts for its (r, d) outputs in ascending t.
// At qwen1.5-4b's 4 slots x 20 kv-heads that is 80 blocks on 132 SMs;
// splitting S across blocks is later work.
//
// C interface (bound with ctypes): the entry point launches on the given
// stream, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;            // tokens per pass-2 tile
constexpr int kMaxGroups = 4;
constexpr int kMaxHeadDim = 256;     // channels a lane holds in pass 1: hd / 32
constexpr int kMaxOutPerThread = 8;  // rep * hd <= 2048

struct Spec {
  int groups;
  int bits[kMaxGroups];
  int sizes[kMaxGroups];
};

template <bool BF16>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

template <bool BF16>
__device__ __forceinline__ float load_q(const void* q, int64_t i) {
  if constexpr (BF16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(q)[i]);
  } else {
    return static_cast<const float*>(q)[i];
  }
}

// Channel d's place in a packed row: byte (bits 0-15), shift (16-19),
// bits (20-23), group (24-31).
__device__ __forceinline__ int channel_code(const Spec& spec, int d) {
  int lo = 0, byte0 = 0;
  for (int g = 0; g < spec.groups; ++g) {
    const int bits = spec.bits[g];
    const int f = 8 / bits;
    if (d < lo + spec.sizes[g]) {
      const int local = d - lo;
      return (byte0 + local / f) | ((local % f) * bits << 16) | (bits << 20) | (g << 24);
    }
    lo += spec.sizes[g];
    byte0 += spec.sizes[g] / f;
  }
  return 0;
}

// f32(code) * scale, rounded to the out type: one dequantised ring value.
template <bool OUT_BF16>
__device__ __forceinline__ float dequant(const uint8_t* __restrict__ row,
                                         const float* __restrict__ scales, int code) {
  const int byte = row[code & 0xFFFF];
  const int shift = (code >> 16) & 0xF;
  const int bits = (code >> 20) & 0xF;
  int v;
  if (bits == 8) {
    v = static_cast<int8_t>(byte);
  } else {
    const int u = (byte >> shift) & ((1 << bits) - 1);
    v = u >= (1 << (bits - 1)) ? u - (1 << bits) : u;
  }
  return round_to<OUT_BF16>(static_cast<float>(v) * scales[code >> 24]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reduction of one value per thread (sum or max); every thread
// gets the result.  `red` holds kWarps floats.
template <bool MAX>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  v = MAX ? warp_max(v) : warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r = MAX ? fmaxf(r, red[w]) : r + red[w];
  return r;
}

// grid (KV, B): block (g, b) serves kv-head g of slot b and its rep query heads.
template <bool Q_BF16, bool OUT_BF16>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const void* __restrict__ q, const uint8_t* __restrict__ kp,
                        const float* __restrict__ ks, const uint8_t* __restrict__ vp,
                        const float* __restrict__ vs, const int* __restrict__ pos,
                        float* __restrict__ scratch, void* __restrict__ out, int KV, int rep,
                        int hd, int S, int NB, Spec spec, float sqrt_hd) {
  extern __shared__ float smem[];
  float* qs = smem;                              // rep * hd
  float* vt = qs + rep * hd;                     // kTile * hd, dequantised V tile
  float* wt = vt + kTile * hd;                   // rep * kTile, normalised weights
  float* row_max = wt + rep * kTile;             // rep
  float* row_sum = row_max + rep;                // rep
  float* red = row_sum + rep;                    // kWarps
  int* codes = reinterpret_cast<int*>(red + kWarps);   // hd

  const int g = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int64_t head = int64_t(b) * KV + g;      // (b, g) ring index
  const int p = pos[b];
  const int n = p < 0 ? 0 : (p + 1 < S ? p + 1 : S);   // entries <= pos
  const uint8_t* krows = kp + head * S * NB;
  const uint8_t* vrows = vp + head * S * NB;
  const float* kscales = ks + head * S * spec.groups;
  const float* vscales = vs + head * S * spec.groups;
  float* sc = scratch + head * rep * S;

  for (int i = tid; i < rep * hd; i += kThreads) qs[i] = load_q<Q_BF16>(q, head * rep * hd + i);
  for (int d = tid; d < hd; d += kThreads) codes[d] = channel_code(spec, d);
  __syncthreads();

  // pass 1: raw scores, one warp per token
  const int per_lane = (hd + 31) / 32;
  for (int t = warp; t < n; t += kWarps) {
    float kv[kMaxHeadDim / 32];
#pragma unroll
    for (int i = 0; i < kMaxHeadDim / 32; ++i) {
      const int d = lane + 32 * i;
      kv[i] = (i < per_lane && d < hd)
                  ? dequant<OUT_BF16>(krows + int64_t(t) * NB, kscales + int64_t(t) * spec.groups,
                                      codes[d])
                  : 0.0f;
    }
    for (int r = 0; r < rep; ++r) {
      float part = 0.0f;
#pragma unroll
      for (int i = 0; i < kMaxHeadDim / 32; ++i) {
        const int d = lane + 32 * i;
        if (i < per_lane && d < hd) part = fmaf(qs[r * hd + d], kv[i], part);
      }
      const float s = warp_sum(part);
      if (lane == 0) sc[int64_t(r) * S + t] = s / sqrt_hd;
    }
  }
  __syncthreads();

  // the row's max and the sum of exp(s - max), per query head
  for (int r = 0; r < rep; ++r) {
    float m = -INFINITY;
    for (int t = tid; t < n; t += kThreads) m = fmaxf(m, sc[int64_t(r) * S + t]);
    m = block_reduce<true>(m, red);
    float l = 0.0f;
    for (int t = tid; t < n; t += kThreads) l += expf(sc[int64_t(r) * S + t] - m);
    l = block_reduce<false>(l, red);
    if (tid == 0) {
      row_max[r] = m;
      row_sum[r] = l;
    }
  }
  __syncthreads();

  // pass 2: normalised weights and the value dot, kTile tokens at a time
  float acc[kMaxOutPerThread];
#pragma unroll
  for (int j = 0; j < kMaxOutPerThread; ++j) acc[j] = 0.0f;
  for (int t0 = 0; t0 < n; t0 += kTile) {
    const int tc = n - t0 < kTile ? n - t0 : kTile;
    for (int i = tid; i < tc * hd; i += kThreads) {
      const int t = t0 + i / hd, d = i % hd;
      vt[i] = dequant<OUT_BF16>(vrows + int64_t(t) * NB, vscales + int64_t(t) * spec.groups,
                                codes[d]);
    }
    for (int i = tid; i < rep * tc; i += kThreads) {
      const int r = i / tc, t = i % tc;
      const float e = expf(sc[int64_t(r) * S + t0 + t] - row_max[r]);
      wt[r * kTile + t] = round_to<OUT_BF16>(e / row_sum[r]);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kMaxOutPerThread; ++j) {
      const int o = tid + j * kThreads;
      if (o < rep * hd) {
        const int r = o / hd, d = o % hd;
        for (int t = 0; t < tc; ++t) acc[j] = fmaf(wt[r * kTile + t], vt[t * hd + d], acc[j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kMaxOutPerThread; ++j) {
    const int o = tid + j * kThreads;
    if (o < rep * hd) {
      // no entry <= pos: the reference's softmax of an all -inf row is NaN
      const float v = n == 0 ? NAN : acc[j];
      if constexpr (OUT_BF16) {
        static_cast<__nv_bfloat16*>(out)[head * rep * hd + o] = __float2bfloat16_rn(v);
      } else {
        static_cast<float*>(out)[head * rep * hd + o] = v;
      }
    }
  }
}

template <bool Q_BF16, bool OUT_BF16>
void launch(const void* q, const uint8_t* kp, const float* ks, const uint8_t* vp,
            const float* vs, const int* pos, float* scratch, void* out, int B, int KV,
            int rep, int hd, int S, int NB, const Spec& spec, float sqrt_hd, size_t smem,
            cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(KV), static_cast<unsigned>(B));
  decode_attention_kernel<Q_BF16, OUT_BF16><<<grid, kThreads, smem, stream>>>(
      q, kp, ks, vp, vs, pos, scratch, out, KV, rep, hd, S, NB, spec, sqrt_hd);
}

}  // namespace

// q_bf16 / out_bf16: 1 for bf16, 0 for f32.  bits/sizes: the G <= 4 channel
// groups (unused entries ignored).  scratch: (B, KV, rep, S) f32.
extern "C" int decode_attention_f32acc(
    const void* q, int q_bf16, const void* k_packed, const void* k_scales,
    const void* v_packed, const void* v_scales, const void* pos, void* scratch, void* out,
    int out_bf16, int B, int KV, int rep, int hd, int S, int NB, int G, int b0, int b1,
    int b2, int b3, int n0, int n1, int n2, int n3, float sqrt_hd, void* stream) {
  if (G < 1 || G > kMaxGroups || hd > kMaxHeadDim || rep * hd > kMaxOutPerThread * kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Spec spec{G, {b0, b1, b2, b3}, {n0, n1, n2, n3}};
  const size_t smem = sizeof(float) * (size_t(rep) * hd + size_t(kTile) * hd
                                       + size_t(rep) * kTile + 2 * size_t(rep) + kWarps)
                      + sizeof(int) * size_t(hd);
  const auto* kp = static_cast<const uint8_t*>(k_packed);
  const auto* vp = static_cast<const uint8_t*>(v_packed);
  const auto* ksc = static_cast<const float*>(k_scales);
  const auto* vsc = static_cast<const float*>(v_scales);
  const auto* ps = static_cast<const int*>(pos);
  auto* scr = static_cast<float*>(scratch);
  auto st = static_cast<cudaStream_t>(stream);
  if (q_bf16 && out_bf16) {
    launch<true, true>(q, kp, ksc, vp, vsc, ps, scr, out, B, KV, rep, hd, S, NB, spec, sqrt_hd,
                       smem, st);
  } else if (q_bf16) {
    launch<true, false>(q, kp, ksc, vp, vsc, ps, scr, out, B, KV, rep, hd, S, NB, spec, sqrt_hd,
                        smem, st);
  } else if (out_bf16) {
    launch<false, true>(q, kp, ksc, vp, vsc, ps, scr, out, B, KV, rep, hd, S, NB, spec, sqrt_hd,
                        smem, st);
  } else {
    launch<false, false>(q, kp, ksc, vp, vsc, ps, scr, out, B, KV, rep, hd, S, NB, spec,
                         sqrt_hd, smem, st);
  }
  return static_cast<int>(cudaGetLastError());
}
