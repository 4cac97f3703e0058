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
// the reference's rounding, so the whole row's max and sum come first.
// expf, IEEE division: this file is compiled without --use_fast_math.
//
// What bounds it.  Decode attention moves the packed ring entries <= pos
// (NB bytes plus G scales a token, K and V) and does 4 * rep * hd flops a
// token: at rep <= 16 that is far below the card's ~20 flops a byte, so the
// bound is the bytes of the entries <= pos, a few microseconds for qwen's
// 4 slots.  One block per (slot, kv-head) would put 80 blocks on 132 SMs
// for qwen1.5-4b, each walking its entries one after another, ~90x that
// bound.  The design:
// * The ring split across blocks: grid (KV, B, P), P from
//   `decode_attention.k4_plan`, a function of the shapes alone (pos lives on
//   the card).  Block p takes the 32-token tiles p, p + P, p + 2P, ... that
//   lie below pos[b] + 1, so any pos spreads its entries evenly over the P
//   blocks; a block with none skips the work but joins every barrier.
// * One cooperative launch (cudaLaunchCooperativeKernel) in four phases
//   with grid-wide barriers (cooperative_groups::this_grid().sync()), the
//   reference's roundings kept:
//   1. scores of the block's tiles into scratch (B, KV, rep, S), and the
//      block's max per query head;
//   2. M = the max of the P block maxes, in block order; the block's
//      sum of expf(s - M);
//   3. L = the P block sums added in block order; the block's normalised
//      weights out(expf(s - M) / L) and its partial value dot;
//   4. the P partial value dots of each output added in block order and
//      rounded once.
//   So only the order of the sums differs from the plain version, which
//   `decode_attention.error_bound` allows.  With P = 1 the launch is a
//   plain one and the barriers are the block's own.
// * Inside a block (256 threads): a tile's packed rows (and scales) are
//   staged by cp.async, 16 bytes a copy, into a ring of 4 stages, so three
//   tiles are in flight while one is used (V's first three during phase 2);
//   in phase 1 eight lanes take a token, each decoding its channels (d =
//   lane + 8 i) into registers from the staged bytes with the channel codes
//   worked out once at the start; phase 3 dequantises the V tile once into
//   shared memory and the value dot covers all rep * hd outputs with the
//   block's threads, several threads an output (over interleaved tokens,
//   added in a fixed order) where rep * hd < 256, its sums in shared
//   memory.  Heads of hd <= 128 hold 4 blocks an SM (64 registers a
//   thread), wider ones 2.
//
// C interface (bound with ctypes): the entry point launches on the given
// stream, allocates nothing and returns a cudaError_t: the launch's, or
// cudaErrorCooperativeLaunchTooLarge when the P > 1 blocks cannot all be
// resident at once (the wrapper raises; nothing falls back).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;            // tokens a tile
constexpr int kLanes = 8;            // lanes a token in pass 1
constexpr int kStages = 4;           // cp.async ring of staged tiles
constexpr int kMaxGroups = 4;
constexpr int kMaxHeadDim = 256;
constexpr int kMaxOutputs = 2048;    // rep * hd

struct Args {
  const void* q;
  const uint8_t* kp;
  const float* ks;
  const uint8_t* vp;
  const float* vs;
  const int* pos;
  float* scratch;    // (B, KV, rep, S) scores
  float* part;       // (B, KV, P, rep) maxes, (B, KV, P, rep) sums, (B, KV, P, rep * hd)
  void* out;
  int KV, rep, hd, S, NB, P;
  int groups;
  int bits[kMaxGroups];
  int sizes[kMaxGroups];
  float sqrt_hd;
  int vec;           // the rings' rows 16-byte aligned (S * NB % 16 == 0, aligned bases)
};

// Shared-memory layout, in floats (every region 16-byte aligned).
struct Layout {
  int rstride;       // bytes a staged packed row
  int stage;         // floats a stage: packed rows, then scales
  int qs, codes, ring, vt, wt, acc, cm, ml, ll, total;
  __host__ __device__ static int up4(int n) { return (n + 3) & ~3; }
  __host__ __device__ Layout(int rep, int hd, int NB, int G) {
    rstride = NB % 16 == 0 ? NB + 16 : NB;           // padded rows: no bank conflicts
    stage = up4((kTile * rstride + 3) / 4) + up4(kTile * G);
    const int outs = rep * hd;
    qs = 0;
    codes = qs + up4(outs);                            // channel codes (ints)
    ring = codes + up4(hd);                            // kStages staged tiles
    vt = ring + kStages * stage;                       // dequantised V tile
    wt = vt + up4(kTile * hd);                         // normalised weights of a tile
    acc = wt + up4(rep * kTile);                       // value-dot sums (token lanes)
    cm = acc + up4(outs > kThreads ? outs : kThreads);
    ml = cm + up4(kWarps * rep);                       // per-warp running maxes
    ll = ml + up4(rep);                                // M per query head
    total = ll + up4(rep);                             // L per query head
  }
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
__device__ __forceinline__ int channel_code(const int* bits, const int* sizes, int groups, int d) {
  int lo = 0, byte0 = 0;
  for (int g = 0; g < groups; ++g) {
    const int f = 8 / bits[g];
    if (d < lo + sizes[g]) {
      const int local = d - lo;
      return (byte0 + local / f) | ((local % f) * bits[g] << 16) | (bits[g] << 20) | (g << 24);
    }
    lo += sizes[g];
    byte0 += sizes[g] / f;
  }
  return 0;
}

// f32(code) * scale, rounded to the out type: one dequantised ring value.
template <bool OUT_BF16>
__device__ __forceinline__ float dequant(const uint8_t* row, const float* scales, int code) {
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
  return round_to<OUT_BF16>(__fmul_rn(static_cast<float>(v), scales[code >> 24]));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Stage `rows` packed rows (from `src`, NB bytes each, contiguous) and their
// `rows * G` scales into one stage: row r at raw + r * rstride, the scales
// after the rows.  Not committed.
__device__ __forceinline__ void stage_tile(uint8_t* raw, float* rsc, const uint8_t* src,
                                           const float* ssrc, int rows, int NB, int G,
                                           int rstride, bool vec) {
  const int bytes = rows * NB;
  if (vec) {
    const int upr = NB / 16;                         // 16-byte units a row, when NB % 16 == 0
    for (int u = threadIdx.x; 16 * u < bytes; u += kThreads) {
      const int dst = NB % 16 == 0 ? (u / upr) * rstride + (u % upr) * 16 : 16 * u;
      const int n = bytes - 16 * u < 16 ? bytes - 16 * u : 16;
      cp_async16(raw + dst, src + 16 * u, n);
    }
  } else {                                           // an edge: rows not 16-byte aligned
    for (int i = threadIdx.x; i < bytes; i += kThreads) raw[(i / NB) * rstride + i % NB] = src[i];
  }
  for (int i = threadIdx.x; i < rows * G; i += kThreads) cp_async4(rsc + i, ssrc + i);
}

__device__ __forceinline__ void grid_barrier(int P) {
  if (P > 1) {
    cg::this_grid().sync();
  } else {
    __syncthreads();
  }
}

// grid (KV, B, P): block (g, b, p) serves kv-head g of slot b, tiles p,
// p + P, ... of its ring.  CH: channels a lane holds in pass 1 (>= hd / 8);
// MIN_BLOCKS: the resident blocks an SM must hold (`k4_plan`'s assumption).
template <bool Q_BF16, bool OUT_BF16, int CH, int MIN_BLOCKS>
__global__ void __launch_bounds__(kThreads, MIN_BLOCKS)
decode_attention_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int KV = a.KV, rep = a.rep, hd = a.hd, S = a.S, NB = a.NB, P = a.P, G = a.groups;
  const Layout L(rep, hd, NB, G);
  const bool vec = a.vec != 0;
  float* qs = smem + L.qs;
  int* codes = reinterpret_cast<int*>(smem + L.codes);
  float* vt = smem + L.vt;
  float* wt = smem + L.wt;
  float* accs = smem + L.acc;
  float* cmax = smem + L.cm;
  float* mrow = smem + L.ml;
  float* lrow = smem + L.ll;

  const int g = blockIdx.x, b = blockIdx.y, p = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int64_t head = int64_t(b) * KV + g;
  const int pp = a.pos[b];
  const int n = pp < 0 ? 0 : (pp + 1 < S ? pp + 1 : S);          // entries <= pos
  const int ntiles = (n + kTile - 1) / kTile;
  const int mine = p < ntiles ? (ntiles - p + P - 1) / P : 0;    // this block's tiles
  const uint8_t* krows = a.kp + head * S * NB;
  const uint8_t* vrows = a.vp + head * S * NB;
  const float* kscales = a.ks + head * S * G;
  const float* vscales = a.vs + head * S * G;
  float* sc = a.scratch + head * rep * S;
  const int64_t hp = head * P;
  const int64_t nparts = int64_t(gridDim.x) * gridDim.y * P;
  float* bmax = a.part;                                          // (B, KV, P, rep)
  float* bsum = a.part + nparts * rep;                           // (B, KV, P, rep)
  float* bout = a.part + 2 * nparts * rep;                       // (B, KV, P, rep * hd)
  const int outs = rep * hd;

  // tile k of this block (ring tile p + k P) from `rows`/`scales` into stage k % kStages
  auto stage = [=](const uint8_t* rows, const float* scales, int k) {
    if (k < mine) {
      const int j = p + k * P;
      float* st = smem + L.ring + (k % kStages) * L.stage;
      stage_tile(reinterpret_cast<uint8_t*>(st), st + L.stage - Layout::up4(kTile * G),
                 rows + int64_t(j) * kTile * NB, scales + int64_t(j) * kTile * G,
                 n - j * kTile < kTile ? n - j * kTile : kTile, NB, G, L.rstride, vec);
    }
    cp_async_commit();                                 // empty groups keep the count
  };

  for (int i = tid; i < outs; i += kThreads) qs[i] = load_q<Q_BF16>(a.q, head * outs + i);
  for (int d = tid; d < hd; d += kThreads) codes[d] = channel_code(a.bits, a.sizes, G, d);
  for (int i = tid; i < kWarps * rep; i += kThreads) cmax[i] = -INFINITY;
  for (int k = 0; k < kStages - 1; ++k) stage(krows, kscales, k);
  // this thread's token of a tile and its channels d = l8 + 8 i
  const int tok = tid / kLanes, l8 = tid % kLanes;

  // -- phase 1: scores of this block's tiles, and its max per query head
  for (int k = 0; k < mine; ++k) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                                   // tile k staged; tile k - 1 done
    stage(krows, kscales, k + kStages - 1);
    const int t0 = (p + k * P) * kTile;
    const bool valid = t0 + tok < n;
    const float* st = smem + L.ring + (k % kStages) * L.stage;
    const uint8_t* row = reinterpret_cast<const uint8_t*>(st) + tok * L.rstride;
    const float* srow = st + L.stage - Layout::up4(kTile * G) + tok * G;
    float kv[CH];
#pragma unroll
    for (int i = 0; i < CH; ++i)
      kv[i] = valid && l8 + kLanes * i < hd ? dequant<OUT_BF16>(row, srow, codes[l8 + kLanes * i])
                                            : 0.0f;
    for (int r = 0; r < rep; ++r) {
      float part = 0.0f;
#pragma unroll
      for (int i = 0; i < CH; ++i)
        if (l8 + kLanes * i < hd) part = fmaf(qs[r * hd + l8 + kLanes * i], kv[i], part);
      part += __shfl_xor_sync(0xffffffffu, part, 4);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      const float s = part / a.sqrt_hd;
      if (valid && l8 == 0) sc[int64_t(r) * S + t0 + tok] = s;
      float m = valid ? s : -INFINITY;
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 8));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 16));
      if (lane == 0) cmax[warp * rep + r] = fmaxf(cmax[warp * rep + r], m);
    }
  }
  __syncthreads();
  for (int r = tid; r < rep; r += kThreads) {
    float m = cmax[r];
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, cmax[w * rep + r]);
    bmax[(hp + p) * rep + r] = m;
  }
  grid_barrier(P);

  // -- phase 2: M per query head; this block's sum of expf(s - M)
  for (int k = 0; k < kStages - 1; ++k) stage(vrows, vscales, k);   // V in flight meanwhile
  for (int r = tid; r < rep; r += kThreads) {
    float m = bmax[hp * rep + r];
    for (int q = 1; q < P; ++q) m = fmaxf(m, bmax[(hp + q) * rep + r]);
    mrow[r] = m;
  }
  __syncthreads();
  for (int r = warp; r < rep; r += kWarps) {
    float l = 0.0f;
#pragma unroll 4
    for (int k = 0; k < mine; ++k) {
      const int t = (p + k * P) * kTile + lane;
      if (t < n) l += expf(sc[int64_t(r) * S + t] - mrow[r]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0) bsum[(hp + p) * rep + r] = l;
  }
  grid_barrier(P);

  // -- phase 3: L per query head; normalised weights and the partial value dot
  for (int r = tid; r < rep; r += kThreads) {
    float l = bsum[hp * rep + r];
    for (int q = 1; q < P; ++q) l = __fadd_rn(l, bsum[(hp + q) * rep + r]);
    lrow[r] = l;
  }
  int tl = 1;                                          // token lanes an output
  while (2 * tl * outs <= kThreads) tl *= 2;
  const int h = tl > 1 ? tid / outs : 0;
  for (int i = tid; i < (outs > kThreads ? outs : kThreads); i += kThreads) accs[i] = 0.0f;
  for (int k = 0; k < mine; ++k) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                                   // V tile k staged; tile k - 1 done
    stage(vrows, vscales, k + kStages - 1);
    const int t0 = (p + k * P) * kTile;
    const int tc = n - t0 < kTile ? n - t0 : kTile;
    constexpr int kSv = 2;                             // scores loaded ahead (rep <= 16)
    float sv[kSv];
#pragma unroll
    for (int j = 0; j < kSv; ++j) {
      const int i = tid + j * kThreads, r = i / kTile, t = i % kTile;
      sv[j] = i < rep * kTile && t < tc ? sc[int64_t(r) * S + t0 + t] : 0.0f;
    }
    {
      const float* st = smem + L.ring + (k % kStages) * L.stage;
      const uint8_t* row = reinterpret_cast<const uint8_t*>(st) + tok * L.rstride;
      const float* srow = st + L.stage - Layout::up4(kTile * G) + tok * G;
#pragma unroll
      for (int i = 0; i < CH; ++i) {
        const int d = l8 + kLanes * i;
        if (d < hd) vt[tok * hd + d] = tok < tc ? dequant<OUT_BF16>(row, srow, codes[d]) : 0.0f;
      }
    }
#pragma unroll
    for (int j = 0; j < kSv; ++j) {
      const int i = tid + j * kThreads, r = i / kTile, t = i % kTile;
      if (i < rep * kTile)
        wt[i] = t < tc ? round_to<OUT_BF16>(expf(sv[j] - mrow[r]) / lrow[r]) : 0.0f;
    }
    for (int i = tid + kSv * kThreads; i < rep * kTile; i += kThreads) {
      const int r = i / kTile, t = i % kTile;
      wt[i] = t < tc ? round_to<OUT_BF16>(expf(sc[int64_t(r) * S + t0 + t] - mrow[r]) / lrow[r])
                     : 0.0f;
    }
    __syncthreads();
    if (tl > 1) {
      if (tid < tl * outs) {
        const int o = tid % outs, r = o / hd, d = o % hd;
        float v = accs[tid];
        for (int t = h; t < tc; t += tl) v = fmaf(wt[r * kTile + t], vt[t * hd + d], v);
        accs[tid] = v;
      }
    } else {
      for (int o = tid; o < outs; o += kThreads) {
        const int r = o / hd, d = o % hd;
        float v = accs[o];
        for (int t = 0; t < tc; ++t) v = fmaf(wt[r * kTile + t], vt[t * hd + d], v);
        accs[o] = v;
      }
    }
  }
  __syncthreads();
  for (int o = tid; o < outs; o += kThreads) {
    float v = accs[o];
    for (int q = 1; q < tl; ++q) v = __fadd_rn(v, accs[q * outs + o]);
    bout[(hp + p) * outs + o] = v;
  }
  grid_barrier(P);

  // -- phase 4: the partial value dots added in block order, rounded once
  for (int o = p * kThreads + tid; o < outs; o += P * kThreads) {
    float v = bout[hp * outs + o];
    for (int q = 1; q < P; ++q) v = __fadd_rn(v, bout[(hp + q) * outs + o]);
    if (n == 0) v = NAN;                               // the reference's all -inf row
    if constexpr (OUT_BF16) {
      static_cast<__nv_bfloat16*>(a.out)[head * outs + o] = __float2bfloat16_rn(v);
    } else {
      static_cast<float*>(a.out)[head * outs + o] = v;
    }
  }
}

template <bool Q_BF16, bool OUT_BF16, int CH, int MIN_BLOCKS>
int launch(const Args& a, int B, size_t smem, cudaStream_t stream) {
  auto kernel = decode_attention_kernel<Q_BF16, OUT_BF16, CH, MIN_BLOCKS>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 160 * 1024);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>(a.KV), static_cast<unsigned>(B),
                  static_cast<unsigned>(a.P));
  if (a.P == 1) {
    kernel<<<grid, kThreads, smem, stream>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (int64_t(per_sm) * sms < int64_t(a.KV) * B * a.P)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  Args args = a;
  void* params[] = {&args};
  return static_cast<int>(cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), grid,
                                                      dim3(kThreads), params, smem, stream));
}

// hd <= 128 (CH <= 16) holds 4 blocks an SM, wider heads 2: `k4_plan` assumes
// as much (its k4_blocks_per_sm).
template <bool Q_BF16, bool OUT_BF16>
int launch_ch(const Args& a, int B, size_t smem, cudaStream_t stream) {
  const int ch = (a.hd + kLanes - 1) / kLanes;
  if (ch <= 4) return launch<Q_BF16, OUT_BF16, 4, 4>(a, B, smem, stream);
  if (ch <= 8) return launch<Q_BF16, OUT_BF16, 8, 4>(a, B, smem, stream);
  if (ch <= 16) return launch<Q_BF16, OUT_BF16, 16, 4>(a, B, smem, stream);
  return launch<Q_BF16, OUT_BF16, 32, 2>(a, B, smem, stream);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// q_bf16 / out_bf16: 1 for bf16, 0 for f32.  bits/sizes: the G <= 4 channel
// groups (unused entries ignored).  scratch: (B, KV, rep, S) f32; part:
// B * KV * P * rep * (hd + 2) f32.  P: the ring's split (`k4_plan`).
extern "C" int decode_attention_f32acc(
    const void* q, int q_bf16, const void* k_packed, const void* k_scales,
    const void* v_packed, const void* v_scales, const void* pos, void* scratch, void* part,
    void* out, int out_bf16, int B, int KV, int rep, int hd, int S, int NB, int G, int b0,
    int b1, int b2, int b3, int n0, int n1, int n2, int n3, float sqrt_hd, int P,
    void* stream) {
  if (G < 1 || G > kMaxGroups || hd < 1 || hd > kMaxHeadDim || P < 1
      || rep * hd > kMaxOutputs) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{q, static_cast<const uint8_t*>(k_packed), static_cast<const float*>(k_scales),
         static_cast<const uint8_t*>(v_packed), static_cast<const float*>(v_scales),
         static_cast<const int*>(pos), static_cast<float*>(scratch), static_cast<float*>(part),
         out, KV, rep, hd, S, NB, P, G, {b0, b1, b2, b3}, {n0, n1, n2, n3}, sqrt_hd, 0};
  a.vec = int64_t(S) * NB % 16 == 0 && aligned16(k_packed) && aligned16(v_packed);
  const size_t smem = sizeof(float) * size_t(Layout(rep, hd, NB, G).total);
  auto st = static_cast<cudaStream_t>(stream);
  if (q_bf16 && out_bf16) return launch_ch<true, true>(a, B, smem, st);
  if (q_bf16) return launch_ch<true, false>(a, B, smem, st);
  if (out_bf16) return launch_ch<false, true>(a, B, smem, st);
  return launch_ch<false, false>(a, B, smem, st);
}
