// Packed mixed-precision GEMMs for Hopper (sm_90a): x in (f32 for the SIMT
// routine, bf16 for the tensor-core one), f32 out.
//
// Two device routines serve six kernels.
//
// `simt_tile` (SIMT, f32 FMA chains) serves, at f32 compute:
// * `fused_kernel`, the Pallas kernel `_fused_kernel` of
//   src/repro/kernels/quant_matmul.py in its 2-D form (`quant_matmul_fused_2d`,
//   dequant_first=False): one launch over a whole deployed weight whose
//   output tiles mix 2-, 4- and 8-bit channels, one block per (M tile,
//   output tile t), the tile's bit-width and byte offset read from a small
//   int32 table built at deploy (the TPU kernel's unrolled `pl.when` chain).
// * `pergroup_kernel`, the Pallas kernel `_kernel` (`quant_matmul_2d`): one
//   precision group, packed (N, K/f); `blockIdx.z` walks an expert axis
//   (packed (E, N, K/f)), where the reference loops over the experts.
// * `fused_experts_kernel`, `_fused_kernel` in its expert-batched 3-D form
//   (`quant_matmul_fused_3d`, dequant_first=True), at f32 compute or tile
//   widths below 16: each weight tile is round_cd(w_int * s) before the
//   product, every expert's ragged buffer under ONE tile table.
// Each output's K terms are summed by one thread in ascending k with fmaf
// from 0, then scaled with __fmul_rn (not for the expert kernel, whose tiles
// are scaled first).  That chain is the whole contract: whatever the block
// shape, K1 and K2 give a weight served through the fused layout and its
// per-group form the same bits (the reference's contract, gated in
// chip_smoke.py and the tests), and the tinyml layers stay within 1e-4 of
// FROZEN.  No TF32, no split of K.
//
// What bounds it.  The tinyml GEMMs (resnet8 at batch 64: M 4096-65536 rows
// of im2col patches, Kp 28-576, N 10-64) read x once and do at most 64
// products a value, so their bound is x's bytes; the FMAs come second.
// What holds the routine is the shared memory that feeds the FMAs: a
// thread's float4 read costs the SM 4 cycles, and the design spends 2 bytes
// of it an FMA where the SM serves 1 (a 4 x 4 register tile; 8 x 8 would
// leave resnet8's M 4096-16384 layers too few blocks for 132 SMs).  The
// design:
// * a register tile of 4 rows x 4 channels a thread, read from shared
//   memory as float4 (4 k values of a row of x; 4 channels of w), so a
//   thread does 64 FMAs for 8 vector loads, broadcast across the threads
//   that share a row or a channel quad;
// * block shapes per TILE_N: 256 threads, TILE_N / 4 of them across the
//   channels and the rest across rows, 4 rows a thread (1 below 16
//   channels), so narrow tiles take 256 rows a block; fewer rows a thread,
//   which would give resnet8's M 4096-16384 layers more blocks than SMs,
//   measured slower at every resnet8 shape;
// * x staged by cp.async (16-byte copies where rows are 16-byte aligned,
//   else 4-byte ones, zero-filled past the edges) into two stages of
//   row-major shared memory (rows padded to 36 floats: the float4 reads of
//   eight rows are conflict-free), the packed bytes through registers and
//   unpacked once a chunk into a k-major tile; one barrier a 32-deep chunk,
//   the next chunk in flight during the FMAs.
//
// `skinny_mma_tile` (bf16 tensor cores, `mma.sync.m16n8k16`) serves every
// GEMM at bf16 compute with whole 16-channel fragments:
// * `fused_mma_kernel`: K1 at tile widths >= 16 (every LM weight with the
//   fused layout: deepseek-v3's wq_b, wkv_b, shared w_down), scaled after
//   the sum as K1 is;
// * `pergroup_mma_kernel`: K2 at every K (every qwen1.5-4b linear at full
//   width, deepseek-v3's we_gate/we_up expert stacks, its MLA projections
//   with c_in 7168 or 16384 and lm_head), one group a launch, the expert
//   axis on `blockIdx.z` as above;
// * `fused_experts_mma_kernel`: K3 at tile widths >= 16 (deepseek's
//   we_down, tile 128), one precision per 16-channel fragment.
// A block's sums depend on (bits, K, M) alone, through the plan (below), so
// a K1 tile and the K2 group it came from sum the same products in the same
// order: K1 == K2 bitwise at bf16 too.  At decode these GEMMs move their
// packed bytes once for 4-8 tokens: a deepseek we_down step streams 2.0 GB
// for 60 GFLOP, qwen's 843 group launches 1.9 GB.  So what bounds them is
// the bytes, and, for launches of a few MB, the launch latency; MLA's wkv_b
// over the 2048 cached latents (Kp 512, N 32768) is bound by its products
// and its 268 MB f32 output.  The design:
// * Tokens on the narrow side of the product.  A (16 x 16) is 16 output
//   channels of weight codes, unpacked in registers to bf16 (exact), or for
//   K3 round_bf16(w_int * s) (__fmul_rn then __float2bfloat16_rn, as
//   `store_w` does); B (16 x 8) is x transposed, 8 tokens.  M <= 8 wastes
//   no rows beyond the padding to 8; larger M loops over 8-token fragments
//   in the warp, reusing each unpacked A fragment (MF fragments a warp).
// * K permuted within each chunk so that every load is wide: thread t of a
//   quad owns 8 contiguous packed bytes of its two rows per chunk (32 bytes a
//   row a chunk: 128, 64, 32 values at 2, 4, 8 bits), and the x values it
//   needs lie in the same k range; a code pair becomes exact bf16 with one
//   LOP3 and one HSUB2 (0x4300 | u is 128 + u), which pairs codes (i, i +
//   half a word), and B pairs the same x values (PRMT).  A and B use the
//   same permutation, so the sum is over the same products.
// * Packed bytes and x (bf16, the caller's rounding: half the f32 bytes,
//   which at decode were as many L2 bytes as the weights' DRAM bytes) are
//   staged by cp.async (16-byte copies, zero-filled past the edges) into a
//   ring of 3 stages in dynamic shared memory, x under an XOR swizzle that
//   keeps the fragment loads free of bank conflicts.  A deeper ring
//   measured no faster.
// * K split inside the block, deterministically: WK warps take interleaved
//   chunks of the same 16 channels, each accumulating in its own mma chain
//   in ascending chunk order; the block adds the WK partial sums in shared
//   memory in a fixed order (__fadd_rn), then scales (K1, K2) or stores (K3).
//   No atomics.  The plan (MF, WK, WN) is a function of M alone
//   (`quant_matmul.mma_plan`) and WN (channel warps) does not change any
//   sum, so a block's result depends on neither E nor the grid: an
//   expert's slice of an expert-axis launch is its own launch, bit for bit,
//   and a K1 block (WN cut to tile_n / 16) sums as the K2 block of its
//   channels.  Up to MMA_ROWS_MAX (32) rows the plan is the decode one
//   (1, 4, 4), whose 8-token fragments tile any M a block each, so a
//   row's sums do not depend on M: a speculative verify's rows (M = slots
//   x (k + 1)) are the decode step's (M = slots) bit for bit.  At decode a block streams its channels' K at a rate of its
//   own, so a group of few 64-channel blocks (qwen's N 512-1408 at K 6912)
//   leaves the card idle; splitting K across blocks would fix the sums'
//   order by the split, which may not depend on E, and slowed the expert
//   axis: not done.
// Numerics: the products are exact (bf16 x bf16 in f32); the tensor core
// adds a step's 16 products and the running sum in its own order and
// rounding, so the result is held to the f32 forward-error bound
// 2 (K + 2) u sum |x w s| against the plain version.  No TF32 anywhere;
// f32 compute keeps `simt_tile`.
//
// Edges handled in the kernels, not by padding: ragged M (rows >= M read
// as 0 and are not stored), x narrower than K (columns >= Kx read as 0,
// the reference's zero padding of x), ragged N, tile byte segments at any
// offset; rows that are not 16-byte aligned are loaded in smaller pieces
// (an edge: the LM shapes are aligned, the tinyml ones but for conv0's 27
// columns).  Offsets into a stack are 64-bit: one deepseek-v3 we_down stack
// is 2.0 GB.
//
// C interface (bound with ctypes): each entry point launches on the given
// stream, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 32;  // K chunk of the SIMT routine

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async with zero fill: `bytes` of the source are copied, the rest of
// the destination is zeroed (bytes = 0 reads nothing).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Block shape of the SIMT routine for TILE_N channels: a thread holds kRM
// rows x kCN channels.
template <int TILE_N>
struct Simt {
  static constexpr int kN = TILE_N;
  static constexpr int kCN = TILE_N < 4 ? TILE_N : 4;      // channels a thread holds
  static constexpr int kThreadsN = TILE_N / kCN;
  static constexpr int kThreadsM = kThreads / kThreadsN;
  static constexpr int kRM = TILE_N < 16 ? 1 : 4;           // rows a thread holds
  static constexpr int kBM = kThreadsM * kRM;               // rows a block: 32 to 256
  static constexpr int kXStride = kBK + 4;                   // floats a staged x row
  static constexpr int kXFloats = kBM * kXStride;
  static constexpr int kWFloats = kBK * TILE_N;
  static constexpr int kSmem = 2 * (kXFloats + kWFloats) * 4;   // two stages
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

// Stage x rows [m0, m0 + BM) x columns [k0, k0 + kBK) into a row-major tile:
// rows >= M and columns >= Kx zero.  x_vec: Kx % 4 == 0 and x 16-byte aligned.
template <class G>
__device__ __forceinline__ void fill_x_simt(float* xs, const float* __restrict__ x, int64_t M,
                                            int Kx, int64_t m0, int k0, bool x_vec) {
  if (x_vec) {
    constexpr int kUnits = kBK / 4;
    for (int i = threadIdx.x; i < G::kBM * kUnits; i += kThreads) {
      const int r = i / kUnits, c = i % kUnits;
      const int64_t m = m0 + r;
      const int k = k0 + 4 * c;
      const bool ok = m < M && k < Kx;
      cp_async16(xs + r * G::kXStride + 4 * c, ok ? x + m * Kx + k : x, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < G::kBM * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK;
      const int64_t m = m0 + r;
      const int k = k0 + c;
      const bool ok = m < M && k < Kx;
      cp_async4(xs + r * G::kXStride + c, ok ? x + m * Kx + k : x, ok ? 4 : 0);
    }
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

// Unpacked weights to the k-major tile ws[k][n].  DEQUANT_FIRST (the expert
// kernel) stores w_int * scale[n] instead, rounded to bf16 when round_bf16.
template <int BITS, int TILE_N, bool DEQUANT_FIRST>
__device__ __forceinline__ void store_w(float* ws,
                                        const uint8_t (&wr)[WChunk<BITS, TILE_N>::kIters],
                                        const float* __restrict__ scale, bool round_bf16) {
  using C = WChunk<BITS, TILE_N>;
  constexpr int F = 8 / BITS;
#pragma unroll
  for (int it = 0; it < C::kIters; ++it) {
    const int idx = threadIdx.x + it * kThreads;
    if (idx < TILE_N * C::kBytes) {
      const int n = idx % TILE_N;
      const int b = idx / TILE_N;
#pragma unroll
      for (int j = 0; j < F; ++j) {
        float v = unpack_value<BITS>(wr[it], j);
        if constexpr (DEQUANT_FIRST) {
          v = __fmul_rn(v, scale[n]);
          if (round_bf16) v = __bfloat162float(__float2bfloat16_rn(v));
        }
        ws[(b * F + j) * TILE_N + n] = v;
      }
    }
  }
}

// The kCN channel values of a thread at one k, from the k-major tile.
template <int CN>
__device__ __forceinline__ void w_at(const float* wk, float (&wv)[CN]) {
  if constexpr (CN == 4) {
    const float4 v = *reinterpret_cast<const float4*>(wk);
    wv[0] = v.x; wv[1] = v.y; wv[2] = v.z; wv[3] = v.w;
  } else {
#pragma unroll
    for (int j = 0; j < CN; ++j) wv[j] = wk[j];
  }
}

// Four k steps of a thread's RM x CN outputs: the only arithmetic of the K
// loop, so every output stays one ascending fmaf chain.
template <class G, int RM = G::kRM>
__device__ __forceinline__ void simt_quad(const float* xs, const float* ws, int k, int tm,
                                          int tn, float (&acc)[RM][G::kCN]) {
  float4 xv[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i)
    xv[i] = *reinterpret_cast<const float4*>(xs + (tm + i * G::kThreadsM) * G::kXStride + k);
  float wv[4][G::kCN];
#pragma unroll
  for (int q = 0; q < 4; ++q) w_at<G::kCN>(ws + (k + q) * G::kN + tn * G::kCN, wv[q]);
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const float xq = q == 0 ? xv[i].x : q == 1 ? xv[i].y : q == 2 ? xv[i].z : xv[i].w;
#pragma unroll
      for (int j = 0; j < G::kCN; ++j) acc[i][j] = fmaf(xq, wv[q][j], acc[i][j]);
    }
}

// One k step (the last, partial chunk).
template <class G, int RM = G::kRM>
__device__ __forceinline__ void simt_step(const float* xs, const float* ws, int k, int tm,
                                          int tn, float (&acc)[RM][G::kCN]) {
  float wv[G::kCN];
  w_at<G::kCN>(ws + k * G::kN + tn * G::kCN, wv);
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const float xq = xs[(tm + i * G::kThreadsM) * G::kXStride + k];
#pragma unroll
    for (int j = 0; j < G::kCN; ++j) acc[i][j] = fmaf(xq, wv[j], acc[i][j]);
  }
}

// One (BM x TILE_N) output tile of y = (x @ w_int^T) * scale, or with
// DEQUANT_FIRST of y = x @ round_cd(w_int * scale)^T.
//   x      (M, Kx) row-major f32; columns Kx..K-1 read as 0
//   w      TILE_N rows of K/F packed bytes each (row stride w_row_bytes);
//          rows >= n_valid read as 0 and are not stored
//   out    row stride ldo; column 0 of the tile at `out`
//   smem   Simt<TILE_N>::kSmem bytes, 16-byte aligned
template <int BITS, int TILE_N, bool DEQUANT_FIRST = false>
__device__ __forceinline__ void simt_tile(
    const float* __restrict__ x, int64_t M, int Kx, int K,
    const uint8_t* __restrict__ w, int w_row_bytes, int n_valid,
    const float* __restrict__ scale, float* __restrict__ out, int64_t ldo,
    int64_t m0, float* smem, bool x_vec, bool round_bf16 = false) {
  using G = Simt<TILE_N>;
  constexpr int RM = G::kRM;
  float* xs[2] = {smem, smem + G::kXFloats};
  float* ws[2] = {smem + 2 * G::kXFloats, smem + 2 * G::kXFloats + G::kWFloats};
  const int tid = threadIdx.x;
  const int tn = tid % G::kThreadsN;
  const int tm = tid / G::kThreadsN;

  float acc[RM][G::kCN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < G::kCN; ++j) acc[i][j] = 0.0f;

  const int nchunks = (K + kBK - 1) / kBK;
  uint8_t wr[WChunk<BITS, TILE_N>::kIters];
  fill_x_simt<G>(xs[0], x, M, Kx, m0, 0, x_vec);
  cp_async_commit();
  load_w<BITS, TILE_N>(w, w_row_bytes, n_valid, 0, wr);
  store_w<BITS, TILE_N, DEQUANT_FIRST>(ws[0], wr, scale, round_bf16);
  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<0>();
    __syncthreads();                    // chunk c staged; every thread is past chunk c - 1
    const bool next = c + 1 < nchunks;
    if (next) {                         // chunk c + 1 in flight during the FMAs
      fill_x_simt<G>(xs[(c + 1) & 1], x, M, Kx, m0, (c + 1) * kBK, x_vec);
      cp_async_commit();
      load_w<BITS, TILE_N>(w, w_row_bytes, n_valid, (c + 1) * kBK, wr);
    }
    const float* xc = xs[c & 1];
    const float* wc = ws[c & 1];
    const int kc = K - c * kBK < kBK ? K - c * kBK : kBK;
    if (kc == kBK) {
#pragma unroll
      for (int k = 0; k < kBK; k += 4) simt_quad<G>(xc, wc, k, tm, tn, acc);
    } else {
      for (int k = 0; k < kc; ++k) simt_step<G>(xc, wc, k, tm, tn, acc);
    }
    if (next) store_w<BITS, TILE_N, DEQUANT_FIRST>(ws[(c + 1) & 1], wr, scale, round_bf16);
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int64_t m = m0 + tm + i * G::kThreadsM;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < G::kCN; ++j) {
      const int n = tn * G::kCN + j;
      if (n < n_valid) out[m * ldo + n] = DEQUANT_FIRST ? acc[i][j] : __fmul_rn(acc[i][j], scale[n]);
    }
  }
}

// grid (ceil(M / BM), T): block (i, t) computes rows [i*BM, i*BM+BM) of
// output tile t.  table[2t] = bits, table[2t+1] = byte offset of the tile.
template <int TILE_N>
__global__ void __launch_bounds__(kThreads, 2)
fused_kernel(const float* __restrict__ x, int64_t M, int Kx, int Kp,
             const uint8_t* __restrict__ packed, const int* __restrict__ table,
             const float* __restrict__ scales, float* __restrict__ out, int64_t ldo, int x_vec) {
  using G = Simt<TILE_N>;
  extern __shared__ __align__(16) unsigned char simt_smem[];
  float* sm = reinterpret_cast<float*>(simt_smem);
  const int t = blockIdx.y;
  const int bits = table[2 * t];
  const uint8_t* w = packed + table[2 * t + 1];
  const int64_t m0 = int64_t(blockIdx.x) * G::kBM;
  const float* s = scales + int64_t(t) * TILE_N;
  float* o = out + int64_t(t) * TILE_N;
  const bool xv = x_vec != 0;
  if (bits == 2) {
    simt_tile<2, TILE_N>(x, M, Kx, Kp, w, Kp / 4, TILE_N, s, o, ldo, m0, sm, xv);
  } else if (bits == 4) {
    simt_tile<4, TILE_N>(x, M, Kx, Kp, w, Kp / 2, TILE_N, s, o, ldo, m0, sm, xv);
  } else {
    simt_tile<8, TILE_N>(x, M, Kx, Kp, w, Kp, TILE_N, s, o, ldo, m0, sm, xv);
  }
}

constexpr int kPerGroupTileN = 64;

// grid (ceil(M / BM), ceil(N / 64), E); per expert e: x (M, Kx),
// packed (N, K / F), scale (N,), out (M, N), each stack's slices contiguous.
template <int BITS>
__global__ void __launch_bounds__(kThreads, 2)
pergroup_kernel(const float* __restrict__ x, int64_t M, int Kx, int K,
                const uint8_t* __restrict__ packed, int N,
                const float* __restrict__ scale, float* __restrict__ out, int x_vec) {
  using G = Simt<kPerGroupTileN>;
  constexpr int F = 8 / BITS;
  extern __shared__ __align__(16) unsigned char simt_smem[];
  const int64_t e = blockIdx.z;
  x += e * M * Kx;
  packed += e * N * int64_t(K / F);
  scale += e * N;
  out += e * M * N;
  const int n0 = blockIdx.y * kPerGroupTileN;
  const int n_valid = N - n0 < kPerGroupTileN ? N - n0 : kPerGroupTileN;
  const int64_t m0 = int64_t(blockIdx.x) * G::kBM;
  simt_tile<BITS, kPerGroupTileN>(x, M, Kx, K, packed + int64_t(n0) * (K / F), K / F,
                                      n_valid, scale + n0, out + n0, N, m0,
                                      reinterpret_cast<float*>(simt_smem), x_vec != 0);
}

// grid (ceil(M / BM), T, E): block (i, t, e) computes rows [i*BM, i*BM+BM)
// of output tile t of expert e.  Per expert: x (M, Kx), its ragged buffer
// of expert_bytes at packed + e * expert_bytes (the table's offsets are
// within it), scales (T * TILE_N,), out (M, T * TILE_N).
template <int TILE_N>
__global__ void __launch_bounds__(kThreads, 2)
fused_experts_kernel(const float* __restrict__ x, int64_t M, int Kx, int Kp,
                     const uint8_t* __restrict__ packed, int64_t expert_bytes,
                     const int* __restrict__ table, const float* __restrict__ scales,
                     float* __restrict__ out, int T, int round_bf16, int x_vec) {
  using G = Simt<TILE_N>;
  extern __shared__ __align__(16) unsigned char simt_smem[];
  float* sm = reinterpret_cast<float*>(simt_smem);
  const int t = blockIdx.y;
  const int64_t e = blockIdx.z;
  const int64_t ldo = int64_t(T) * TILE_N;
  const int bits = table[2 * t];
  const uint8_t* w = packed + e * expert_bytes + table[2 * t + 1];
  const float* xe = x + e * M * Kx;
  const float* s = scales + e * ldo + int64_t(t) * TILE_N;
  float* o = out + e * M * ldo + int64_t(t) * TILE_N;
  const int64_t m0 = int64_t(blockIdx.x) * G::kBM;
  const bool rb = round_bf16 != 0, xv = x_vec != 0;
  if (bits == 2) {
    simt_tile<2, TILE_N, true>(xe, M, Kx, Kp, w, Kp / 4, TILE_N, s, o, ldo, m0, sm, xv, rb);
  } else if (bits == 4) {
    simt_tile<4, TILE_N, true>(xe, M, Kx, Kp, w, Kp / 2, TILE_N, s, o, ldo, m0, sm, xv, rb);
  } else {
    simt_tile<8, TILE_N, true>(xe, M, Kx, Kp, w, Kp, TILE_N, s, o, ldo, m0, sm, xv, rb);
  }
}

// Dynamic shared memory above 48 KB needs the kernel's attribute, set once.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int TILE_N>
int launch_fused(const float* x, int64_t M, int Kx, int Kp, const uint8_t* packed,
                 const int* table, const float* scales, int T, float* out, bool x_vec,
                 cudaStream_t stream) {
  using G = Simt<TILE_N>;
  auto kernel = fused_kernel<TILE_N>;
  static const cudaError_t attr = allow_smem(kernel, G::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>((M + G::kBM - 1) / G::kBM), static_cast<unsigned>(T));
  kernel<<<grid, kThreads, G::kSmem, stream>>>(x, M, Kx, Kp, packed, table, scales, out,
                                               int64_t(T) * TILE_N, x_vec);
  return static_cast<int>(cudaGetLastError());
}

template <int TILE_N>
int launch_fused_experts(const float* x, int64_t M, int Kx, int Kp, const uint8_t* packed,
                         int64_t expert_bytes, const int* table, const float* scales,
                         int T, int E, int round_bf16, float* out, bool x_vec,
                         cudaStream_t stream) {
  using G = Simt<TILE_N>;
  auto kernel = fused_experts_kernel<TILE_N>;
  static const cudaError_t attr = allow_smem(kernel, G::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>((M + G::kBM - 1) / G::kBM), static_cast<unsigned>(T),
                  static_cast<unsigned>(E));
  kernel<<<grid, kThreads, G::kSmem, stream>>>(x, M, Kx, Kp, packed, expert_bytes, table,
                                               scales, out, T, round_bf16, x_vec);
  return static_cast<int>(cudaGetLastError());
}

template <int BITS>
int launch_pergroup(const float* x, int64_t M, int Kx, int K, const uint8_t* packed,
                    int N, const float* scale, int E, float* out, bool x_vec,
                    cudaStream_t stream) {
  using G = Simt<kPerGroupTileN>;
  auto kernel = pergroup_kernel<BITS>;
  static const cudaError_t attr = allow_smem(kernel, G::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>((M + G::kBM - 1) / G::kBM),
                  static_cast<unsigned>((N + kPerGroupTileN - 1) / kPerGroupTileN),
                  static_cast<unsigned>(E));
  kernel<<<grid, kThreads, G::kSmem, stream>>>(x, M, Kx, K, packed, N, scale, out, x_vec);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The tensor-core path: `skinny_mma_tile` and its three kernels
// ---------------------------------------------------------------------------

constexpr int kMmaStages = 3;   // cp.async ring depth

// Per bit-width: a thread owns 8 packed bytes (kQ values) of a row per chunk;
// the quad (t = 0..3) covers a chunk of kChunk values, 32 bytes a row.
template <int BITS>
struct MmaBits {
  static constexpr int kQ = 64 / BITS;
  static constexpr int kChunk = 4 * kQ;            // 128, 64, 32
  static constexpr int kPerWord = 32 / BITS;       // values in a 32-bit word
  static constexpr int kHalf = kPerWord / 2;       // pair distance: bit 16 of the word
  static constexpr int kStepsPerWord = kPerWord / 4;
  static constexpr int kD = BITS == 2 ? 1 : 2;     // chunks a warp takes per stage
  // x is read a group of words at a time, one or two 16-byte units of bf16
  static constexpr int kGroupWords = BITS == 8 ? 2 : 1;
  static constexpr int kGroupUnits = BITS == 2 ? 2 : 1;
  static constexpr int kRowPadUnits = BITS == 8 ? 4 : 1;   // staged x row stride mod 8 units
};

// Block shape: WK warps split K, WN warps split the 16-channel fragments,
// each warp MF 8-token fragments.
template <int BITS, int MF, int WK, int WN>
struct MmaPlan {
  using B = MmaBits<BITS>;
  static constexpr int kThreads = 32 * WK * WN;
  static constexpr int kBM = 8 * MF;
  static constexpr int kBN = 16 * WN;
  static constexpr int kWinChunks = WK * B::kD;                  // chunks per stage
  static constexpr int kKW = kWinChunks * B::kChunk;             // K values per stage
  static constexpr int kXRowUnits = kKW / 8 + B::kRowPadUnits;   // 16-byte units (8 bf16)
  static constexpr int kXBytes = kBM * kXRowUnits * 16;
  static constexpr int kWRowRaw = kWinChunks * 32;               // packed bytes per row
  static constexpr int kWRow = kWRowRaw + (kWRowRaw % 64 == 0 ? 32 : 0);
  static constexpr int kStageBytes = kXBytes + kBN * kWRow;
  static constexpr int kRedRow = kBN + 4;
  static constexpr int kRedBytes = WK * kBM * kRedRow * 4;
  static constexpr int kSmem = kMmaStages * kStageBytes > kRedBytes
                                   ? kMmaStages * kStageBytes : kRedBytes;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 operands, f32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Swizzled 16-byte unit of a staged x row: with the row padding of
// kRowPadUnits it keeps a quad's four segments and two neighbouring rows on
// distinct banks for every fragment load (2-bit segments are four units
// wide, so the upper two quads flip bit 1).
template <int BITS>
__device__ __forceinline__ int x_swz(int u) {
  return BITS == 2 ? u ^ (((u >> 3) & 1) << 1) : u;
}

// The value of code i (0..kPerWord-1) of a packed word whose sign bits are
// already flipped (offset binary), as an exact f32.
template <int BITS>
__device__ __forceinline__ float code_f32(uint32_t u, int i) {
  if constexpr (BITS == 8) {
    return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u + i)) - 8388736.0f;
  } else {
    constexpr uint32_t kMask = (1u << BITS) - 1;
    return __uint_as_float(((u >> (BITS * i)) & kMask) | 0x4B000000u)
           - (8388608.0f + float(1 << (BITS - 1)));
  }
}

// A-fragment registers of one row for step jj of a word: {codes (2jj,
// 2jj + kHalf)}, {codes (2jj + 1, 2jj + 1 + kHalf)} as bf16 pairs, or with
// DQ the pairs round_bf16(code * s).
template <int BITS, bool DQ>
__device__ __forceinline__ void a_pairs(uint32_t word, int jj, float s, uint32_t& p0,
                                        uint32_t& p1) {
  using B = MmaBits<BITS>;
  constexpr uint32_t kFlip = BITS == 2 ? 0xAAAAAAAAu : (BITS == 4 ? 0x88888888u : 0x80808080u);
  const uint32_t u = word ^ kFlip;
  const int i0 = 2 * jj, i1 = 2 * jj + 1;
  if constexpr (!DQ && BITS != 8) {
    // 128 + offset code as bf16 in each half (exact), minus 128 + 2^(BITS-1)
    constexpr uint32_t kMask = ((1u << BITS) - 1) * 0x00010001u;
    const __nv_bfloat162 bias = __float2bfloat162_rn(128.0f + float(1 << (BITS - 1)));
    uint32_t r0 = ((u >> (BITS * i0)) & kMask) | 0x43004300u;
    uint32_t r1 = ((u >> (BITS * i1)) & kMask) | 0x43004300u;
    __nv_bfloat162 v0 = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&r0), bias);
    __nv_bfloat162 v1 = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&r1), bias);
    p0 = *reinterpret_cast<uint32_t*>(&v0);
    p1 = *reinterpret_cast<uint32_t*>(&v1);
  } else {
    float f0 = code_f32<BITS>(u, i0), f1 = code_f32<BITS>(u, i0 + B::kHalf);
    float f2 = code_f32<BITS>(u, i1), f3 = code_f32<BITS>(u, i1 + B::kHalf);
    if constexpr (DQ) {
      f0 = __fmul_rn(f0, s);
      f1 = __fmul_rn(f1, s);
      f2 = __fmul_rn(f2, s);
      f3 = __fmul_rn(f3, s);
    }
    p0 = pack_bf16(f0, f1);
    p1 = pack_bf16(f2, f3);
  }
}

// Stage bf16 x rows [m0, m0 + BM) x columns [k0, k0 + KW): rows >= M and
// columns >= Kx zero.  x_vec: Kx % 8 == 0 and x 16-byte aligned; else the
// (edge-only) slow path loads element by element.
template <int BITS, class P>
__device__ __forceinline__ void fill_x(unsigned char* xs, const uint16_t* __restrict__ x,
                                       int64_t M, int Kx, int64_t m0, int k0, bool x_vec) {
  constexpr int kUnits = P::kKW / 8;
  for (int i = threadIdx.x; i < P::kBM * kUnits; i += P::kThreads) {
    const int r = i / kUnits, c = i % kUnits;
    const int64_t m = m0 + r;
    const int k = k0 + 8 * c;
    unsigned char* dst = xs + (r * P::kXRowUnits + x_swz<BITS>(c)) * 16;
    const uint16_t* src = x + m * Kx + k;
    if (x_vec) {
      const bool ok = m < M && k < Kx;
      cp_async16(dst, ok ? src : x, ok ? 16 : 0);
    } else {
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      for (int q = 0; q < 8; ++q)
        if (m < M && k + q < Kx) v[q / 2] |= uint32_t(src[q]) << (16 * (q % 2));
      *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// Stage packed bytes [kb0, kb0 + kWRowRaw) of rows [0, BN): rows >= n_valid
// and bytes >= w_row_bytes zero.  w_vec: every row start 16-byte aligned.
template <class P>
__device__ __forceinline__ void fill_w(uint8_t* ws, const uint8_t* __restrict__ w,
                                       int64_t w_row_bytes, int n_valid, int64_t kb0,
                                       bool w_vec) {
  constexpr int kSeg = P::kWRowRaw / 16;
  for (int i = threadIdx.x; i < P::kBN * kSeg; i += P::kThreads) {
    const int r = i / kSeg, s = i % kSeg;
    const int64_t kb = kb0 + 16 * s;
    uint8_t* dst = ws + r * P::kWRow + 16 * s;
    const uint8_t* src = w + r * w_row_bytes + kb;
    if (w_vec) {
      const bool ok = r < n_valid && kb < w_row_bytes;
      cp_async16(dst, ok ? src : w, ok ? 16 : 0);
    } else {
      uint32_t v[4] = {0u, 0u, 0u, 0u};
      for (int b = 0; b < 16; ++b)
        if (r < n_valid && kb + b < w_row_bytes) v[b / 4] |= uint32_t(src[b]) << (8 * (b % 4));
      *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// One warp's chunks of one stage: chunk l = d * WK + wk of the stage (global
// chunk c0 + l), for its 16 channels and `frags` real token fragments.  The
// B registers pair x values (i, i + kHalf) as the A registers pair codes.
template <int BITS, int MF, int WK, int WN, bool DQ>
__device__ __forceinline__ void mma_stage(const unsigned char* xs, const uint8_t* ws, int wk,
                                          int wn, int lane, int c0, int nchunks, int frags,
                                          float s_lo, float s_hi, float (&acc)[MF][4]) {
  using B = MmaBits<BITS>;
  using P = MmaPlan<BITS, MF, WK, WN>;
  constexpr int kGW = B::kGroupWords;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int d = 0; d < B::kD; ++d) {
    const int l = d * WK + wk;
    if (c0 + l >= nchunks) break;                                   // warp-uniform
    const uint8_t* wr = ws + (16 * wn + g) * P::kWRow + l * 32 + t * 8;
    const uint2 lo = *reinterpret_cast<const uint2*>(wr);                 // row g
    const uint2 hi = *reinterpret_cast<const uint2*>(wr + 8 * P::kWRow);  // row g + 8
#pragma unroll
    for (int grp = 0; grp < 2 / kGW; ++grp) {
      uint32_t a[kGW][B::kStepsPerWord][4];
#pragma unroll
      for (int gw = 0; gw < kGW; ++gw) {
        const int word = grp * kGW + gw;
#pragma unroll
        for (int jj = 0; jj < B::kStepsPerWord; ++jj) {
          a_pairs<BITS, DQ>(word ? lo.y : lo.x, jj, s_lo, a[gw][jj][0], a[gw][jj][2]);
          a_pairs<BITS, DQ>(word ? hi.y : hi.x, jj, s_hi, a[gw][jj][1], a[gw][jj][3]);
        }
      }
      // this group's x: kGroupUnits 16-byte units of the quad's segment t
      const int u0 = (l * B::kChunk + t * B::kQ + grp * kGW * B::kPerWord) / 8;
#pragma unroll
      for (int f = 0; f < MF; ++f) {
        if (f >= frags) break;                                        // warp-uniform
        const unsigned char* xr = xs + (8 * f + g) * P::kXRowUnits * 16;
        uint32_t xw[4 * B::kGroupUnits];
#pragma unroll
        for (int q = 0; q < B::kGroupUnits; ++q) {
          const uint4 v = *reinterpret_cast<const uint4*>(xr + x_swz<BITS>(u0 + q) * 16);
          xw[4 * q] = v.x;
          xw[4 * q + 1] = v.y;
          xw[4 * q + 2] = v.z;
          xw[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int gw = 0; gw < kGW; ++gw)
#pragma unroll
          for (int jj = 0; jj < B::kStepsPerWord; ++jj) {
            // x (i, i + 1) and (i + kHalf, i + kHalf + 1), i = 2 jj, of word gw
            const uint32_t lo_x = xw[gw * B::kPerWord / 2 + jj];
            const uint32_t hi_x = xw[gw * B::kPerWord / 2 + jj + B::kHalf / 2];
            mma_bf16(acc[f], a[gw][jj], __byte_perm(lo_x, hi_x, 0x5410),
                     __byte_perm(lo_x, hi_x, 0x7632));
          }
      }
    }
  }
}

// One (BM x BN) output tile of y = (x @ w_int^T) * scale, or with DQ of
// y = x @ round_bf16(w_int * scale)^T, on the tensor cores.
//   x      (M, Kx) row-major bf16; columns Kx..K-1 read as 0
//   w      BN rows of K/F packed bytes (row stride w_row_bytes); rows >=
//          n_valid read as 0 and are not stored
//   out    f32, row stride ldo; column 0 of the tile at `out`
template <int BITS, int MF, int WK, int WN, bool DQ>
__device__ __forceinline__ void skinny_mma_tile(
    const uint16_t* __restrict__ x, int64_t M, int Kx, int K, const uint8_t* __restrict__ w,
    int64_t w_row_bytes, int n_valid, const float* __restrict__ scale, float* __restrict__ out,
    int64_t ldo, int64_t m0, unsigned char* smem, bool x_vec, bool w_vec) {
  using B = MmaBits<BITS>;
  using P = MmaPlan<BITS, MF, WK, WN>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wk = warp % WK, wn = warp / WK;
  const int nchunks = (K + B::kChunk - 1) / B::kChunk;
  const int nstages = (nchunks + P::kWinChunks - 1) / P::kWinChunks;
  const int64_t rows = M - m0;
  const int frags = rows >= P::kBM ? MF : static_cast<int>((rows + 7) / 8);
  const bool active = 16 * wn < n_valid;
  float s_lo = 0.0f, s_hi = 0.0f;
  if (DQ && active) {
    const int r = 16 * wn + (lane >> 2);
    s_lo = r < n_valid ? scale[r] : 0.0f;
    s_hi = r + 8 < n_valid ? scale[r + 8] : 0.0f;
  }
  float acc[MF][4];
#pragma unroll
  for (int f = 0; f < MF; ++f)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[f][i] = 0.0f;

  auto fill = [&](int s) {
    unsigned char* st = smem + (s % kMmaStages) * P::kStageBytes;
    fill_x<BITS, P>(st, x, M, Kx, m0, s * P::kKW, x_vec);
    fill_w<P>(st + P::kXBytes, w, w_row_bytes, n_valid, int64_t(s) * P::kWRowRaw, w_vec);
  };
#pragma unroll
  for (int s = 0; s < kMmaStages - 1; ++s) {
    if (s < nstages) fill(s);
    cp_async_commit();
  }
  for (int s = 0; s < nstages; ++s) {
    cp_async_wait<kMmaStages - 2>();
    __syncthreads();                         // stage s landed; stage s - 1 is free
    if (s + kMmaStages - 1 < nstages) fill(s + kMmaStages - 1);
    cp_async_commit();
    if (active) {
      const unsigned char* st = smem + (s % kMmaStages) * P::kStageBytes;
      mma_stage<BITS, MF, WK, WN, DQ>(st, st + P::kXBytes, wk, wn, lane, s * P::kWinChunks,
                                      nchunks, frags, s_lo, s_hi, acc);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the WK partial sums through shared memory, added in warp order
  float* red = reinterpret_cast<float*>(smem);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int f = 0; f < MF; ++f) {
    float* rr = red + (wk * P::kBM + 8 * f + 2 * t) * P::kRedRow + 16 * wn + g;
    rr[0] = acc[f][0];
    rr[P::kRedRow] = acc[f][1];
    rr[8] = acc[f][2];
    rr[P::kRedRow + 8] = acc[f][3];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < P::kBM * P::kBN; i += P::kThreads) {
    const int r = i / P::kBN, c = i % P::kBN;
    if (m0 + r >= M || c >= n_valid) continue;
    float v = red[r * P::kRedRow + c];
#pragma unroll
    for (int j = 1; j < WK; ++j) v = __fadd_rn(v, red[(j * P::kBM + r) * P::kRedRow + c]);
    out[(m0 + r) * ldo + c] = DQ ? v : __fmul_rn(v, scale[c]);
  }
}

// grid (ceil(M / BM), ceil(N / BN), E); per expert e: x (M, Kx) bf16,
// packed (N, K / F), scale (N,), out (M, N) f32, each stack's slices contiguous.
template <int BITS, int MF, int WK, int WN>
__global__ void __launch_bounds__(32 * WK * WN)
pergroup_mma_kernel(const uint16_t* __restrict__ x, int64_t M, int Kx, int K,
                    const uint8_t* __restrict__ packed, int N, const float* __restrict__ scale,
                    float* __restrict__ out, int x_vec, int w_vec) {
  using P = MmaPlan<BITS, MF, WK, WN>;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  const int64_t e = blockIdx.z;
  const int64_t rb = K / (8 / BITS);
  x += e * M * Kx;
  packed += e * N * rb;
  scale += e * N;
  out += e * M * N;
  const int n0 = blockIdx.y * P::kBN;
  const int n_valid = N - n0 < P::kBN ? N - n0 : P::kBN;
  skinny_mma_tile<BITS, MF, WK, WN, false>(x, M, Kx, K, packed + n0 * rb, rb, n_valid,
                                           scale + n0, out + n0, N,
                                           int64_t(blockIdx.x) * P::kBM, mma_smem,
                                           x_vec != 0, w_vec != 0);
}

// Rows [m0, m0 + BM) of the BN columns col0.. (in walk order, inside one
// tile) of one ragged fused buffer: x (M, Kx) bf16, packed its buffer,
// scales (T * tile_n,), out (M, T * tile_n).  DQ: K3's tiles,
// round_bf16(w_int * s) before the product; else K1's, scaled after it.
template <int MF, int WK, int WN, bool DQ>
__device__ __forceinline__ void fused_mma_tile(const uint16_t* __restrict__ x, int64_t M,
                                               int Kx, int Kp, const uint8_t* __restrict__ packed,
                                               const int* __restrict__ table,
                                               const float* __restrict__ scales,
                                               float* __restrict__ out, int T, int tile_n,
                                               int col0, int64_t m0, unsigned char* smem,
                                               bool xv, bool wv) {
  constexpr int kBN = 16 * WN;
  const int tile = col0 / tile_n;
  const int bits = table[2 * tile];
  const int64_t ldo = int64_t(T) * tile_n;
  const int64_t rb = Kp / (8 / bits);
  const uint8_t* w = packed + table[2 * tile + 1] + int64_t(col0 - tile * tile_n) * rb;
  const float* s = scales + col0;
  float* o = out + col0;
  if (bits == 2) {
    skinny_mma_tile<2, MF, WK, WN, DQ>(x, M, Kx, Kp, w, rb, kBN, s, o, ldo, m0, smem, xv, wv);
  } else if (bits == 4) {
    skinny_mma_tile<4, MF, WK, WN, DQ>(x, M, Kx, Kp, w, rb, kBN, s, o, ldo, m0, smem, xv, wv);
  } else {
    skinny_mma_tile<8, MF, WK, WN, DQ>(x, M, Kx, Kp, w, rb, kBN, s, o, ldo, m0, smem, xv, wv);
  }
}

// grid (ceil(M / BM), T * tile_n / BN): block (i, j) computes rows
// [i*BM, i*BM+BM) of the BN columns j*BN.. of the fused GEMM (K1), x bf16.
template <int MF, int WK, int WN>
__global__ void __launch_bounds__(32 * WK * WN)
fused_mma_kernel(const uint16_t* __restrict__ x, int64_t M, int Kx, int Kp,
                 const uint8_t* __restrict__ packed, int64_t expert_bytes,
                 const int* __restrict__ table, const float* __restrict__ scales,
                 float* __restrict__ out, int T, int tile_n, int x_vec, int w_vec) {
  extern __shared__ __align__(16) unsigned char mma_smem[];
  fused_mma_tile<MF, WK, WN, false>(x, M, Kx, Kp, packed, table, scales, out, T, tile_n,
                                    blockIdx.y * 16 * WN, int64_t(blockIdx.x) * 8 * MF,
                                    mma_smem, x_vec != 0, w_vec != 0);
}

// grid (ceil(M / BM), T * tile_n / BN, E): as `fused_mma_kernel` for expert
// blockIdx.z (K3).  Per expert as `fused_experts_kernel`, x bf16.
template <int MF, int WK, int WN>
__global__ void __launch_bounds__(32 * WK * WN)
fused_experts_mma_kernel(const uint16_t* __restrict__ x, int64_t M, int Kx, int Kp,
                         const uint8_t* __restrict__ packed, int64_t expert_bytes,
                         const int* __restrict__ table, const float* __restrict__ scales,
                         float* __restrict__ out, int T, int tile_n, int x_vec, int w_vec) {
  extern __shared__ __align__(16) unsigned char mma_smem[];
  const int64_t e = blockIdx.z;
  const int64_t ldo = int64_t(T) * tile_n;
  fused_mma_tile<MF, WK, WN, true>(x + e * M * Kx, M, Kx, Kp, packed + e * expert_bytes, table,
                                   scales + e * ldo, out + e * M * ldo, T, tile_n,
                                   blockIdx.y * 16 * WN, int64_t(blockIdx.x) * 8 * MF,
                                   mma_smem, x_vec != 0, w_vec != 0);
}

template <int BITS, int MF, int WK, int WN>
int launch_pergroup_mma(const uint16_t* x, int64_t M, int Kx, int K, const uint8_t* packed,
                        int N, const float* scale, int E, float* out, bool x_vec, bool w_vec,
                        cudaStream_t stream) {
  using P = MmaPlan<BITS, MF, WK, WN>;
  auto kernel = pergroup_mma_kernel<BITS, MF, WK, WN>;
  static const cudaError_t attr = allow_smem(kernel, P::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>((M + P::kBM - 1) / P::kBM),
                  static_cast<unsigned>((N + P::kBN - 1) / P::kBN), static_cast<unsigned>(E));
  kernel<<<grid, P::kThreads, P::kSmem, stream>>>(x, M, Kx, K, packed, N, scale, out, x_vec,
                                                   w_vec);
  return static_cast<int>(cudaGetLastError());
}

// One launch of the fused buffer's tensor-core kernel: K1 (DQ false, E 1)
// or K3 (DQ true).
template <int MF, int WK, int WN, bool DQ>
int launch_fused_mma(const uint16_t* x, int64_t M, int Kx, int Kp, const uint8_t* packed,
                     int64_t expert_bytes, const int* table, const float* scales, int T,
                     int tile_n, int E, float* out, bool x_vec, bool w_vec,
                     cudaStream_t stream) {
  constexpr int kSmem2 = MmaPlan<2, MF, WK, WN>::kSmem, kSmem4 = MmaPlan<4, MF, WK, WN>::kSmem,
                kSmem8 = MmaPlan<8, MF, WK, WN>::kSmem;
  constexpr int kSmem = kSmem2 > kSmem4 ? (kSmem2 > kSmem8 ? kSmem2 : kSmem8)
                                        : (kSmem4 > kSmem8 ? kSmem4 : kSmem8);
  constexpr int kBM = 8 * MF, kBN = 16 * WN;
  if (tile_n % kBN) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = DQ ? fused_experts_mma_kernel<MF, WK, WN> : fused_mma_kernel<MF, WK, WN>;
  static const cudaError_t attr = allow_smem(kernel, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(static_cast<unsigned>((M + kBM - 1) / kBM),
                  static_cast<unsigned>(int64_t(T) * tile_n / kBN), static_cast<unsigned>(E));
  kernel<<<grid, 32 * WK * WN, kSmem, stream>>>(x, M, Kx, Kp, packed, expert_bytes, table,
                                                 scales, out, T, tile_n, x_vec, w_vec);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// The SIMT routine, x f32.
#define QMM_SIMT_TILES(CASE) CASE(1) CASE(2) CASE(4) CASE(8) CASE(16) CASE(32) CASE(64) CASE(128)

extern "C" int qmm_fused_f32(const void* x, long long M, int Kx, int Kp,
                             const void* packed, const void* table, const void* scales,
                             int T, int tile_n, void* out, void* stream) {
  const auto* xf = static_cast<const float*>(x);
  const auto* p = static_cast<const uint8_t*>(packed);
  const auto* tb = static_cast<const int*>(table);
  const auto* s = static_cast<const float*>(scales);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const bool xv = Kx % 4 == 0 && aligned16(x);
#define QMM_F(TN) \
  if (tile_n == TN) return launch_fused<TN>(xf, M, Kx, Kp, p, tb, s, T, o, xv, st);
  QMM_SIMT_TILES(QMM_F)
#undef QMM_F
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int qmm_pergroup_f32(const void* x, long long M, int Kx, int K,
                                const void* packed, int N, const void* scale, int bits,
                                int E, void* out, void* stream) {
  const auto* xf = static_cast<const float*>(x);
  const auto* p = static_cast<const uint8_t*>(packed);
  const auto* s = static_cast<const float*>(scale);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (E < 1 || E > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const bool xv = Kx % 4 == 0 && aligned16(x);
  switch (bits) {
    case 2: return launch_pergroup<2>(xf, M, Kx, K, p, N, s, E, o, xv, st);
    case 4: return launch_pergroup<4>(xf, M, Kx, K, p, N, s, E, o, xv, st);
    case 8: return launch_pergroup<8>(xf, M, Kx, K, p, N, s, E, o, xv, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int qmm_fused_experts_f32(const void* x, long long M, int Kx, int Kp,
                                     const void* packed, long long expert_bytes,
                                     const void* table, const void* scales, int T,
                                     int tile_n, int E, int round_bf16, void* out,
                                     void* stream) {
  const auto* xf = static_cast<const float*>(x);
  const auto* p = static_cast<const uint8_t*>(packed);
  const auto* tb = static_cast<const int*>(table);
  const auto* s = static_cast<const float*>(scales);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (E < 1 || E > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const bool xv = Kx % 4 == 0 && aligned16(x);
#define QMM_E(TN)                                                                          \
  if (tile_n == TN)                                                                        \
    return launch_fused_experts<TN>(xf, M, Kx, Kp, p, expert_bytes, tb, s, T, E, round_bf16, \
                                    o, xv, st);
  QMM_SIMT_TILES(QMM_E)
#undef QMM_E
  return static_cast<int>(cudaErrorInvalidValue);
}
#undef QMM_SIMT_TILES

// The tensor-core path, x bf16.  (mf, wk, wn) is the plan of
// `quant_matmul.mma_plan`: (1, 4, 4) at M <= 32 (decode and verify), (8, 1,
// 8) above;
// for the fused kernels wn is cut to tile_n / 16 where that is smaller
// (`fused_3d_mma_plan`).
extern "C" int qmm_pergroup_mma(const void* x, long long M, int Kx, int K, const void* packed,
                                int N, const void* scale, int bits, int E, int mf, int wk,
                                int wn, void* out, void* stream) {
  const auto* xb = static_cast<const uint16_t*>(x);
  const auto* p = static_cast<const uint8_t*>(packed);
  const auto* s = static_cast<const float*>(scale);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (E < 1 || E > 65535 || K % (8 / bits)) return static_cast<int>(cudaErrorInvalidValue);
  const bool xv = Kx % 8 == 0 && aligned16(x);
  const bool wv = (K / (8 / bits)) % 16 == 0 && aligned16(packed);
  const int plan = mf * 100 + wk * 10 + wn;
#define QMM_PG(B, MF, WK, WN)                                                           \
  if (bits == B && plan == MF * 100 + WK * 10 + WN)                                      \
    return launch_pergroup_mma<B, MF, WK, WN>(xb, M, Kx, K, p, N, s, E, o, xv, wv, st);
#define QMM_PG_PLANS(B) QMM_PG(B, 1, 4, 4) QMM_PG(B, 8, 1, 8)
  QMM_PG_PLANS(2)
  QMM_PG_PLANS(4)
  QMM_PG_PLANS(8)
#undef QMM_PG_PLANS
#undef QMM_PG
  return static_cast<int>(cudaErrorInvalidValue);
}

// The fused buffer on the tensor cores: K3 (dq 1, E experts, each tile
// rounded before the product) or K1 (dq 0, E 1, expert_bytes 0, scaled
// after the sum).
extern "C" int qmm_fused_mma(const void* x, long long M, int Kx, int Kp, const void* packed,
                             long long expert_bytes, const void* table, const void* scales,
                             int T, int tile_n, int E, int dq, int mf, int wk, int wn,
                             void* out, void* stream) {
  const auto* xb = static_cast<const uint16_t*>(x);
  const auto* p = static_cast<const uint8_t*>(packed);
  const auto* tb = static_cast<const int*>(table);
  const auto* s = static_cast<const float*>(scales);
  auto* o = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (E < 1 || E > 65535 || Kp % 4 || (!dq && E != 1)) return static_cast<int>(cudaErrorInvalidValue);
  const bool xv = Kx % 8 == 0 && aligned16(x);
  const bool wv = Kp % 64 == 0 && expert_bytes % 16 == 0 && aligned16(packed);
  const int plan = mf * 100 + wk * 10 + wn;
#define QMM_FM(MF, WK, WN)                                                                 \
  if (plan == MF * 100 + WK * 10 + WN)                                                     \
    return dq ? launch_fused_mma<MF, WK, WN, true>(xb, M, Kx, Kp, p, expert_bytes, tb, s, T, \
                                                   tile_n, E, o, xv, wv, st)               \
              : launch_fused_mma<MF, WK, WN, false>(xb, M, Kx, Kp, p, expert_bytes, tb, s, \
                                                    T, tile_n, E, o, xv, wv, st);
#define QMM_FM_WN(MF, WK) QMM_FM(MF, WK, 1) QMM_FM(MF, WK, 2) QMM_FM(MF, WK, 4)
  QMM_FM_WN(1, 4)
  QMM_FM_WN(8, 1)
  QMM_FM(8, 1, 8)
#undef QMM_FM_WN
#undef QMM_FM
  return static_cast<int>(cudaErrorInvalidValue);
}
