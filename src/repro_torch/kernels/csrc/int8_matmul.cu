// Dynamic int8 x int8 -> int32 GEMM with a fused dequant epilogue, for
// Hopper (sm_90a) on the int8 tensor cores: the three products of every
// dense layer of int8 training.
//
// Replaces the Pallas kernel `_int8_mm_kernel` of
// src/repro/kernels/int8_matmul.py (`scaled_int8_mm`):
//
//   out[m, n] = float(sum_k a[m, k] * b[n, k]) * sa[m] * sb[n]
//
// with a (M, K) and b (N, K) int8, both contiguous along K, and the epilogue
// `__fmul_rn(__fmul_rn(__int2float_rn(acc), sa[m]), sb[n])` in that order.
// The int32 sum of int8 products is exact in any order (K <= 133144 keeps
// every partial sum within 127 * 127 * K < 2^31; the wrapper raises above
// it), so the kernels equal their plain version and the reference bitwise,
// whatever their tiling or split of K.  The mma accumulates in plain s32
// (never .satfinite, which would clamp).
//
// Every product runs `mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32`: a is
// the row-major A operand and b the column-major B operand as they lie (both
// K-contiguous), so `ldmatrix` (b16 view) loads both fragments from shared
// memory with no transpose.  A warp owns 16 rows x 8 NF columns; a block is
// WM x WN warps.  Shared rows are padded to an odd multiple of 16 bytes,
// which keeps the eight rows of every `ldmatrix` phase on distinct banks.
// Shared memory is filled by cp.async (16-byte copies, zero fill past the
// edges; zero bytes past K are exact).  The epilogue dequantizes each
// warp's fragment (two neighbouring n of rows g and g + 8 a thread; the
// column scales loaded once a block) into a staged f32 tile in shared
// memory, and writes the output as 16-byte row-contiguous stores (scalar
// ones where N % 4 != 0).
//
// What bounds it, per product class (the plan is `k5_plan` in
// kernels/int8_matmul.py):
// * Tall M, short K (forward and grad-input: M = B * Ho * Wo up to 65536,
//   K <= 576): the f32 (M, N) output, then a's bytes; the operations are a
//   few percent of the bound.  `panel_kernel`: b's (BN x Kp) panel is loaded
//   once and stays in shared memory for the block's life, and the block
//   walks M tiles (16 WM rows), the next tile's a in flight (cp.async, two
//   buffers) during this tile's mma and stores.  Rows that are not 16-byte
//   aligned (K % 16 != 0: conv0's K 27) are copied as the one contiguous
//   span an M tile is, with aligned 16-byte cp.async, and re-laid out in
//   shared memory (a funnel shift a 4-byte word).
// * Tall K, small output (grad-weight: (c_out, C k k) over K = B * Ho * Wo
//   up to 65536): b's bytes; the output's tiles are one to a few blocks.
//   `split_kernel`: the block covers the output's rows at 16-row
//   granularity (no padded 64-row tile), K streams through a ring of four
//   128-byte stages, and K is split over gridDim.z so that the blocks fill
//   the card.  A split product is ONE launch: each block adds its int32
//   partial tile into a workspace with `red.global.add` (integer addition
//   is exact in any order), fences, and counts its arrival on the tile's
//   counter with `atomicInc(limit splits - 1)`, which wraps to 0 by itself;
//   the last block reads the tile's sums, writes zeros back and applies the
//   epilogue.  Workspace and counters are left zeroed for the next product
//   on the stream.  Adding into one tile (not writing per-split slices for
//   the last block to sum) keeps that block's read to one tile whatever
//   the number of splits.
// * Tiny products (fc, M N K <= 2^20): `split_kernel` with one or a few
//   blocks and no split; their time is the launch's.
//
// C interface (bound with ctypes): launches on the given stream, allocates
// nothing, returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kStep = 32;            // K bytes of one mma
constexpr int kChunk = 128;          // K bytes a stage of the split kernel's ring
constexpr int kStages = 4;           // the ring's depth
constexpr int kRowPad = 16;          // shared rows of Kp + 16 bytes: odd x 16
constexpr int kSmemMax = 232448;     // dynamic shared memory a block may use
constexpr int kMaxThreads = 256;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// cp.async with zero fill: `bytes` of the source are copied, the rest of
// the 16 destination bytes are zeroed (bytes = 0 reads nothing).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(addr) : "memory");
}

// d += a (16 x 32, row) * b (32 x 8, col), s8 operands, exact s32 sums.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float dequant(int acc, float sa, float sb) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), sa), sb);
}

// The row stride, in 4-byte words, of a warp's staged f32 epilogue tile:
// 8 NF columns padded to 8 mod 32 words, so the fragment's 8-byte writes
// are conflict-free and the 16-byte reads aligned.
template <int NF>
struct Stage {
  static constexpr int kW = 8 * NF + (40 - (8 * NF) % 32) % 32;
  static constexpr int kBytes = 16 * kW * 4;
};

// One 32-byte K step of a warp's 16 x 8 NF tile.  a_row0: shared address
// of the warp's first a row; b_row0: of its first b row (its first output
// column); rows `stride` bytes apart; kb: the step's byte offset.
template <int NF>
__device__ __forceinline__ void warp_step(uint32_t a_row0, uint32_t b_row0, int stride,
                                          int lane, int kb, int (&acc)[NF][4]) {
  uint32_t af[4];
  // lanes 0-15 address rows 0-15 at bytes 0-15, lanes 16-31 at bytes 16-31:
  // a0..a3 = (rows 0-7, k 0-15), (8-15, 0-15), (0-7, 16-31), (8-15, 16-31)
  ldsm_x4(af, a_row0 + (lane & 15) * stride + kb + (lane >> 4) * 16);
#pragma unroll
  for (int j = 0; j + 1 < NF; j += 2) {
    // (cols 8j..8j+7, k 0-15), (.., 16-31), (cols 8j+8.., 0-15), (.., 16-31)
    uint32_t bf[4];
    ldsm_x4(bf, b_row0 + (8 * j + ((lane >> 4) << 3) + (lane & 7)) * stride + kb +
                    ((lane >> 3) & 1) * 16);
    mma_s8(acc[j], af, bf[0], bf[1]);
    mma_s8(acc[j + 1], af, bf[2], bf[3]);
  }
  if constexpr (NF % 2 == 1) {
    uint32_t b0, b1;
    ldsm_x2(b0, b1, b_row0 + (8 * (NF - 1) + (lane & 7)) * stride + kb + ((lane >> 3) & 1) * 16);
    mma_s8(acc[NF - 1], af, b0, b1);
  }
}

// The column scales of a thread's fragment columns (n0 + 8 j + 2 t and
// + 1 of each of the warp's NF fragments; 0 past N) and the row scales of
// its rows (m0 + g and m0 + g + 8; 0 past M).
template <int NF>
__device__ __forceinline__ void col_scales(const float* __restrict__ sb, int n0, int N, int lane,
                                           float (&sbv)[NF][2]) {
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    const int n = n0 + 8 * j + 2 * (lane & 3);
    sbv[j][0] = n < N ? __ldg(sb + n) : 0.0f;
    sbv[j][1] = n + 1 < N ? __ldg(sb + n + 1) : 0.0f;
  }
}

__device__ __forceinline__ float2 row_scales(const float* __restrict__ sa, int64_t m0, int64_t M,
                                             int lane) {
  const int64_t m = m0 + (lane >> 2);
  return make_float2(m < M ? __ldg(sa + m) : 0.0f, m + 8 < M ? __ldg(sa + m + 8) : 0.0f);
}

// The epilogue of a warp's 16 x 8 NF tile at output (m0, n0): each thread
// dequantizes its fragment (rows g and g + 8, columns 2 t and 2 t + 1 of
// each 8-column fragment) into the warp's staged tile `st`
// (Stage<NF>::kBytes of shared memory), then the rows are read back 16
// bytes a lane and stored; rows >= M and columns >= N are not stored.
// vec: N % 4 == 0 (every 4-column group is 16-byte aligned in out).
template <int NF>
__device__ __forceinline__ void warp_store(float* st, const int (&acc)[NF][4],
                                           const float (&sbv)[NF][2], float2 sav, int lane,
                                           int64_t m0, int n0, int64_t M, int N,
                                           float* __restrict__ out, bool vec) {
  constexpr int W = Stage<NF>::kW;
  constexpr int kQ = 2 * NF;                 // 16-byte groups in a staged row
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    *reinterpret_cast<float2*>(st + g * W + 8 * j + 2 * t) =
        make_float2(dequant(acc[j][0], sav.x, sbv[j][0]), dequant(acc[j][1], sav.x, sbv[j][1]));
    *reinterpret_cast<float2*>(st + (g + 8) * W + 8 * j + 2 * t) =
        make_float2(dequant(acc[j][2], sav.y, sbv[j][0]), dequant(acc[j][3], sav.y, sbv[j][1]));
  }
  __syncwarp();
#pragma unroll 4
  for (int u = lane; u < 16 * kQ; u += 32) {
    const int r = u / kQ, q = u % kQ;
    const int64_t m = m0 + r;
    const int n = n0 + 4 * q;
    if (m >= M || n >= N) continue;
    const float4 v = *reinterpret_cast<const float4*>(st + r * W + 4 * q);
    float* o = out + m * N + n;
    if (vec) {
      *reinterpret_cast<float4*>(o) = v;
    } else {
      o[0] = v.x;
      if (n + 1 < N) o[1] = v.y;
      if (n + 2 < N) o[2] = v.z;
      if (n + 3 < N) o[3] = v.w;
    }
  }
  __syncwarp();
}

// The block's threads walk the (row, unit) pairs of a rows x units grid,
// thread i taking pairs i, i + blockDim.x, ... (one division, then adds).
template <class F>
__device__ __forceinline__ void for_each_unit(int rows, int units, F&& f) {
  int r = threadIdx.x / units, u = threadIdx.x % units;
  const int dr = blockDim.x / units, du = blockDim.x % units;
  while (r < rows) {
    f(r, u);
    u += du;
    r += dr;
    if (u >= units) {
      u -= units;
      ++r;
    }
  }
}

// Rows [0, rows) of a K-contiguous int8 matrix (row stride ld bytes, row 0
// at src), bytes [k0, k0 + width) (width a multiple of 16) into shared rows
// `stride` bytes apart: rows >= rows_valid and bytes >= kend read as 0.
// A 16-byte unit whose source is not 16-byte aligned (rows of K % 16 != 0,
// an edge of the split kernel) is read byte by byte.
__device__ __forceinline__ void load_rows(uint8_t* dst, int stride, const int8_t* __restrict__ src,
                                          int64_t ld, int rows, int rows_valid, int64_t k0,
                                          int width, int64_t kend) {
  for_each_unit(rows, width / 16, [&](int r, int u) {
    const int64_t k = k0 + 16 * u;
    const int bytes = (r < rows_valid && k < kend) ? (kend - k < 16 ? int(kend - k) : 16) : 0;
    const int8_t* p = src + r * ld + k;
    uint8_t* d = dst + r * stride + 16 * u;
    if (bytes == 0 || (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
      cp_async16(d, bytes ? p : src, bytes);
    } else {
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const uint32_t v =
            e < bytes ? uint32_t(static_cast<uint8_t>(__ldg(p + e))) << (8 * (e & 3)) : 0u;
        if (e < 4) w.x |= v; else if (e < 8) w.y |= v; else if (e < 12) w.z |= v; else w.w |= v;
      }
      *reinterpret_cast<uint4*>(d) = w;
    }
  });
}

// The offset of lo in the 16-byte unit it lies in.
__device__ __forceinline__ int unit_off(const int8_t* lo) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(lo) & 15);
}

// The contiguous bytes [lo, hi) into `raw` by aligned 16-byte cp.async,
// the first unit starting at lo rounded down to 16 (lo lands at raw +
// unit_off(lo)).  raw holds hi - lo + 32 bytes.
__device__ __forceinline__ void load_span(uint8_t* raw, const int8_t* lo, const int8_t* hi) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(lo) & ~uintptr_t(15);
  const uintptr_t end = reinterpret_cast<uintptr_t>(hi);
  const int units = static_cast<int>((end - base + 15) / 16);
  for (int u = threadIdx.x; u < units; u += blockDim.x) {
    const uintptr_t s = base + 16 * uintptr_t(u);
    const int bytes = end - s < 16 ? static_cast<int>(end - s) : 16;
    cp_async16(raw + 16 * u, reinterpret_cast<const void*>(s), bytes);
  }
}

// Row r of a staged span (K bytes at raw + off + r K) to shared row r of
// `stride` bytes, Kp bytes a row, a 4-byte word a thread: bytes >= K and
// rows >= rows_valid are 0.  raw holds 8 bytes past the span's end.
__device__ __forceinline__ void relayout(uint8_t* dst, int stride, const uint8_t* raw, int off,
                                         int rows, int rows_valid, int K, int Kp) {
  const uint32_t* raw32 = reinterpret_cast<const uint32_t*>(raw);
  for_each_unit(rows, Kp / 4, [&](int r, int w) {
    const int j = 4 * w;
    uint32_t v = 0u;
    if (r < rows_valid && j < K) {
      const int o = off + r * K + j;
      v = __funnelshift_r(raw32[o >> 2], raw32[(o >> 2) + 1], 8 * (o & 3));
      if (K - j < 4) v &= (1u << (8 * (K - j))) - 1u;
    }
    *reinterpret_cast<uint32_t*>(dst + r * stride + j) = v;
  });
}

// Shared-memory layout of `panel_kernel`, the same on the host and the card.
struct PanelSmem {
  int stride, a_tile, a_bufs, raw_a, raw, b_panel, stage, total;
  __host__ __device__ PanelSmem(int wm, int wn, int nf, int K, int Kp, bool a_vec, bool b_vec,
                                int stage_bytes) {
    const int bm = 16 * wm, bn = 8 * nf * wn;
    stride = Kp + kRowPad;
    b_panel = bn * stride;
    a_tile = bm * stride;
    a_bufs = a_vec ? 2 : 1;
    raw_a = a_vec ? 0 : (bm * K + 47) / 16 * 16;
    const int raw_b = b_vec ? 0 : (bn * K + 47) / 16 * 16;
    raw = 2 * raw_a > raw_b ? 2 * raw_a : raw_b;
    stage = wm * wn * stage_bytes;
    total = b_panel + a_bufs * a_tile + raw + stage;
  }
};

// Tall M, short K.  grid (grid_m, tiles_n), 32 WM WN threads: block (x, y)
// takes output columns [BN y, BN y + BN) (BN = 8 NF WN) and the M tiles x,
// x + grid_m, ... of 16 WM rows; warp w = wi + WM wj rows [16 wi, 16 wi +
// 16) and columns [8 NF wj, 8 NF wj + 8 NF) of each.  a_vec / b_vec: every
// row of a / b starts 16-byte aligned (K % 16 == 0).
template <int NF>
__global__ void __launch_bounds__(128)
panel_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
             const float* __restrict__ sa, const float* __restrict__ sb, int64_t M, int N,
             int K, int Kp, int wm, int64_t tiles_m, int a_vec, int b_vec, int out_vec,
             float* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int wn = blockDim.x / 32 / wm;
  const int wi = warp % wm, wj = warp / wm;
  const int bm = 16 * wm, bn = 8 * NF * wn;
  const PanelSmem L(wm, wn, NF, K, Kp, a_vec != 0, b_vec != 0, Stage<NF>::kBytes);
  const int S = L.stride;
  uint8_t* bs = smem;
  uint8_t* as = bs + L.b_panel;
  uint8_t* raw = as + L.a_bufs * L.a_tile;
  float* st = reinterpret_cast<float*>(raw + L.raw) + warp * (Stage<NF>::kBytes / 4);

  const int n0 = blockIdx.y * bn;
  const int n_valid = N - n0 < bn ? N - n0 : bn;
  const int8_t* b0 = b + int64_t(n0) * K;
  if (b_vec) {
    load_rows(bs, S, b0, K, bn, n_valid, 0, Kp, K);
    cp_async_commit();
  } else {
    load_span(raw, b0, b0 + int64_t(n_valid) * K);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    relayout(bs, S, raw, unit_off(b0), bn, n_valid, K, Kp);
    __syncthreads();
  }
  float sbv[NF][2];
  col_scales<NF>(sb, n0 + 8 * NF * wj, N, lane, sbv);

  auto issue_a = [&](int64_t tile, int buf) {
    const int64_t m0 = tile * bm;
    const int rv = M - m0 < bm ? static_cast<int>(M - m0) : bm;
    if (a_vec) {
      load_rows(as + buf * L.a_tile, S, a + m0 * K, K, bm, rv, 0, Kp, K);
    } else {
      load_span(raw + buf * L.raw_a, a + m0 * K, a + (m0 + rv) * K);
    }
  };

  int64_t tile = blockIdx.x;
  if (tile < tiles_m) issue_a(tile, 0);
  cp_async_commit();
  const uint32_t b_row0 = smem_u32(bs + 8 * NF * wj * S);
  for (int it = 0; tile < tiles_m; ++it, tile += gridDim.x) {
    const int buf = it & 1;
    const int64_t m0 = tile * bm;
    if (tile + gridDim.x < tiles_m) issue_a(tile + gridDim.x, buf ^ 1);
    cp_async_commit();
    const float2 sav = row_scales(sa, m0 + 16 * wi, M, lane);
    cp_async_wait<1>();                 // this tile's a (and the b panel) landed
    __syncthreads();
    const uint8_t* at = as + buf * L.a_tile;
    if (!a_vec) {
      const int rv = M - m0 < bm ? static_cast<int>(M - m0) : bm;
      relayout(as, S, raw + buf * L.raw_a, unit_off(a + m0 * K), bm, rv, K, Kp);
      __syncthreads();
      at = as;
    }
    int acc[NF][4];
#pragma unroll
    for (int j = 0; j < NF; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
    const uint32_t a_row0 = smem_u32(at + 16 * wi * S);
    for (int kb = 0; kb < Kp; kb += kStep) warp_step<NF>(a_row0, b_row0, S, lane, kb, acc);
    __syncthreads();                    // every warp is done with this tile's a
    warp_store<NF>(st, acc, sbv, sav, lane, m0 + 16 * wi, n0 + 8 * NF * wj, M, N, out,
                   out_vec != 0);
  }
  cp_async_wait<0>();
}

// Shared memory of `split_kernel`: the ring, reused by the epilogue.
__host__ __device__ inline int split_smem(int wm, int wn, int nf, int stage_bytes) {
  const int ring = kStages * (16 * wm + 8 * nf * wn) * (kChunk + kRowPad);
  const int stage = wm * wn * stage_bytes;
  return ring > stage ? ring : stage;
}

// Tall K, small output (and tiny products).  grid (tiles_m, tiles_n,
// splits), 32 WM WN threads: block (x, y, z) takes rows [16 WM x, ..) x
// columns [8 NF WN y, ..) over K bytes [z kper, z kper + kper); warp w =
// wi + WM wj its rows [16 wi, 16 wi + 16) and columns [8 NF wj, 8 NF wj +
// 8 NF) of the tile.  With splits > 1, ws holds tiles_m tiles_n x 32 WM WN
// x 4 NF int32 and counters tiles_m tiles_n words, all zero on entry and
// on exit.
template <int NF>
__global__ void __launch_bounds__(kMaxThreads)
split_kernel(const int8_t* __restrict__ a, const int8_t* __restrict__ b,
             const float* __restrict__ sa, const float* __restrict__ sb, int64_t M, int N,
             int64_t K, int wm, int64_t kper, int out_vec, int* __restrict__ ws,
             unsigned* __restrict__ counters, float* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int S = kChunk + kRowPad;
  const int nthr = blockDim.x, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid & 31;
  const int wn = nthr / 32 / wm;
  const int wi = warp % wm, wj = warp / wm;
  const int bm = 16 * wm, bn = 8 * NF * wn;
  const int64_t m0 = int64_t(blockIdx.x) * bm;
  const int n0 = blockIdx.y * bn;
  const int splits = gridDim.z;
  const int64_t kbeg = int64_t(blockIdx.z) * kper;
  const int64_t kend = kbeg + kper < K ? kbeg + kper : K;
  const int rows_a = M - m0 < bm ? static_cast<int>(M - m0) : bm;
  const int rows_b = N - n0 < bn ? N - n0 : bn;
  const int stage_bytes = (bm + bn) * S;
  const int nch = static_cast<int>((kend - kbeg + kChunk - 1) / kChunk);
  const bool active = m0 + 16 * wi < M && n0 + 8 * NF * wj < N;   // warp-uniform

  auto load = [&](int c) {
    uint8_t* s = smem + (c % kStages) * stage_bytes;
    const int64_t k0 = kbeg + int64_t(c) * kChunk;
    load_rows(s, S, a + m0 * K, K, bm, rows_a, k0, kChunk, kend);
    load_rows(s + bm * S, S, b + int64_t(n0) * K, K, bn, rows_b, k0, kChunk, kend);
  };

  int acc[NF][4];
#pragma unroll
  for (int j = 0; j < NF; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) {
    if (c < nch) load(c);
    cp_async_commit();
  }
  for (int c = 0; c < nch; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                    // chunk c landed; every warp is past chunk c - 1
    if (c + kStages - 1 < nch) load(c + kStages - 1);
    cp_async_commit();
    if (active) {
      const uint8_t* s = smem + (c % kStages) * stage_bytes;
      const uint32_t a_row0 = smem_u32(s + 16 * wi * S);
      const uint32_t b_row0 = smem_u32(s + (bm + 8 * NF * wj) * S);
      const int64_t left = kend - kbeg - int64_t(c) * kChunk;
#pragma unroll
      for (int kb = 0; kb < kChunk; kb += kStep)
        if (kb < left) warp_step<NF>(a_row0, b_row0, S, lane, kb, acc);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                      // the ring is free for the epilogue's stage
  float* st = reinterpret_cast<float*>(smem) + warp * (Stage<NF>::kBytes / 4);
  const int64_t wm0 = m0 + 16 * wi;
  const int wn0 = n0 + 8 * NF * wj;

  if (splits > 1) {
    __shared__ unsigned last;
    const unsigned tile = blockIdx.y * gridDim.x + blockIdx.x;
    int* wt = ws + int64_t(tile) * nthr * NF * 4;
    if (active) {
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) atomicAdd(wt + (4 * j + e) * nthr + tid, acc[j][e]);
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicInc(counters + tile, static_cast<unsigned>(splits - 1)) ==
                         static_cast<unsigned>(splits - 1);
    __syncthreads();
    if (!last) return;
    __threadfence();
    if (active) {
#pragma unroll
      for (int j = 0; j < NF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          int* p = wt + (4 * j + e) * nthr + tid;
          acc[j][e] = __ldcg(p);
          __stcg(p, 0);
        }
    }
  }
  if (active) {
    float sbv[NF][2];
    col_scales<NF>(sb, wn0, N, lane, sbv);
    warp_store<NF>(st, acc, sbv, row_scales(sa, wm0, M, lane), lane, wm0, wn0, M, N, out,
                   out_vec != 0);
  }
}

// Let the kernel take dynamic shared memory up to what its static shared
// memory leaves of kSmemMax.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel) {
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kSmemMax - static_cast<int>(attr.sharedSizeBytes));
}

template <int NF>
int launch(int kind, const int8_t* a, const int8_t* b, const float* sa, const float* sb,
           int64_t M, int N, int64_t K, int wm, int wn, int64_t grid_m, int tiles_n,
           int splits, int64_t kper, int* ws, unsigned* counters, float* out,
           cudaStream_t stream) {
  const int out_vec = N % 4 == 0;
  if (kind == 0) {
    const int Kp = static_cast<int>((K + kStep - 1) / kStep * kStep);
    const bool a_vec = K % 16 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0;
    const bool b_vec = K % 16 == 0 && reinterpret_cast<uintptr_t>(b) % 16 == 0;
    const PanelSmem L(wm, wn, NF, static_cast<int>(K), Kp, a_vec, b_vec, Stage<NF>::kBytes);
    if (wm * wn > 4 || splits != 1 || L.total > kSmemMax)
      return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = panel_kernel<NF>;
    static const cudaError_t attr = allow_smem(kernel);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const int64_t tiles_m = (M + 16 * wm - 1) / (16 * wm);
    const dim3 grid(static_cast<unsigned>(grid_m), static_cast<unsigned>(tiles_n));
    kernel<<<grid, 32 * wm * wn, L.total, stream>>>(a, b, sa, sb, M, N, static_cast<int>(K),
                                                     Kp, wm, tiles_m, a_vec, b_vec, out_vec, out);
  } else {
    const int smem = split_smem(wm, wn, NF, Stage<NF>::kBytes);
    if (32 * wm * wn > kMaxThreads || kper % kChunk != 0 || grid_m * 16 * wm < M ||
        (grid_m - 1) * 16 * wm >= M || (splits > 1) != (ws != nullptr && counters != nullptr) ||
        smem > kSmemMax - 16)
      return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = split_kernel<NF>;
    static const cudaError_t attr = allow_smem(kernel);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    const dim3 grid(static_cast<unsigned>(grid_m), static_cast<unsigned>(tiles_n),
                    static_cast<unsigned>(splits));
    kernel<<<grid, 32 * wm * wn, smem, stream>>>(a, b, sa, sb, M, N, K, wm, kper, out_vec, ws,
                                                  counters, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a (M, K) int8, b (N, K) int8, sa (M,) f32, sb (N,) f32 -> out (M, N) f32,
// by the plan of `k5_plan`: kind 0 = panel_kernel, 1 = split_kernel; nf
// (one of 1, 2, 3, 4, 6, 8, 9, 12, 16, 18), wm, wn the warp grid; grid_m blocks
// along M (the panel kernel's M-tile walkers, else the M tiles), tiles_n
// along N; splits of kper K bytes each (a multiple of 128); with splits > 1,
// ws and counters zeroed as `split_kernel` says (it leaves them zeroed).
extern "C" int i8mm_tc(const void* a, const void* b, const void* sa, const void* sb,
                       long long M, int N, long long K, int kind, int nf, int wm, int wn,
                       long long grid_m, int tiles_n, int splits, long long kper, void* ws,
                       void* counters, void* out, void* stream) {
  const auto* a8 = static_cast<const int8_t*>(a);
  const auto* b8 = static_cast<const int8_t*>(b);
  const auto* saf = static_cast<const float*>(sa);
  const auto* sbf = static_cast<const float*>(sb);
  auto* o = static_cast<float*>(out);
  auto* w = static_cast<int*>(ws);
  auto* cnt = static_cast<unsigned*>(counters);
  auto st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || K > 133144 || (kind != 0 && kind != 1) || grid_m <= 0 ||
      tiles_n <= 0 || wm <= 0 || wn <= 0 || int64_t(tiles_n) * 8 * nf * wn < N ||
      int64_t(tiles_n - 1) * 8 * nf * wn >= N || splits <= 0 || kper <= 0 ||
      int64_t(splits) * kper < K || int64_t(splits - 1) * kper >= K) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define K5_CASE(NFV)                                                                        \
  case NFV:                                                                                 \
    return launch<NFV>(kind, a8, b8, saf, sbf, M, N, K, wm, wn, grid_m, tiles_n, splits,    \
                       kper, w, cnt, o, st);
  switch (nf) {
    K5_CASE(1) K5_CASE(2) K5_CASE(3) K5_CASE(4) K5_CASE(6) K5_CASE(8) K5_CASE(9) K5_CASE(12)
    K5_CASE(16) K5_CASE(18)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef K5_CASE
}
