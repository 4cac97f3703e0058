"""Packed mixed-precision GEMMs: hand-written CUDA kernels and their plain
PyTorch versions.

Counterpart of ``repro.kernels.quant_matmul``.  One deployed weight is

    y[m, n] = scale[n] * sum_k x[m, k] * w_int[n, k]

with ``w_int`` stored packed (4x int2 / 2x int4 / 1x int8 per byte).

* :func:`quant_matmul_fused_2d` replaces the Pallas ``_fused_kernel``
  (2-D, ``dequant_first=False``): ONE launch over the ragged fused buffer
  whose ``tile_n``-wide output tiles each have one static bit-width.
* :func:`quant_matmul_2d` replaces the Pallas ``_kernel``: one precision
  group, packed ``(N, K/f)``, any K; or, with a leading expert axis
  (packed ``(E, N, K/f)``), that group of every expert in ONE launch.
* :func:`quant_matmul_fused_3d` replaces the Pallas ``_fused_kernel`` in
  its expert-batched 3-D form (``dequant_first=True``): the whole ragged
  fused buffer of every expert of a MoE stack in ONE launch, each weight
  tile scaled (and rounded to the compute dtype) before the product.

All three launch ``csrc/quant_matmul.cu`` (see the note at its top for what
bounds the kernels on the card and what the design does about it) when
given CUDA tensors, and run their plain version when given CPU tensors —
never the other way round, and never a fall-back after a failed launch.
Each wrapper counts its launches in a plain int attribute, ``launches``,
and those that took the tensor-core path in a second one, ``mma_launches``.

Two device routines, picked by pure functions of the shapes
(:func:`fused_2d_path`, :func:`pergroup_path`, :func:`fused_3d_path`).  At
f32 compute every kernel runs the SIMT one, which reduces every output's K
terms in ascending order in one f32 FMA chain (its block shape changes no
sum).  At bf16 compute the per-group kernel
at every K and the fused and expert kernels at ``tile_n >= 16`` run the
tensor-core routine: exact bf16 products, f32 sums in the tensor cores'
order, K split over the warps of a block by :func:`mma_plan`, which depends
on M alone, so an expert's slice of an expert-axis launch equals its own
launch and a fused tile sums as the per-group launch of its channels.  So
the fused and per-group kernels equal each other bitwise on the card at
f32, and at bf16 wherever ``tile_n >= 16``.  The plain versions use
``torch.matmul`` and agree with the kernels to f32 rounding; the plain
expert versions walk the experts in chunks (a deepseek-v3 expert stack
dequantized at once is 8.5 GB in f32).
"""
from __future__ import annotations

import torch

from repro_torch.core import quantizers as qz
from repro_torch.kernels import _build

# Deepest padded contraction the fused layout is built for (the reference's
# single-step limit; deeper weights stay per-group, which loops any K).
K_SINGLE_STEP_MAX = 2048

# Byte granularity every fused buffer pads K to: the largest pack factor
# (int2 -> 4 values/byte), so one common Kp serves all bit-widths.
FUSED_K_ALIGN = 4

FUSED_TILE_NS = (1, 2, 4, 8, 16, 32, 64, 128)   # tile widths the kernel takes


def pick_bk(Kp: int, f: int, bk: int = 512) -> int:
    """K step of the reference's per-group kernel: the whole ``Kp`` up to
    ``K_SINGLE_STEP_MAX``, else the largest power-of-two divisor of ``Kp``
    not above ``bk`` that the pack factor divides (else one step).  The
    plain per-group version sums its K steps in the same chunks."""
    if Kp <= K_SINGLE_STEP_MAX:
        return Kp
    bk_ = bk
    while Kp % bk_ or (bk_ % f):
        bk_ //= 2
        if bk_ < f:
            return Kp
    return bk_


def fused_tile_bytes(bits: int, Kp: int, tile_n: int) -> int:
    """Byte footprint of ONE output tile in the ragged fused buffer."""
    return tile_n * (Kp // qz.pack_factor(bits))


def fused_tile_offsets(tile_bits, Kp: int, tile_n: int) -> tuple:
    """Per-tile byte offsets into the fused buffer (walk order)."""
    offs, off = [], 0
    for b in tile_bits:
        offs.append(off)
        off += fused_tile_bytes(b, Kp, tile_n)
    return tuple(offs)


def fused_table(tile_bits, Kp: int, tile_n: int) -> torch.Tensor:
    """``(T, 2)`` int32 ``[bits, byte offset]`` per tile: the schedule as
    the fused kernel reads it (built once at deploy)."""
    offs = fused_tile_offsets(tile_bits, Kp, tile_n)
    end = offs[-1] + fused_tile_bytes(tile_bits[-1], Kp, tile_n)
    if end >= 2 ** 31:
        raise ValueError(f"fused buffer of {end} bytes exceeds int32 offsets")
    return torch.tensor(list(zip(tile_bits, offs)), dtype=torch.int32)


# ---------------------------------------------------------------------------
# Plain versions (the CPU path and the kernels' oracle on the card)
# ---------------------------------------------------------------------------

def _pad_cols(x: torch.Tensor, K: int) -> torch.Tensor:
    return torch.nn.functional.pad(x, (0, K - x.shape[-1])) if x.shape[-1] < K else x


# f32 elements of one chunk of dequantized experts in the plain versions
PLAIN_CHUNK_ELEMS = 1 << 27


def expert_chunks(E: int, per_expert: int):
    """Slices of an expert axis of ``E`` whose ``per_expert`` elements
    each stay within ``PLAIN_CHUNK_ELEMS`` a chunk (at least one expert)."""
    step = max(1, PLAIN_CHUNK_ELEMS // max(per_expert, 1))
    return [slice(e0, min(e0 + step, E)) for e0 in range(0, E, step)]


def _pergroup_plain(x, packed, scale, bits):
    w = qz.unpack_int(packed, bits).to(torch.float32)             # (..., N, K)
    K = w.shape[-1]
    x = _pad_cols(x.to(torch.float32), K)
    bk = pick_bk(K, qz.pack_factor(bits))
    acc = x[..., :bk] @ w[..., :bk].mT
    for k0 in range(bk, K, bk):
        acc = acc + x[..., k0:k0 + bk] @ w[..., k0:k0 + bk].mT
    return acc * scale.to(torch.float32)[..., None, :]


def quant_matmul_2d_plain(x: torch.Tensor, packed: torch.Tensor,
                          scale: torch.Tensor, bits: int) -> torch.Tensor:
    """``x (M, <=K) @ unpack(packed (N, K/f))^T * scale`` in f32, K summed in
    the reference kernel's ``pick_bk`` steps; with an expert axis, ``x (E, M,
    <=K)``, packed ``(E, N, K/f)`` and scale ``(E, N)`` give ``(E, M, N)``."""
    if packed.ndim == 2:
        return _pergroup_plain(x, packed, scale, bits)
    E, N, Kb = packed.shape
    out = torch.empty((E, x.shape[1], N), dtype=torch.float32, device=x.device)
    for sl in expert_chunks(E, N * Kb * qz.pack_factor(bits)):
        out[sl] = _pergroup_plain(x[sl], packed[sl], scale[sl], bits)
    return out


def fused_dense_int(fused_packed: torch.Tensor, tile_bits, Kp: int,
                    tile_n: int) -> torch.Tensor:
    """Unpack the ragged fused buffer ``(..., bytes)`` to ``(..., T * tile_n,
    Kp)`` int8, walk order (a leading expert axis is kept)."""
    lead = fused_packed.shape[:-1]
    rows = []
    for b, off in zip(tile_bits, fused_tile_offsets(tile_bits, Kp, tile_n)):
        seg = fused_packed[..., off: off + fused_tile_bytes(b, Kp, tile_n)]
        rows.append(qz.unpack_int(seg.reshape(*lead, tile_n, -1), b))
    return torch.cat(rows, dim=-2)


def quant_matmul_fused_2d_plain(x: torch.Tensor, fused_packed: torch.Tensor,
                                fused_scales: torch.Tensor, tile_bits, *,
                                Kp: int, tile_n: int) -> torch.Tensor:
    """``x (M, <=Kp)`` against the ragged fused buffer -> ``(M, T * tile_n)``."""
    w = fused_dense_int(fused_packed, tile_bits, Kp, tile_n).to(torch.float32)
    return (_pad_cols(x.to(torch.float32), Kp) @ w.T) * fused_scales


def fused_3d_dense(fused_packed: torch.Tensor, fused_scales: torch.Tensor, tile_bits, *,
                   Kp: int, tile_n: int, compute_dtype=torch.float32) -> torch.Tensor:
    """The expert kernel's weights: ``round_cd(w_int * scale)`` as f32,
    ``(E, T * tile_n, Kp)`` in walk order."""
    w = fused_dense_int(fused_packed, tile_bits, Kp, tile_n).to(torch.float32)
    return (w * fused_scales[..., None]).to(compute_dtype).to(torch.float32)


def fused_3d_error_bound(x: torch.Tensor, fused_packed: torch.Tensor,
                         fused_scales: torch.Tensor, tile_bits, *, Kp: int, tile_n: int,
                         compute_dtype=torch.float32) -> torch.Tensor:
    """Per-output bound of the expert kernel's f32 sums against its plain
    version's: ``2 (Kp + 2) u sum_k |x_k w_k|`` with ``u = 2^-24`` and ``w``
    the rounded dequantized weight, the forward-error bound of two f32 dot
    products that sum the same products in other orders (before any
    rounding to an output dtype).  ``(E, M, T * tile_n)``, f32."""
    E = fused_packed.shape[0]
    out = torch.empty((E, x.shape[1], len(tile_bits) * tile_n), dtype=torch.float32,
                      device=x.device)
    xa = _pad_cols(x.to(torch.float32), Kp).abs()
    for sl in expert_chunks(E, len(tile_bits) * tile_n * Kp):
        w = fused_3d_dense(fused_packed[sl], fused_scales[sl], tile_bits, Kp=Kp,
                           tile_n=tile_n, compute_dtype=compute_dtype)
        out[sl] = xa[sl] @ w.abs().mT
    return out * (2 * (Kp + 2) * 2.0 ** -24)


def quant_matmul_fused_3d_plain(x: torch.Tensor, fused_packed: torch.Tensor,
                                fused_scales: torch.Tensor, tile_bits, *, Kp: int,
                                tile_n: int, compute_dtype=torch.float32) -> torch.Tensor:
    """``x (E, M, <=Kp)`` against each expert's ragged fused buffer ->
    ``(E, M, T * tile_n)`` f32: every weight tile dequantized first,
    ``w = round_cd(w_int * scale)``, then an f32 product."""
    E = fused_packed.shape[0]
    T = len(tile_bits)
    out = torch.empty((E, x.shape[1], T * tile_n), dtype=torch.float32, device=x.device)
    xp = _pad_cols(x.to(torch.float32), Kp)
    for sl in expert_chunks(E, T * tile_n * Kp):
        w = fused_3d_dense(fused_packed[sl], fused_scales[sl], tile_bits, Kp=Kp,
                           tile_n=tile_n, compute_dtype=compute_dtype)
        out[sl] = xp[sl] @ w.mT
    return out


# compute dtypes the expert kernel rounds its dequantized tiles to
FUSED_3D_COMPUTE = (torch.float32, torch.bfloat16)


# ---------------------------------------------------------------------------
# Path choice (pure functions of the shapes, read by the CPU tests)
# ---------------------------------------------------------------------------

def fused_2d_path(tile_n: int, compute_dtype) -> str:
    """The fused kernel's routine: ``"mma"`` (bf16 tensor cores) at bf16
    compute when a tile holds whole 16-channel fragments (``tile_n >=
    16``), else ``"simt"``."""
    return "mma" if compute_dtype == torch.bfloat16 and tile_n >= 16 else "simt"


def pergroup_path(K: int, compute_dtype) -> str:
    """The per-group kernel's routine for a packed depth ``K``: ``"mma"``
    at bf16 compute (at every K, so that a weight with the fused layout,
    ``K <= K_SINGLE_STEP_MAX``, sums as its fused tiles do), else
    ``"simt"``, the routine the fused kernel takes at f32."""
    return "mma" if compute_dtype == torch.bfloat16 else "simt"


def fused_3d_path(tile_n: int, compute_dtype) -> str:
    """The expert kernel's routine: ``"mma"`` at bf16 compute when a tile
    holds whole 16-channel fragments (``tile_n >= 16``), else ``"simt"``."""
    return fused_2d_path(tile_n, compute_dtype)


# (token fragments of 8 a warp, warps splitting K, warps splitting N)
MMA_DECODE_PLAN = (1, 4, 4)
MMA_TILE_PLAN = (8, 1, 8)


def mma_plan(M: int) -> tuple:
    """The tensor-core block shape for ``M`` rows.  At ``M <= 8`` (decode)
    one 8-token fragment a warp and K split over 4 warps of the same 64
    channels; above it 64-token tiles, so the weights stream once for a MoE
    expert's prefill capacity (M <= 64), 8 warps of 16 channels each
    walking all of K (64-token tiles measured 3-19% faster than 32-token
    ones at M 256-2048, with the same sums: neither splits K).  A function
    of M alone, never of the expert count or the grid: the K split fixes
    the order of the sums (the channel warps change none)."""
    return MMA_DECODE_PLAN if M <= 8 else MMA_TILE_PLAN


def fused_3d_mma_plan(M: int, tile_n: int) -> tuple:
    """:func:`mma_plan` with the channel warps cut so that a block's
    ``16 * wn`` channels lie inside one ``tile_n``-wide tile."""
    mf, wk, wn = mma_plan(M)
    return mf, wk, min(wn, tile_n // 16)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def quant_matmul_fused_2d(x: torch.Tensor, fused_packed: torch.Tensor,
                          fused_table_: torch.Tensor, fused_scales: torch.Tensor,
                          tile_bits: tuple, *, Kp: int, tile_n: int,
                          compute_dtype=torch.float32) -> torch.Tensor:
    """Single-launch mixed-precision GEMM over the ragged fused buffer.

    ``x (M, c)`` with ``c <= Kp`` (the missing columns count as zeros,
    which is the reference's padding of x to ``Kp``), already rounded to
    ``compute_dtype``, which picks the routine (:func:`fused_2d_path`): f32
    for the SIMT one, bf16 for the tensor-core one (an f32 x is cast
    first); ``fused_packed`` the 1-D uint8 buffer; ``fused_table_`` its
    ``(T, 2)`` int32 schedule (:func:`fused_table`, on the same device);
    ``fused_scales (T*tile_n,)``.  Returns ``(M, T * tile_n)`` f32 in tile
    walk order.
    """
    if x.device.type == "cpu":
        return quant_matmul_fused_2d_plain(x, fused_packed, fused_scales,
                                           tile_bits, Kp=Kp, tile_n=tile_n)
    T = len(tile_bits)
    M, c = x.shape
    if tile_n not in FUSED_TILE_NS:
        raise ValueError(f"tile_n {tile_n} not in {FUSED_TILE_NS}")
    if c > Kp or Kp % FUSED_K_ALIGN:
        raise ValueError(f"x width {c} does not fit Kp {Kp}")
    if fused_table_.shape != (T, 2) or fused_scales.shape != (T * tile_n,):
        raise ValueError("fused table/scales do not match the schedule")
    mma = fused_2d_path(tile_n, compute_dtype) == "mma"
    if mma and x.dtype == torch.float32:
        x = x.to(torch.bfloat16)
    _build.check_cuda("quant_matmul_fused_2d",
                dict(x=x, packed=fused_packed, table=fused_table_,
                     scales=fused_scales),
                dict(x=torch.bfloat16 if mma else torch.float32, packed=torch.uint8,
                     table=torch.int32, scales=torch.float32))
    out = torch.empty((M, T * tile_n), dtype=torch.float32, device=x.device)
    if M == 0:
        return out
    lib = _build.load("quant_matmul.cu")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if mma:
            rc = lib.qmm_fused_mma(
                x.data_ptr(), M, c, Kp, fused_packed.data_ptr(), 0, fused_table_.data_ptr(),
                fused_scales.data_ptr(), T, tile_n, 1, 0, *fused_3d_mma_plan(M, tile_n),
                out.data_ptr(), stream)
        else:
            rc = lib.qmm_fused_f32(
                x.data_ptr(), M, c, Kp, fused_packed.data_ptr(),
                fused_table_.data_ptr(), fused_scales.data_ptr(), T, tile_n,
                out.data_ptr(), stream)
    _build.raise_on(rc, "quant_matmul_fused_2d")
    quant_matmul_fused_2d.launches += 1
    quant_matmul_fused_2d.mma_launches += mma
    return out


quant_matmul_fused_2d.launches = 0
quant_matmul_fused_2d.mma_launches = 0


def quant_matmul_2d(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                    bits: int, compute_dtype=torch.float32) -> torch.Tensor:
    """One precision group: ``x (M, c) @ unpack(packed (N, K/f))^T * scale``
    -> ``(M, N)`` f32, with ``c <= K`` (missing columns count as zeros); x
    already rounded to ``compute_dtype``, which picks the routine
    (:func:`pergroup_path`).  The SIMT routine reads x as f32; the
    tensor-core one as bf16 (an f32 x is cast first, one more launch).

    With an expert axis (``packed (E, N, K/f)``, ``scale (E, N)``, ``x (E,
    M, c)``) every expert's product is one grid slice of ONE launch ->
    ``(E, M, N)``."""
    if x.device.type == "cpu":
        return quant_matmul_2d_plain(x, packed, scale, bits)
    experts = packed.ndim == 3
    E = packed.shape[0] if experts else 1
    if x.ndim != packed.ndim or (experts and x.shape[0] != E):
        raise ValueError(f"x {tuple(x.shape)} does not match packed {tuple(packed.shape)}")
    M, c = x.shape[-2:]
    N = packed.shape[-2]
    K = packed.shape[-1] * qz.pack_factor(bits)
    if c > K:
        raise ValueError(f"x width {c} exceeds packed K {K}")
    if scale.shape != packed.shape[:-1]:
        raise ValueError(f"scale {tuple(scale.shape)} does not match packed "
                         f"{tuple(packed.shape)}")
    mma = pergroup_path(K, compute_dtype) == "mma"
    if mma and x.dtype == torch.float32:
        x = x.to(torch.bfloat16)
    _build.check_cuda("quant_matmul_2d", dict(x=x, packed=packed, scale=scale),
                      dict(x=torch.bfloat16 if mma else torch.float32, packed=torch.uint8,
                           scale=torch.float32))
    out = torch.empty(x.shape[:-1] + (N,), dtype=torch.float32, device=x.device)
    if M == 0 or N == 0 or E == 0:
        return out
    lib = _build.load("quant_matmul.cu")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if mma:
            rc = lib.qmm_pergroup_mma(x.data_ptr(), M, c, K, packed.data_ptr(), N,
                                      scale.data_ptr(), bits, E, *mma_plan(M),
                                      out.data_ptr(), stream)
        else:
            rc = lib.qmm_pergroup_f32(x.data_ptr(), M, c, K, packed.data_ptr(), N,
                                      scale.data_ptr(), bits, E, out.data_ptr(), stream)
    _build.raise_on(rc, "quant_matmul_2d")
    quant_matmul_2d.launches += 1
    quant_matmul_2d.mma_launches += mma
    return out


quant_matmul_2d.launches = 0
quant_matmul_2d.mma_launches = 0


def quant_matmul_fused_3d(x: torch.Tensor, fused_packed: torch.Tensor,
                          fused_table_: torch.Tensor, fused_scales: torch.Tensor,
                          tile_bits: tuple, *, Kp: int, tile_n: int,
                          compute_dtype=torch.float32) -> torch.Tensor:
    """Expert-batched single-launch mixed-precision GEMM (dequant first).

    ``x (E, M, c)`` with ``c <= Kp`` (x already rounded to
    ``compute_dtype``; missing columns count as zeros): f32 for the SIMT
    routine, bf16 for the tensor-core one (:func:`fused_3d_path`; an f32 x
    is cast first); ``fused_packed (E, bytes)`` uint8, every expert's
    ragged buffer under the ONE schedule ``fused_table_ (T, 2)``;
    ``fused_scales (E, T * tile_n)``.  Each weight tile is ``round_cd(w_int
    * scale)`` before the product, f32 sums.  Returns ``(E, M, T * tile_n)``
    f32 in tile walk order.
    """
    if x.device.type == "cpu":
        return quant_matmul_fused_3d_plain(x, fused_packed, fused_scales, tile_bits,
                                           Kp=Kp, tile_n=tile_n, compute_dtype=compute_dtype)
    T = len(tile_bits)
    if x.ndim != 3 or fused_packed.ndim != 2 or x.shape[0] != fused_packed.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} and fused buffer {tuple(fused_packed.shape)} "
                         "need one leading expert axis")
    E, M, c = x.shape
    if tile_n not in FUSED_TILE_NS:
        raise ValueError(f"tile_n {tile_n} not in {FUSED_TILE_NS}")
    if c > Kp or Kp % FUSED_K_ALIGN:
        raise ValueError(f"x width {c} does not fit Kp {Kp}")
    if compute_dtype not in FUSED_3D_COMPUTE:
        raise TypeError(f"compute dtype {compute_dtype} not in {FUSED_3D_COMPUTE}")
    nbytes = fused_tile_offsets(tile_bits, Kp, tile_n)[-1] + fused_tile_bytes(
        tile_bits[-1], Kp, tile_n)
    if fused_packed.shape[1] != nbytes:
        raise ValueError(f"fused buffer of {fused_packed.shape[1]} bytes per expert, "
                         f"the schedule needs {nbytes}")
    if fused_table_.shape != (T, 2) or fused_scales.shape != (E, T * tile_n):
        raise ValueError("fused table/scales do not match the schedule")
    mma = fused_3d_path(tile_n, compute_dtype) == "mma"
    if mma and x.dtype == torch.float32:
        x = x.to(torch.bfloat16)
    _build.check_cuda("quant_matmul_fused_3d",
                      dict(x=x, packed=fused_packed, table=fused_table_, scales=fused_scales),
                      dict(x=torch.bfloat16 if mma else torch.float32, packed=torch.uint8,
                           table=torch.int32, scales=torch.float32))
    out = torch.empty((E, M, T * tile_n), dtype=torch.float32, device=x.device)
    if M == 0 or E == 0:
        return out
    lib = _build.load("quant_matmul.cu")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if mma:
            rc = lib.qmm_fused_mma(
                x.data_ptr(), M, c, Kp, fused_packed.data_ptr(), nbytes,
                fused_table_.data_ptr(), fused_scales.data_ptr(), T, tile_n, E, 1,
                *fused_3d_mma_plan(M, tile_n), out.data_ptr(), stream)
        else:
            rc = lib.qmm_fused_experts_f32(
                x.data_ptr(), M, c, Kp, fused_packed.data_ptr(), nbytes,
                fused_table_.data_ptr(), fused_scales.data_ptr(), T, tile_n, E,
                int(compute_dtype == torch.bfloat16), out.data_ptr(), stream)
    _build.raise_on(rc, "quant_matmul_fused_3d")
    quant_matmul_fused_3d.launches += 1
    quant_matmul_fused_3d.mma_launches += mma
    return out


quant_matmul_fused_3d.launches = 0
quant_matmul_fused_3d.mma_launches = 0
