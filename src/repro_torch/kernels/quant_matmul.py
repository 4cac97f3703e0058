"""Packed mixed-precision GEMMs: hand-written CUDA kernels and their plain
PyTorch versions.

Counterpart of ``repro.kernels.quant_matmul``.  One deployed weight is

    y[m, n] = scale[n] * sum_k x[m, k] * w_int[n, k]

with ``w_int`` stored packed (4x int2 / 2x int4 / 1x int8 per byte).

* :func:`quant_matmul_fused_2d` replaces the Pallas ``_fused_kernel``
  (2-D, ``dequant_first=False``): ONE launch over the ragged fused buffer
  whose ``tile_n``-wide output tiles each have one static bit-width.
* :func:`quant_matmul_2d` replaces the Pallas ``_kernel``: one precision
  group, packed ``(N, K/f)``, any K.

Both launch ``csrc/quant_matmul.cu`` (see the note at its top for what
bounds the kernels on the card and what the design does about it) when
given CUDA tensors, and run their plain version when given CPU tensors —
never the other way round, and never a fall-back after a failed launch.
Each wrapper counts its launches in a plain int attribute, ``launches``.

The CUDA kernels reduce every output's K terms in ascending order, in one
f32 FMA chain, with the same device code; so the fused kernel equals the
per-group kernel bitwise on the card.  The plain versions use
``torch.matmul`` and agree with the kernels to f32 rounding.
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


def quant_matmul_2d_plain(x: torch.Tensor, packed: torch.Tensor,
                          scale: torch.Tensor, bits: int) -> torch.Tensor:
    """``x (M, <=K) @ unpack(packed (N, K/f))^T * scale`` in f32, K summed in
    the reference kernel's ``pick_bk`` steps."""
    w = qz.unpack_int(packed, bits).to(torch.float32)             # (N, K)
    K = w.shape[1]
    x = _pad_cols(x.to(torch.float32), K)
    bk = pick_bk(K, qz.pack_factor(bits))
    acc = x[:, :bk] @ w[:, :bk].T
    for k0 in range(bk, K, bk):
        acc = acc + x[:, k0:k0 + bk] @ w[:, k0:k0 + bk].T
    return acc * scale.to(torch.float32)


def fused_dense_int(fused_packed: torch.Tensor, tile_bits, Kp: int,
                    tile_n: int) -> torch.Tensor:
    """Unpack the ragged fused buffer to ``(T * tile_n, Kp)`` int8, walk order."""
    rows = []
    for b, off in zip(tile_bits, fused_tile_offsets(tile_bits, Kp, tile_n)):
        seg = fused_packed[off: off + fused_tile_bytes(b, Kp, tile_n)]
        rows.append(qz.unpack_int(seg.reshape(tile_n, -1), b))
    return torch.cat(rows)


def quant_matmul_fused_2d_plain(x: torch.Tensor, fused_packed: torch.Tensor,
                                fused_scales: torch.Tensor, tile_bits, *,
                                Kp: int, tile_n: int) -> torch.Tensor:
    """``x (M, <=Kp)`` against the ragged fused buffer -> ``(M, T * tile_n)``."""
    w = fused_dense_int(fused_packed, tile_bits, Kp, tile_n).to(torch.float32)
    return (_pad_cols(x.to(torch.float32), Kp) @ w.T) * fused_scales


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def quant_matmul_fused_2d(x: torch.Tensor, fused_packed: torch.Tensor,
                          fused_table_: torch.Tensor, fused_scales: torch.Tensor,
                          tile_bits: tuple, *, Kp: int, tile_n: int) -> torch.Tensor:
    """Single-launch mixed-precision GEMM over the ragged fused buffer.

    ``x (M, c)`` f32 with ``c <= Kp`` (the missing columns count as zeros,
    which is the reference's padding of x to ``Kp``); ``fused_packed`` the
    1-D uint8 buffer; ``fused_table_`` its ``(T, 2)`` int32 schedule
    (:func:`fused_table`, on the same device); ``fused_scales (T*tile_n,)``.
    Returns ``(M, T * tile_n)`` f32 in tile walk order.
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
    _build.check_cuda("quant_matmul_fused_2d",
                dict(x=x, packed=fused_packed, table=fused_table_,
                     scales=fused_scales),
                dict(x=torch.float32, packed=torch.uint8, table=torch.int32,
                     scales=torch.float32))
    out = torch.empty((M, T * tile_n), dtype=torch.float32, device=x.device)
    if M == 0:
        return out
    lib = _build.load("quant_matmul.cu")
    with torch.cuda.device(x.device):
        rc = lib.qmm_fused_f32(
            x.data_ptr(), M, c, Kp, fused_packed.data_ptr(),
            fused_table_.data_ptr(), fused_scales.data_ptr(), T, tile_n,
            out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    _build.raise_on(rc, "quant_matmul_fused_2d")
    quant_matmul_fused_2d.launches += 1
    return out


quant_matmul_fused_2d.launches = 0


def quant_matmul_2d(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                    bits: int) -> torch.Tensor:
    """One precision group: ``x (M, c) @ unpack(packed (N, K/f))^T * scale``
    -> ``(M, N)`` f32, with ``c <= K`` (missing columns count as zeros)."""
    if x.device.type == "cpu":
        return quant_matmul_2d_plain(x, packed, scale, bits)
    M, c = x.shape
    N = packed.shape[0]
    K = packed.shape[1] * qz.pack_factor(bits)
    if c > K:
        raise ValueError(f"x width {c} exceeds packed K {K}")
    if scale.shape != (N,):
        raise ValueError(f"scale {tuple(scale.shape)} does not match N={N}")
    _build.check_cuda("quant_matmul_2d", dict(x=x, packed=packed, scale=scale),
                dict(x=torch.float32, packed=torch.uint8, scale=torch.float32))
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M == 0 or N == 0:
        return out
    lib = _build.load("quant_matmul.cu")
    with torch.cuda.device(x.device):
        rc = lib.qmm_pergroup_f32(
            x.data_ptr(), M, c, K, packed.data_ptr(), N, scale.data_ptr(),
            bits, out.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    _build.raise_on(rc, "quant_matmul_2d")
    quant_matmul_2d.launches += 1
    return out


quant_matmul_2d.launches = 0
