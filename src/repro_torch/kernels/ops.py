"""Public wrappers around the packed GEMM kernels (leading batch dims, K
padding and the output channel order) and the launch counters of every
kernel wrapper of the port.

Counterpart of ``repro.kernels.ops`` (``quant_matmul``,
``quant_matmul_fused``, ``quant_matmul_fused_batched``).  ``compute_dtype`` rounds x before the product and
``out_dtype`` the result, as in the reference; the kernels themselves read
and write f32.  The reference pads M up to a tile multiple
(``_pick_bm``) and x up to ``Kp`` before its kernels; the CUDA kernels mask
ragged M and read missing K columns as zeros instead, so here nothing is
copied: the wrappers only flatten, launch and restore the channel order.

Launch counters: :func:`launch_counts` / :func:`reset_launch_counts` read
and clear the ``launches`` int of each kernel wrapper.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import quantizers as qz
from repro_torch.kernels import decode_attention as datt
from repro_torch.kernels import int8_matmul as imk
from repro_torch.kernels import quant_matmul as qmk

KERNEL_WRAPPERS = {
    "quant_matmul_fused": qmk.quant_matmul_fused_2d,
    "quant_matmul": qmk.quant_matmul_2d,
    "quant_matmul_fused_batched": qmk.quant_matmul_fused_3d,
    "scaled_int8_mm": imk.scaled_int8_mm,
    "decode_attention": datt.decode_attention,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


def _check_c_in(x: torch.Tensor, c_in: int) -> None:
    if x.shape[-1] != c_in:
        raise ValueError(
            f"x contraction dim {x.shape[-1]} != c_in {c_in} — for conv "
            "patches this means the im2col width does not match the packed "
            "kernel's C*kh*kw")


def _kernel_x(x: torch.Tensor, c_in: int, compute_dtype) -> torch.Tensor:
    """x flattened to ``(M, c_in)``, rounded to ``compute_dtype`` and held
    in f32, as the kernels read it: a bf16 x times an integer weight of at
    most 8 bits is exact in f32, so the kernels' f32 sums are the
    reference's bf16 dot with f32 accumulation."""
    return x.reshape(-1, c_in).to(compute_dtype).to(torch.float32).contiguous()


def check_experts(x: torch.Tensor, E: int) -> None:
    if x.ndim < 2 or x.shape[0] != E:
        raise ValueError(f"an expert-stacked weight (experts={E}) takes x of shape "
                         f"(E, ..., c_in); got {tuple(x.shape)}")


def quant_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                 bits: int, c_in: int, compute_dtype=torch.float32,
                 out_dtype=torch.float32) -> torch.Tensor:
    """``x (..., c_in) @ dequant(packed (n, K/f))^T -> (..., n)``, where
    ``K`` is ``c_in`` rounded up by less than ``FUSED_K_ALIGN``: x rounded
    to ``compute_dtype``, f32 sums scaled in f32, rounded to ``out_dtype``.

    An expert stack (``packed (E, n, K/f)``, ``scale (E, n)``) maps ``x (E,
    ..., c_in) -> (E, ..., n)`` in ONE launch over every expert."""
    _check_c_in(x, c_in)
    K = packed.shape[-1] * qz.pack_factor(bits)
    if not 0 <= K - c_in < qmk.FUSED_K_ALIGN:
        raise ValueError(f"packed K {K} does not correspond to c_in {c_in} "
                         f"at {bits} bits")
    n = packed.shape[-2]
    if packed.ndim == 3:
        E = packed.shape[0]
        check_experts(x, E)
        lead = x.shape[1:-1]
        x2 = _kernel_x(x, c_in, compute_dtype).reshape(E, -1, c_in)
        y = qmk.quant_matmul_2d(x2, packed, scale, bits)
        return y.to(out_dtype).reshape(E, *lead, n)
    lead = x.shape[:-1]
    y = qmk.quant_matmul_2d(_kernel_x(x, c_in, compute_dtype), packed, scale, bits)
    return y.to(out_dtype).reshape(*lead, n)


def quant_matmul_fused(x: torch.Tensor, fused_packed: torch.Tensor,
                       fused_table: torch.Tensor, fused_scales: torch.Tensor,
                       fused_perm: Optional[torch.Tensor], tile_bits: tuple,
                       tile_n: int, c_in: int, c_out: int,
                       compute_dtype=torch.float32,
                       out_dtype=torch.float32) -> torch.Tensor:
    """Whole multi-precision GEMM ``x (..., c_in) -> (..., c_out)`` in ONE
    kernel launch over the tile-aligned fused layout (x rounded to
    ``compute_dtype``, the result to ``out_dtype``).

    ``fused_perm`` is ``None`` when the deploy transform folded the
    channel-order restore into the tile walk order (only the tail padding
    is sliced off); otherwise it gathers the ``c_out`` real columns.
    """
    _check_c_in(x, c_in)
    Kp = -(-c_in // qmk.FUSED_K_ALIGN) * qmk.FUSED_K_ALIGN
    lead = x.shape[:-1]
    y = qmk.quant_matmul_fused_2d(
        _kernel_x(x, c_in, compute_dtype), fused_packed,
        fused_table, fused_scales, tile_bits, Kp=Kp, tile_n=tile_n)
    y = y.index_select(1, fused_perm) if fused_perm is not None else y[:, :c_out]
    return y.to(out_dtype).reshape(*lead, c_out)


def quant_matmul_fused_batched(x: torch.Tensor, fused_packed: torch.Tensor,
                               fused_table: torch.Tensor, fused_scales: torch.Tensor,
                               fused_perm: Optional[torch.Tensor], tile_bits: tuple,
                               tile_n: int, c_in: int, c_out: int,
                               compute_dtype=torch.float32,
                               out_dtype=torch.float32) -> torch.Tensor:
    """Expert-stacked fused GEMM ``x (E, ..., c_in) -> (E, ..., c_out)`` in
    ONE launch of the expert kernel: the packed form of
    ``einsum("ecd,efd->ecf", x, dense_stack)``.  Each weight tile is
    dequantized and rounded to ``compute_dtype`` before the product; the
    output channels are gathered by ``fused_perm`` as in
    :func:`quant_matmul_fused`."""
    E = fused_packed.shape[0]
    check_experts(x, E)
    _check_c_in(x, c_in)
    Kp = -(-c_in // qmk.FUSED_K_ALIGN) * qmk.FUSED_K_ALIGN
    lead = x.shape[1:-1]
    x2 = _kernel_x(x, c_in, compute_dtype).reshape(E, -1, c_in)
    y = qmk.quant_matmul_fused_3d(x2, fused_packed, fused_table, fused_scales, tile_bits,
                                  Kp=Kp, tile_n=tile_n, compute_dtype=compute_dtype)
    y = y.index_select(2, fused_perm) if fused_perm is not None else y[..., :c_out]
    return y.to(out_dtype).reshape(E, *lead, c_out)
