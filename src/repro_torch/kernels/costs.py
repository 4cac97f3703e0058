"""What each hand-written kernel must move and compute, and the hook that
charges a kernel API call by it.

The formulas are the ones ``chip_smoke.py`` bounds each kernel with: the
bytes a call must move (each input read once, each output written once)
and the operations it does, by arithmetic class.  :func:`k1_cost` ...
:func:`k6_cost` read them off a kernel API call's own arguments.

:func:`charged_as` decorates the kernel API functions (``kernels/ops.py``,
``kernels/decode_attention.py``, ``kernels/int8_matmul.py``).  Outside a
counter it calls the function; inside the innermost of :data:`ACTIVE` (a
``launch/costs.CostCounter``) it charges the call once by its formula and
runs it with the counter paused, so the ops inside are not counted again.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Optional

import torch

from repro_torch.kernels import quant_matmul as qmk


def flop_class(dtype) -> str:
    """The arithmetic class of a product of ``dtype`` operands."""
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    if dtype in (torch.int8, torch.uint8):
        return "int8"
    return "f32"


@dataclasses.dataclass(frozen=True)
class KernelCost:
    flops: float
    cls: str
    hbm_bytes: float
    mesh_bytes: float = 0.0


def gemm_flops(M, N, K) -> float:
    return 2.0 * M * N * K


def k1_bytes(M, c_in, c_out, packed, scales, table=0, x_bytes=4, y_bytes=4) -> float:
    """K1: x read once, the packed buffer, its scales (f32) and schedule
    (int32 entries) once, the ``(M, c_out)`` result written once (the tile
    padding's output columns are the kernel's cost, not the bound's)."""
    return x_bytes * M * c_in + packed + 4 * scales + 4 * table + y_bytes * M * c_out


def k2_bytes(M, K, N, packed, scales, x_bytes=4, y_bytes=4) -> float:
    """K2 (one group; M counts every expert's rows): x once, the group's
    packed bytes and f32 scales once, the ``(M, N)`` result once."""
    return x_bytes * M * K + packed + 4 * scales + y_bytes * M * N


def k3_bytes(E, M, Kp, N, packed, scales, table) -> float:
    """K3: x and y at 2 bytes (the reference's bf16 dot), every expert's
    packed bytes, scales and the schedule once."""
    return 2 * E * M * Kp + packed + 4 * scales + 4 * table + 2 * E * M * N


def k4_bytes(B, KV, rep, hd, NB, G, pos, S, q_bytes, out_bytes) -> float:
    """K4: the packed K and V entries <= pos with their scales, q once, the
    output once."""
    n = sum(min(int(p) + 1, S) for p in pos)
    return n * KV * 2 * (NB + 4 * G) + B * KV * rep * hd * (q_bytes + out_bytes)


def k4_flops(pos, S, KV, rep, hd) -> float:
    """K4: a dot and an accumulate (2 FLOPs each) per cached entry, head
    and feature."""
    return 4.0 * sum(min(int(p) + 1, S) for p in pos) * KV * rep * hd


def k5_bytes(M, N, K) -> float:
    """K5: both int8 operands, their f32 scales and the f32 result once."""
    return M * K + N * K + 4 * (M + N) + 4 * M * N


def k6_ops(n, k, nb) -> float:
    """K6's f32 operations: a clip (2) and, per bit-width, a division, a
    round, two products and a sum (5) an element; per row the floor and the
    |P| steps."""
    return n * k * (2 + 5 * nb) + n * (1 + nb)


def k6_bytes(n, k, nb, w_bytes=4) -> float:
    """K6: w read once, the f32 output written once, gamma_hat and alpha
    read once."""
    return n * k * (w_bytes + 4) + n * (nb + 1) * 4


def _rows(x, lead: int = 0) -> int:
    """Rows of ``x (..., c)`` past its first ``lead`` axes."""
    return math.prod(x.shape[lead:-1])


def k1_cost(x, fused_packed, fused_table, fused_scales, fused_perm, tile_bits, tile_n,
            c_in, c_out, compute_dtype=torch.float32, out_dtype=torch.float32) -> KernelCost:
    """``ops.quant_matmul_fused``: one K1 launch."""
    M = _rows(x)
    return KernelCost(gemm_flops(M, c_out, c_in), flop_class(compute_dtype),
                      k1_bytes(M, c_in, c_out, fused_packed.numel(), fused_scales.numel(),
                               fused_table.numel(), compute_dtype.itemsize,
                               out_dtype.itemsize))


def k2_cost(x, packed, scale, bits, c_in, compute_dtype=torch.float32,
            out_dtype=torch.float32) -> KernelCost:
    """``ops.quant_matmul``: one K2 launch (over every expert of a stack)."""
    M = _rows(x, 1) * packed.shape[0] if packed.ndim == 3 else _rows(x)
    N = packed.shape[-2]
    return KernelCost(gemm_flops(M, N, c_in), flop_class(compute_dtype),
                      k2_bytes(M, c_in, N, packed.numel(), scale.numel(), compute_dtype.itemsize,
                               out_dtype.itemsize))


def _kp(c_in: int) -> int:
    return -(-c_in // qmk.FUSED_K_ALIGN) * qmk.FUSED_K_ALIGN


def k3_cost(x, fused_packed, fused_table, fused_scales, fused_perm, tile_bits, tile_n,
            c_in, c_out, compute_dtype=torch.float32, out_dtype=torch.float32) -> KernelCost:
    """``ops.quant_matmul_fused_batched``: one K3 launch."""
    E, M, Kp = fused_packed.shape[0], _rows(x, 1), _kp(c_in)
    return KernelCost(gemm_flops(E * M, c_out, Kp), flop_class(compute_dtype),
                      k3_bytes(E, M, Kp, c_out, fused_packed.numel(), fused_scales.numel(),
                               fused_table.numel()))


def k1_tp_cost(x, shards, fused_perm, tile_bits, tile_n, c_in, c_out,
               compute_dtype=torch.float32, out_dtype=torch.float32) -> KernelCost:
    """``ops.quant_matmul_fused_tp``: a K1 launch a shard over its own
    tiles; x goes to every position but the first, each shard's f32 output
    comes back from it."""
    M, xb = _rows(x), compute_dtype.itemsize
    flops = nbytes = moved = 0.0
    for m, (packed, table, scales) in enumerate(shards):
        n = scales.numel()
        flops += gemm_flops(M, n, c_in)
        nbytes += k1_bytes(M, c_in, n, packed.numel(), n, table.numel(), xb, 4)
        moved += (xb * M * c_in + 4 * M * n) if m else 0
    return KernelCost(flops, flop_class(compute_dtype), nbytes, moved)


def k3_ep_cost(x, shards, fused_perm, tile_bits, tile_n, c_in, c_out,
               compute_dtype=torch.float32, out_dtype=torch.float32) -> KernelCost:
    """``ops.quant_matmul_fused_batched_ep``: a K3 launch a shard over its
    own experts; each shard's rows of x go to its position and its f32
    output comes back (every position but the first)."""
    M, Kp, xb = _rows(x, 1), _kp(c_in), compute_dtype.itemsize
    N = len(tile_bits) * tile_n
    flops = nbytes = moved = 0.0
    for m, (packed, table, scales) in enumerate(shards):
        e = packed.shape[0]
        flops += gemm_flops(e * M, c_out, Kp)
        nbytes += k3_bytes(e, M, Kp, c_out, packed.numel(), scales.numel(), table.numel())
        moved += (xb * e * M * c_in + 4 * e * M * N) if m else 0
    return KernelCost(flops, flop_class(compute_dtype), nbytes, moved)


def k4_cost(q, k_packed, k_scales, v_packed, v_scales, pos, bits, sizes,
            out_dtype=torch.bfloat16, plan_slots=None) -> KernelCost:
    """``decode_attention``: one K4 launch, charged for a full ring (every
    row at ``pos = S - 1``): the count reads no data, as the reference's
    count of a masked dense attention reads none."""
    B, KV, rep, hd = q.shape
    S, NB, G = k_packed.shape[2], k_packed.shape[3], k_scales.shape[3]
    full = [S - 1] * B
    return KernelCost(k4_flops(full, S, KV, rep, hd), "f32",
                      k4_bytes(B, KV, rep, hd, NB, G, full, S, q.element_size(),
                               out_dtype.itemsize))


def k5_cost(a, b, sa, sb, backend: str = "cuda") -> Optional[KernelCost]:
    """``scaled_int8_mm``: one K5 launch; ``backend="torch"`` is no kernel
    call (its plain version's ops are counted as they run)."""
    if backend != "cuda":
        return None
    M, K = a.shape
    N = b.shape[0]
    return KernelCost(gemm_flops(M, N, K), "int8", k5_bytes(M, N, K))


def k6_cost(w, gamma_hat, alpha, bitwidths=(2, 4, 8)) -> KernelCost:
    """``ops.fused_mix``: one K6 launch."""
    n, k = w.shape
    nb = len(tuple(bitwidths))
    return KernelCost(k6_ops(n, k, nb), "f32", k6_bytes(n, k, nb, w.element_size()))


# ---------------------------------------------------------------------------
# The hook
# ---------------------------------------------------------------------------

# The cost counters now counting, the innermost last (``launch/costs.py``
# pushes and pops them).
ACTIVE: list = []


def charged_as(name: str, formula: Callable) -> Callable:
    """Decorator of a kernel API function: inside an active counter each
    call is charged once, by ``formula(*args, **kwargs)`` (a
    :class:`KernelCost`; ``None``: not a kernel call), through the
    counter's ``kernel_call``, and the ops it runs are not counted again.
    Outside one it is the function itself, plus one check."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            c = ACTIVE[-1] if ACTIVE else None
            if c is None or c.paused:
                return fn(*args, **kwargs)
            cost = formula(*args, **kwargs)
            if cost is None:
                return fn(*args, **kwargs)
            return c.kernel_call(name, cost, fn, args, kwargs)
        return wrapper
    return deco
