"""``int8_linear`` — a linear map whose three matmuls each run on dynamic
int8 compute, as a ``torch.autograd.Function``.

PyTorch counterpart of ``repro.qtrain.linear``.  For ``y = x @ w^T`` with
``x (..., K)`` and ``w (N, K)`` the backward pass needs two more products:

    dx = dy @ w          (contract N)     — "grad_input"
    dw = dy^T @ x        (contract M)     — "grad_weight"

:class:`QTrainConfig` switches each of the three to int8 (both operands
quantized per row of the contraction axis, int8 x int8 -> int32, fused
dequant: ``kernels/int8_matmul.py``); a leg that is off runs the plain f32
product.  The output is f32.

The forward rounds to nearest.  The backward quantizations round
stochastically when a ``seed`` (a Python int) is given: each of the four
(dy and w for grad-input, dy and x for grad-weight) draws from its own
generator, seeded with ``fold_in(seed, leg)``, so their noises are
independent and the same for the same seed; ``seed=None`` rounds every leg
to nearest.  The transposed operands are made contiguous before they are
quantized: the kernel reads raw rows.  A gradient autograd does not need
(``ctx.needs_input_grad``) is not computed.

Across a data group of processes (``dist/collectives.data_group``: one
process a ``data`` row, each holding as many of the batch's tokens) the
forward and the grad-input product stay per token, the process's own rows,
the grad-input's ``dy`` rounding with its rows of the whole batch's
noise.  The grad-weight product contracts over every token of the batch, and each row
of its operands ``dy^T`` and ``x^T`` is scaled by its max over all of them
(:func:`dp_grad_weight`): the processes all-reduce the max of their
blocks' rows, quantize their blocks with those scales, taking their
columns of the whole batch's stochastic-rounding noise, compute their
int32 partial sums on the kernel (``scaled_int8_mm``'s int32 form) and
all-reduce them.  Integer sums are exact, so the sums, and the epilogue
applied once (``int8_matmul.dequantize_sums``, the kernel's), are the whole
batch's product bit for bit.  The product enters the step's gradient once:
the first process keeps it and the others pass zeros, so the step's sum
over processes adds ``dw + 0``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.dist import collectives as coll
from repro_torch.kernels import int8_matmul as im

_MASK64 = (1 << 64) - 1


def fold_in(key: int, data: int) -> int:
    """A new 64-bit seed from ``key`` and ``data`` (splitmix64's finalizer
    over their combination): the port's ``jax.random.fold_in``, on the host,
    so deriving a seed never reads the device."""
    z = (key * 0x9E3779B97F4A7C15 + data + 0x632BE59BD9B4E019) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


@dataclasses.dataclass(frozen=True)
class QTrainConfig:
    """Which of the linear's three matmuls run on int8 compute."""
    forward: bool = True
    grad_input: bool = True
    grad_weight: bool = True
    stochastic_rounding: bool = True
    backend: str = "cuda"            # cuda | torch (bitwise-identical)


DEFAULT = QTrainConfig()


def _flat(x: torch.Tensor) -> torch.Tensor:
    """(..., K) -> (M, K) f32."""
    return x.reshape(-1, x.shape[-1]).to(torch.float32)


def _int8_mm(a: torch.Tensor, b: torch.Tensor, seed_a, seed_b,
             backend: str, a_block: Optional[tuple] = None) -> torch.Tensor:
    """``a (M, K) @ b (N, K)^T`` through per-row int8 of both operands;
    ``a_block``: ``a``'s place in a larger operand, whose noise it takes
    (``int8_matmul.rowwise_quantize``'s ``block``)."""
    qa, sa = im.rowwise_quantize(a.contiguous(), seed_a, block=a_block)
    qb, sb = im.rowwise_quantize(b.contiguous(), seed_b)
    return im.scaled_int8_mm(qa, qb, sa, sb, backend=backend)


def dp_grad_weight(dy2: torch.Tensor, x2: torch.Tensor, seed_dy, seed_x, backend: str,
                   group: coll.Group) -> torch.Tensor:
    """``dy2 (T_r, N)^T @ x2 (T_r, K)`` over every process's tokens, the
    process's ``T_r`` tokens the block at ``rank * T_r`` of the batch's
    ``size * T_r`` (each process holds as many): bit for bit the
    grad-weight product of the whole batch in one process, on the first
    process, zeros ``(N, K)`` on the others."""
    a, b = dy2.T.contiguous(), x2.T.contiguous()          # (N, T_r), (K, T_r)
    T_r, N = a.shape[1], a.shape[0]
    total = T_r * group.size
    if total > im.K_INT32_EXACT_MAX:
        raise ValueError(f"{total} tokens overflow the grad-weight product's exact int32 "
                         f"sums (max {im.K_INT32_EXACT_MAX})")
    amax = torch.cat([torch.amax(torch.abs(a), dim=-1), torch.amax(torch.abs(b), dim=-1)])
    group.all_reduce_(amax, "max")
    at = (0, group.rank * T_r)
    qa, sa = im.rowwise_quantize(a, seed_dy, amax=amax[:N], block=((N, total), at))
    qb, sb = im.rowwise_quantize(b, seed_x, amax=amax[N:], block=((b.shape[0], total), at))
    acc = group.all_reduce_(im.scaled_int8_mm(qa, qb, backend=backend), "sum")
    if group.rank:
        return torch.zeros(acc.shape, dtype=torch.float32, device=acc.device)
    return im.dequantize_sums(acc, sa, sb)


class _Int8Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, seed, cfg):
        ctx.save_for_backward(x, w)
        ctx.seed, ctx.cfg, ctx.group = seed, cfg, coll.active()
        x2, w32 = _flat(x), w.to(torch.float32)
        if cfg.forward:
            y = _int8_mm(x2, w32, None, None, cfg.backend)
        else:
            y = x2 @ w32.T
        return y.reshape(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        cfg = ctx.cfg
        x2, dy2, w32 = _flat(x), _flat(dy), w.to(torch.float32)
        if ctx.seed is None or not cfg.stochastic_rounding:
            seeds = (None,) * 4
        else:
            seeds = tuple(fold_in(ctx.seed, i) for i in range(4))
        dx = dw = None
        if ctx.needs_input_grad[0]:          # dx = dy (M, N) @ w (N, K)
            if cfg.grad_input:
                g, rows = ctx.group, None
                if g is not None:
                    rows = ((dy2.shape[0] * g.size, dy2.shape[1]), (g.rank * dy2.shape[0], 0))
                dx2 = _int8_mm(dy2, w32.T, seeds[0], seeds[1], cfg.backend, a_block=rows)
            else:
                dx2 = dy2 @ w32
            dx = dx2.reshape(x.shape).to(x.dtype)
        if ctx.needs_input_grad[1]:          # dw = dy^T (N, M) @ x (M, K)
            if cfg.grad_weight and ctx.group is not None:
                dw = dp_grad_weight(dy2, x2, seeds[2], seeds[3], cfg.backend, ctx.group)
            elif cfg.grad_weight:
                dw = _int8_mm(dy2.T, x2.T, seeds[2], seeds[3], cfg.backend)
            else:
                dw = dy2.T @ x2
            dw = dw.to(w.dtype)
        return dx, dw, None, None


def int8_linear(x: torch.Tensor, w: torch.Tensor, seed: Optional[int] = None,
                cfg: QTrainConfig = DEFAULT) -> torch.Tensor:
    """``x (..., K) @ w (N, K)^T -> (..., N)`` f32 on int8 training compute;
    ``seed`` seeds the backward stochastic rounding."""
    return _Int8Linear.apply(x, w, seed, cfg)
