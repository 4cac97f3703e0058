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
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

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
             backend: str) -> torch.Tensor:
    """``a (M, K) @ b (N, K)^T`` through per-row int8 of both operands."""
    qa, sa = im.rowwise_quantize(a.contiguous(), seed_a)
    qb, sb = im.rowwise_quantize(b.contiguous(), seed_b)
    return im.scaled_int8_mm(qa, qb, sa, sb, backend=backend)


class _Int8Linear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, seed, cfg):
        ctx.save_for_backward(x, w)
        ctx.seed, ctx.cfg = seed, cfg
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
                dx2 = _int8_mm(dy2, w32.T, seeds[0], seeds[1], cfg.backend)
            else:
                dx2 = dy2 @ w32
            dx = dx2.reshape(x.shape).to(x.dtype)
        if ctx.needs_input_grad[1]:          # dw = dy^T (N, M) @ x (M, K)
            if cfg.grad_weight:
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
