"""Quantizers: affine fake-quantization with straight-through gradients, and
sub-byte packing.

PyTorch counterpart of ``repro.core.quantizers``: the paper's Eq. (1) affine
scheme with the PACT clip, for activations (unsigned on ``[0, alpha]`` or
signed on ``[-alpha, alpha]``) and weights (symmetric signed, ``2^n - 1``
levels, zero exactly representable).

Gradients are the reference's: the round is straight-through
(``x + (round(x) - x).detach()``, whose forward value is also the
reference's, so both frameworks round the same f32 values), and the clip
passes its analytic gradient to ``x`` and to ``alpha``.  Every clip is a
``torch.maximum``/``torch.minimum`` against a tensor: at a tie (``x == 0``,
``x == ±alpha``, which :func:`init_weight_alpha` makes every channel's
largest weight) they split the gradient evenly between the two sides, as
``jnp.clip`` does; ``torch.clamp`` would pass it all to ``x``.

``torch.round`` and ``jnp.round`` both round half to even, and every step
is a division by ``step`` (never a multiplication by its reciprocal), as in
the reference; ``step`` itself is ``alpha`` divided by a device tensor of
the level count (:func:`_over`), because on the card PyTorch divides by a
Python number through its reciprocal.

Sub-byte packing is along the LAST axis: value ``j`` of byte ``b`` sits at
bit ``j * bits`` — the layout the CUDA kernels in ``kernels/csrc`` unpack.
"""
from __future__ import annotations

import torch

DEFAULT_BITWIDTHS: tuple[int, ...] = (2, 4, 8)

# CPU 0-dim bounds: they broadcast against a tensor on any device without a
# copy, and make the clips ties-splitting ``torch.maximum`` calls.
_ZERO = torch.zeros((), dtype=torch.float32)
_ALPHA_MIN = torch.tensor(1e-6, dtype=torch.float32)


def _round_ste(x: torch.Tensor) -> torch.Tensor:
    """``round(x)`` with a straight-through gradient."""
    return x + (torch.round(x) - x).detach()


def _over(alpha: torch.Tensor, levels: int) -> torch.Tensor:
    """``alpha / levels`` as an f32 division on every device (CUDA computes a
    tensor divided by a Python number as a product with its reciprocal)."""
    return alpha / torch.full_like(alpha, levels)


def over(t: torch.Tensor, value: float) -> torch.Tensor:
    """``t / value`` as an IEEE division on every device: the divisor is a
    0-dim tensor on ``t``'s device (CUDA divides by a Python number, or by a
    CPU scalar, as a product with its reciprocal)."""
    return t / torch.full((), value, dtype=t.dtype, device=t.device)


def quantize_act(x: torch.Tensor, alpha: torch.Tensor, bits: int) -> torch.Tensor:
    """PACT fake-quantization for activations (unsigned, ``[0, alpha]``)."""
    alpha = torch.maximum(torch.as_tensor(alpha, dtype=torch.float32,
                                          device=x.device), _ALPHA_MIN)
    levels = (1 << bits) - 1
    y = torch.minimum(torch.maximum(x, _ZERO), alpha)
    step = _over(alpha, levels)
    return _round_ste(y / step) * step


def quantize_act_signed(x: torch.Tensor, alpha: torch.Tensor,
                        bits: int) -> torch.Tensor:
    """Symmetric signed PACT for activations."""
    alpha = torch.maximum(torch.as_tensor(alpha, dtype=torch.float32,
                                          device=x.device), _ALPHA_MIN)
    half_levels = (1 << (bits - 1)) - 1
    y = torch.minimum(torch.maximum(x, -alpha), alpha)
    step = _over(alpha, half_levels)
    return _round_ste(y / step) * step


def quantize_act_any(x: torch.Tensor, alpha: torch.Tensor, bits: int,
                     signed: bool) -> torch.Tensor:
    return (quantize_act_signed if signed else quantize_act)(x, alpha, bits)


def quantize_weight(w: torch.Tensor, alpha: torch.Tensor, bits: int) -> torch.Tensor:
    """Symmetric signed PACT fake-quantization; ``alpha`` broadcasts against
    ``w`` (shape ``(c_out, 1, ...)`` for per-channel clipping)."""
    alpha = torch.maximum(alpha, _ALPHA_MIN)
    half_levels = (1 << (bits - 1)) - 1
    y = torch.minimum(torch.maximum(w, -alpha), alpha)
    step = _over(alpha, half_levels)
    return _round_ste(y / step) * step


def quantize_act_int(x: torch.Tensor, alpha: torch.Tensor, bits: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Unsigned integer activation quantization (deployment): ``(q uint8,
    step)`` with ``q`` in ``[0, 2^bits - 1]`` and ``x ≈ q * step``."""
    alpha = torch.clamp_min(torch.as_tensor(alpha, dtype=torch.float32, device=x.device), 1e-6)
    levels = (1 << bits) - 1
    step = _over(alpha, levels)
    return torch.clamp(torch.round(x / step), 0, levels).to(torch.uint8), step


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """``q * scale`` in f32, rounded to ``dtype``."""
    return (q.to(torch.float32) * scale.to(torch.float32)).to(dtype)


def act_bank(x: torch.Tensor, alpha: torch.Tensor,
             bitwidths=DEFAULT_BITWIDTHS) -> torch.Tensor:
    """The fake-quantized activations at every bit-width, ``(|P_X|,
    *x.shape)`` (the Eq. 4 bank, from the one float tensor)."""
    return torch.stack([quantize_act(x, alpha, b) for b in bitwidths])


def weight_bank(w: torch.Tensor, alpha: torch.Tensor,
                bitwidths=DEFAULT_BITWIDTHS) -> torch.Tensor:
    """The fake-quantized weights at every bit-width, ``(|P_W|,
    *w.shape)``."""
    return torch.stack([quantize_weight(w, alpha, b) for b in bitwidths])


def quantize_weight_int(w: torch.Tensor, alpha: torch.Tensor, bits: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """True integer quantization (deployment): ``(q int8, step)`` with
    ``q`` in ``[-half_levels, half_levels]`` and ``w ≈ q * step``."""
    alpha = torch.clamp_min(alpha, 1e-6)
    half_levels = (1 << (bits - 1)) - 1
    step = _over(alpha, half_levels)
    q = torch.clamp(torch.round(w / step), -half_levels, half_levels)
    return q.to(torch.int8), step


def pack_factor(bits: int) -> int:
    if bits not in (2, 4, 8):
        raise ValueError(f"bits must be 2, 4 or 8; got {bits}")
    return 8 // bits


def pack_int(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack signed integers (values fit in ``bits``) into uint8 along the
    last axis, two's complement within ``bits``."""
    if bits == 8:
        return q if q.dtype == torch.uint8 else q.to(torch.int8).view(torch.uint8)
    f = pack_factor(bits)
    if q.shape[-1] % f:
        raise ValueError(f"last axis {q.shape[-1]} is not a multiple of {f}")
    mask = (1 << bits) - 1
    u = (q.to(torch.int32) & mask).reshape(*q.shape[:-1], q.shape[-1] // f, f)
    out = torch.zeros(u.shape[:-1], dtype=torch.int32, device=q.device)
    for j in range(f):
        out |= u[..., j] << (j * bits)
    return out.to(torch.uint8)


def unpack_int(packed: torch.Tensor, bits: int, signed: bool = True) -> torch.Tensor:
    """Inverse of :func:`pack_int`; int8 values, last axis expanded."""
    if bits == 8:
        return packed.view(torch.int8) if signed else packed
    f = pack_factor(bits)
    mask = (1 << bits) - 1
    shifts = torch.arange(f, dtype=torch.int32, device=packed.device) * bits
    u = (packed.to(torch.int32)[..., None] >> shifts) & mask
    u = u.reshape(*packed.shape[:-1], packed.shape[-1] * f)
    if signed:
        u = torch.where(u >= (1 << (bits - 1)), u - (1 << bits), u)
    return u.to(torch.int8)


def init_act_alpha() -> torch.Tensor:
    """PACT activation clip prior (ReLU6-like)."""
    return torch.tensor(6.0, dtype=torch.float32)


def init_weight_alpha(w: torch.Tensor, per_channel: bool = True) -> torch.Tensor:
    """Weight clip = per-channel max-abs (axis 0 = output channel)."""
    if per_channel:
        a = torch.amax(torch.abs(w), dim=tuple(range(1, w.ndim)))
        return torch.clamp_min(a, 1e-3).to(torch.float32)
    return torch.clamp_min(torch.amax(torch.abs(w)), 1e-3).to(torch.float32)
