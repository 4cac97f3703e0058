"""Channel-wise sub-byte KV-cache quantization.

Counterpart of ``repro.models.kv_quant``: the feature axis of a cache leaf
(``head_dim`` for GQA K/V) splits into a few static contiguous channel
groups, each quantized symmetric at its own bit-width with ONE scale per
(token, group), and stored packed in uint8 (``core.quantizers.pack_int``:
4x int2 / 2x int4 per byte).  Decode bandwidth then scales with the
assigned bits exactly as weight bandwidth does for the deployed linears.

Contracts (the reference's):

* Packing is along the feature axis only; every token row is a whole
  number of bytes.
* At ``bits=8`` with a single group this is bit-identical to
  ``attention.quant_per_token`` and its int8 dequant: the same amax/127
  scale with the same 1e-6 floor, the same clip, and 8-bit "packing" is an
  int8 <-> uint8 view.
* All-zero rows quantize to zero codes, and zero codes dequantize to 0.0
  under any scale.

Every division is by a tensor on the operand's device (``qz.over``): on the
card a division by a Python number is a product with its reciprocal, which
can move a code across a rounding boundary.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import torch

from repro_torch.core import quantizers as qz

# Channel-count granularity of every group: the largest pack factor (int2 ->
# 4 values a byte), so group byte boundaries exist at every bit-width.
GROUP_ALIGN = 4


@dataclasses.dataclass(frozen=True)
class KVQuantSpec:
    """Static channel-group bit assignment of one cache feature axis:
    channels ``[sum(sizes[:g]), sum(sizes[:g+1]))`` at ``bits[g]``, one
    shared scale per token per group."""
    bits: tuple
    sizes: tuple

    def __post_init__(self):
        if not self.bits or len(self.bits) != len(self.sizes):
            raise ValueError(f"bits {self.bits} / sizes {self.sizes} must be "
                             "non-empty and the same length")
        for b, n in zip(self.bits, self.sizes):
            if b not in (2, 4, 8):
                raise ValueError(f"unsupported cache bit-width {b} "
                                 "(alphabet: 2, 4, 8)")
            if n < 1 or n % qz.pack_factor(b):
                raise ValueError(
                    f"group size {n} not a positive multiple of the {b}-bit "
                    f"pack factor {qz.pack_factor(b)}")

    @property
    def feat(self) -> int:
        """Channels covered (the unpacked feature-axis width)."""
        return sum(self.sizes)

    @property
    def n_groups(self) -> int:
        return len(self.bits)

    @property
    def packed_bytes(self) -> int:
        """Bytes per token row: what the cache leaf stores."""
        return sum(n // qz.pack_factor(b) for b, n in zip(self.bits, self.sizes))


def spec_for(kv_bits: Union[int, Sequence[int], None],
             feat: int) -> Optional[KVQuantSpec]:
    """Resolve the engine's ``kv_bits`` policy for one feature axis.

    ``None``: no spec (the int8-per-token cache); an int: ONE group over all
    ``feat`` channels (at 8 it reproduces ``quant_per_token`` bit for bit);
    a sequence: ``len(kv_bits)`` contiguous groups splitting ``feat`` as
    evenly as :data:`GROUP_ALIGN` allows, the last absorbing the rest.
    """
    if kv_bits is None:
        return None
    for b in ((kv_bits,) if isinstance(kv_bits, int) else kv_bits):
        if b not in (2, 4, 8):
            raise ValueError(f"kv_bits widths must be in (2, 4, 8), "
                             f"got {b} (kv_bits={kv_bits})")
    if isinstance(kv_bits, int):
        if feat % qz.pack_factor(kv_bits):
            raise ValueError(
                f"feature axis {feat} not divisible by the {kv_bits}-bit "
                f"pack factor {qz.pack_factor(kv_bits)}")
        return KVQuantSpec((kv_bits,), (feat,))
    bits = tuple(int(b) for b in kv_bits)
    n = len(bits)
    base = max((feat // n) // GROUP_ALIGN * GROUP_ALIGN, GROUP_ALIGN)
    if base * (n - 1) >= feat:
        raise ValueError(
            f"feature axis {feat} too narrow to split into {n} groups of "
            f">= {GROUP_ALIGN} channels (kv_bits={bits})")
    sizes = (base,) * (n - 1) + (feat - base * (n - 1),)
    return KVQuantSpec(bits, sizes)


def quant_symmetric(g: torch.Tensor, bits: int) -> tuple:
    """``g (..., n) -> (codes int8 (..., n), scale f32 (..., 1))``: one
    symmetric scale ``max(amax, 1e-6) / (2^(bits-1) - 1)`` per row, codes
    ``round(g / scale)`` clipped to the level range."""
    half = float((1 << (bits - 1)) - 1)
    amax = torch.amax(torch.abs(g), dim=-1, keepdim=True).to(torch.float32)
    scale = qz.over(torch.clamp_min(amax, 1e-6), half)
    q = torch.clamp(torch.round(g.to(torch.float32) / scale), -half, half)
    return q.to(torch.int8), scale


def quant_channelwise(t: torch.Tensor, spec: KVQuantSpec) -> tuple:
    """Quantize and pack a cache write along its feature axis:
    ``t (..., feat) -> (packed uint8 (..., packed_bytes), scales f32
    (..., n_groups))``, ``t[..., group g] ~ unpack(packed)[..., g] * scales[..., g]``."""
    if t.shape[-1] != spec.feat:
        raise ValueError(f"feature axis {t.shape[-1]} != spec width {spec.feat}")
    packs, scales = [], []
    lo = 0
    for b, n in zip(spec.bits, spec.sizes):
        q, scale = quant_symmetric(t[..., lo:lo + n], b)
        lo += n
        packs.append(qz.pack_int(q, b))
        scales.append(scale)
    packed = packs[0] if len(packs) == 1 else torch.cat(packs, dim=-1)
    sc = scales[0] if len(scales) == 1 else torch.cat(scales, dim=-1)
    return packed, sc


def dequant_channelwise(packed: torch.Tensor, scales: torch.Tensor,
                        spec: KVQuantSpec, dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`quant_channelwise`: ``(..., packed_bytes)`` uint8
    and ``(..., n_groups)`` f32 -> ``(..., feat)`` in ``dtype``, each value
    ``f32(code) * scale`` rounded once to ``dtype``."""
    if packed.shape[-1] != spec.packed_bytes:
        raise ValueError(f"packed width {packed.shape[-1]} != {spec.packed_bytes}")
    outs, lo = [], 0
    for g, (b, n) in enumerate(zip(spec.bits, spec.sizes)):
        nb = n // qz.pack_factor(b)
        q = qz.unpack_int(packed[..., lo:lo + nb], b)
        lo += nb
        outs.append((q.to(torch.float32) * scales[..., g:g + 1]).to(dtype))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)
