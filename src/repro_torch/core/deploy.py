"""Deployment transform (Sec. III-C) producing :class:`QTensor`.

Counterpart of ``repro.core.deploy``.  For a searched layer:

1. **argmax** the NAS logits -> one bit-width per output channel;
2. **reorder** the filters, grouping channels by bit-width;
3. **propagate** the permutation to the next layer's ``c_in`` — or carry
   ``inv_perm`` and restore canonical order after the matmul;
4. **split** into |P_W| fixed-precision sub-layers whose outputs concatenate.

``align`` promotes the trailing ``size % align`` channels of each group to
the next-higher precision (upward only, so accuracy is never hurt).  The
grouping is offline and one-time, as in the paper.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.api.qtensor import QTensor
from repro_torch.core import mixedprec as mp
from repro_torch.core import quantizers as qz


def group_channels(bits_per_channel: np.ndarray,
                   bitwidths: Sequence[int] = qz.DEFAULT_BITWIDTHS,
                   align: int = 1) -> tuple[np.ndarray, dict]:
    """Reorder channels by bit-width; optionally pad groups to ``align``.

    Returns ``(perm, sizes)``: original channel indices in deployed order
    (ascending precision groups) and bit-width -> group size after the
    alignment promotion.  The highest group absorbs all leftovers.
    """
    bitwidths = sorted(bitwidths)
    bits_per_channel = np.asarray(bits_per_channel)
    unknown = set(np.unique(bits_per_channel)) - set(bitwidths)
    if unknown:
        raise ValueError(f"channels assigned unsupported bit-widths {unknown}")
    buckets = {b: list(np.nonzero(bits_per_channel == b)[0]) for b in bitwidths}
    for lo, hi in zip(bitwidths[:-1], bitwidths[1:]):
        rem = len(buckets[lo]) % align
        if rem:
            # promoted channels go first in the higher bucket, so the
            # original order inside each bucket is stable
            buckets[hi] = buckets[lo][-rem:] + buckets[hi]
            buckets[lo] = buckets[lo][:-rem]
    perm = np.concatenate([np.asarray(buckets[b], dtype=np.int64)
                           for b in bitwidths if buckets[b]] or
                          [np.arange(0, dtype=np.int64)])
    sizes = {b: len(buckets[b]) for b in bitwidths}
    return perm, sizes


def deploy_linear(w, gamma, alpha_w, delta: Optional[np.ndarray],
                  alpha_x: float, cfg: mp.MixedPrecConfig, align: int = 1,
                  restore_order: bool = True, tile_n=None) -> QTensor:
    """Full Sec. III-C transform of one searched map ``w`` -> ``QTensor``
    (on the CPU).  ``w`` is ``(c_out, ...)``; ``tile_n`` (int | ``"auto"`` |
    None) also builds the fused single-launch layout."""
    w = np.asarray(w, dtype=np.float32)
    c_out = w.shape[0]
    g = torch.as_tensor(np.asarray(gamma, np.float32))
    bits = mp.argmax_weight_bits(g.reshape(-1, g.shape[-1]), cfg).numpy()
    if bits.shape[0] == 1:
        bits = np.broadcast_to(bits, (c_out,)).copy()
    if delta is None:
        act_bits = cfg.fixed_act_bits
    else:
        act_bits = mp.argmax_act_bits(
            torch.as_tensor(np.asarray(delta, np.float32)), cfg)
    levels = (1 << act_bits) - 1
    return QTensor.from_assignment(
        w, bits, np.asarray(alpha_w, np.float32),
        bitwidths=cfg.weight_bits, align=align, restore_order=restore_order,
        act_bits=act_bits, act_scale=float(max(alpha_x, 1e-6)) / levels,
        tile_n=tile_n)


def propagate_perm(next_w: np.ndarray, perm: np.ndarray) -> np.ndarray:
    """Permute the next layer's input axis to match this layer's reordered
    outputs (paper Fig. 2, right)."""
    return np.asarray(next_w)[:, perm]


def dequantize_deployed(qt: QTensor) -> np.ndarray:
    """The deployed weight as float ``(c_out, c_in)`` numpy, canonical
    channel order whatever ``restore_order`` says (what a test holds against
    the frozen fake-quantized weight)."""
    return qt.dequantize_canonical().cpu().numpy()


def memory_bits(qt: QTensor) -> int:
    """Deployed model-size contribution in bits (the Pareto x-axis)."""
    return qt.memory_bits
