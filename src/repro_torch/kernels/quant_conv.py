"""im2col patch extraction for the packed conv path (NHWC).

Counterpart of ``repro.kernels.quant_conv``.  The patch feature axis is
channel-major — feature ``c * kh * kw + i * kw + j`` is input channel ``c``
at tap ``(i, j)`` — which is how a ``(c_out, c_in, kh, kw)`` weight flattens
to the ``(c_out, c_in * kh * kw)`` matrix a ``QTensor`` packs, and what
``lax.conv_general_dilated_patches`` emits in the reference.

``SAME`` padding follows lax: ``Ho = ceil(H / s)`` and the total padding
``max((Ho - 1) * s + kh - H, 0)`` is split low = total // 2, high = the
rest.  For stride 2 that is asymmetric, which ``F.unfold``'s symmetric
padding cannot express, so the input is padded explicitly first.
"""
from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn.functional as F


def _norm_stride(stride: Union[int, Sequence[int]]) -> tuple:
    return (stride, stride) if isinstance(stride, int) else tuple(stride)


def same_pads(size: int, k: int, s: int) -> tuple:
    """``(low, high)`` padding of one spatial axis under lax's ``SAME``."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def pad_nhwc(x: torch.Tensor, kh: int, kw: int, stride,
             padding: str) -> torch.Tensor:
    """Zero-pad NHWC ``x`` as lax pads it for ``padding`` ('SAME'/'VALID')."""
    sh, sw = _norm_stride(stride)
    if padding == "VALID":
        return x
    if padding != "SAME":
        raise ValueError(f"padding must be 'SAME' or 'VALID'; got {padding!r}")
    (ht, hb), (wl, wr) = same_pads(x.shape[1], kh, sh), same_pads(x.shape[2], kw, sw)
    return F.pad(x, (0, 0, wl, wr, ht, hb))


def im2col(x: torch.Tensor, kh: int, kw: int, stride=1,
           padding: str = "SAME") -> torch.Tensor:
    """NHWC ``x (N, H, W, C)`` -> patches ``(N, Ho, Wo, C * kh * kw)``."""
    sh, sw = _norm_stride(stride)
    p = pad_nhwc(x, kh, kw, stride, padding)
    p = p.unfold(1, kh, sh).unfold(2, kw, sw)        # (N, Ho, Wo, C, kh, kw)
    return p.reshape(*p.shape[:3], -1)


def depthwise_patches(x: torch.Tensor, kh: int, kw: int, stride=1,
                      padding: str = "SAME") -> torch.Tensor:
    """NHWC ``x (N, H, W, C)`` -> ``(N, Ho, Wo, C, kh * kw)``: the per-channel
    patch view of a depthwise conv."""
    p = im2col(x, kh, kw, stride, padding)
    return p.reshape(*p.shape[:-1], x.shape[-1], kh * kw)
