"""Plain PyTorch oracles of the kernel API (ground truth for the tests).

Counterpart of ``repro.kernels.ref``: straightforward, no tiling and no
padding.  :func:`fused_mix_ref` is the plain version of the Eq. 5 mixture
kernel (``kernels/fake_quant.py``): its CPU path and its oracle on the
card.  It is op for op the reference's eager ``fused_mix_ref`` (clip, an
IEEE division by the step, round half to even, a product, then a sum into
an accumulator that starts at zero, for p = 0, 1, 2 in turn), so the two
agree bitwise; the reference's jitted kernel multiplies by the step's
reciprocal instead and sits an ulp off on some elements.
"""
from __future__ import annotations

import torch

from repro_torch.core import quantizers as qz


def quant_matmul_ref(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor,
                     bits: int, c_in: int, out_dtype=torch.float32) -> torch.Tensor:
    """``x (..., c_in) @ (unpack(packed (n, K/f))[:, :c_in] * scale (n,)).T``
    in f32, rounded to ``out_dtype``: one precision group, dequantized."""
    w_int = qz.unpack_int(packed, bits)[..., :c_in]
    w = w_int.to(torch.float32) * scale[..., None].to(torch.float32)
    y = torch.einsum("...i,oi->...o", x.to(torch.float32), w)
    return y.to(out_dtype)


def fused_mix_ref(w: torch.Tensor, gamma_hat: torch.Tensor, alpha: torch.Tensor,
                  bitwidths=(2, 4, 8)) -> torch.Tensor:
    """Eq. (5) effective weight ``sum_p gamma_hat[:, p] * FQ(w, alpha, b_p)``.

    ``w (n, k)`` f32 or bf16 (widened to f32); ``gamma_hat (n, |P|)`` the
    softmaxed logits; ``alpha (n,)`` the clips (floored at 1e-6 by the
    quantizer).  Returns ``(n, k)`` f32."""
    wf = w.to(torch.float32)
    a = alpha.reshape(-1, 1)
    out = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
    for i, b in enumerate(bitwidths):
        out = out + gamma_hat[:, i:i + 1] * qz.quantize_weight(wf, a, b)
    return out
