"""The fused Eq. 5 weight mixture: a hand-written CUDA kernel and its plain
PyTorch version.

Counterpart of ``repro.kernels.fake_quant``.  The search-phase forward
fake-quantizes every weight at |P_W| precisions and mixes them
(``core/mixedprec.effective_weight``); done op by op that reads ``w`` once
per precision and writes |P_W| temporaries besides the mixture.  The kernel
(``csrc/fake_quant.cu``) computes

    out[n, k] = sum_p gamma_hat[n, p] * FQ(w[n, k]; alpha[n], b_p)

in one pass: one read of ``w``, one write of ``out``.  It equals its plain
version, :func:`repro_torch.kernels.ref.fused_mix_ref`, bitwise (see the
note at the top of the source).

:func:`fused_mix_2d` launches the kernel when given CUDA tensors and runs
the plain version when given CPU tensors — never the other way round, and
never a fall-back after a failed build or launch.  It counts its launches in
a plain int attribute, ``launches``.  Unlike the reference's wrapper it pads
nothing: the 256 x 512 blocks there are a Pallas tiling rule, and the
output is the same without them.

Forward only, as in the reference: the mixture's gradient is the plain
expression's, so training differentiates ``mixedprec.effective_weight``.
Called with grad mode on and an input that requires grad, the wrapper
raises rather than return a result cut off from autograd.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

MIX_BITS = (2, 4, 8)             # bit-widths the kernel takes, 1 to 3 of them
W_DTYPES = (torch.float32, torch.bfloat16)


def _check(w: torch.Tensor, gamma_hat: torch.Tensor, alpha: torch.Tensor,
           bitwidths: tuple) -> None:
    if not 1 <= len(bitwidths) <= 3 or any(b not in MIX_BITS for b in bitwidths):
        raise ValueError(f"bitwidths {bitwidths}: 1 to 3 entries from {MIX_BITS}")
    if w.ndim != 2:
        raise ValueError(f"w must be (N, K); got {tuple(w.shape)}")
    N = w.shape[0]
    if gamma_hat.shape != (N, len(bitwidths)) or alpha.shape != (N,):
        raise ValueError(f"gamma_hat {tuple(gamma_hat.shape)} and alpha "
                         f"{tuple(alpha.shape)} do not match w {tuple(w.shape)} and "
                         f"{len(bitwidths)} bit-widths")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (w, gamma_hat, alpha)):
        raise RuntimeError("fused_mix is forward-only: differentiate "
                           "mixedprec.effective_weight, or call it under torch.no_grad()")


def fused_mix_2d(w: torch.Tensor, gamma_hat: torch.Tensor, alpha: torch.Tensor,
                 bitwidths=(2, 4, 8)) -> torch.Tensor:
    """``w (N, K)`` f32 or bf16, ``gamma_hat (N, |P|)`` f32, ``alpha (N,)``
    f32 -> the mixed weights ``(N, K)`` f32."""
    bitwidths = tuple(int(b) for b in bitwidths)
    _check(w, gamma_hat, alpha, bitwidths)
    if w.device.type == "cpu":
        return ref.fused_mix_ref(w, gamma_hat, alpha, bitwidths)
    if w.dtype not in W_DTYPES:
        raise TypeError(f"fused_mix_2d: w is {w.dtype}, expected one of {W_DTYPES}")
    _build.check_cuda("fused_mix_2d", dict(w=w, gamma_hat=gamma_hat, alpha=alpha),
                      dict(w=w.dtype, gamma_hat=torch.float32, alpha=torch.float32))
    N, K = w.shape
    out = torch.empty((N, K), dtype=torch.float32, device=w.device)
    if N == 0 or K == 0:
        return out
    lib = _build.load("fake_quant.cu")
    b = bitwidths + (0,) * (3 - len(bitwidths))
    with torch.cuda.device(w.device):
        rc = lib.fused_mix_f32(
            w.data_ptr(), int(w.dtype == torch.bfloat16), gamma_hat.data_ptr(),
            alpha.data_ptr(), N, K, len(bitwidths), *b, out.data_ptr(),
            torch.cuda.current_stream(w.device).cuda_stream)
    _build.raise_on(rc, "fused_mix_2d")
    fused_mix_2d.launches += 1
    return out


fused_mix_2d.launches = 0
