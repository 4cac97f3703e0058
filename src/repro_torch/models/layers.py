"""Quantization-aware layer primitives (PyTorch, NHWC).

Counterpart of ``repro.models.layers`` for the MLPerf-Tiny models.  Every
weight the paper searches goes through :func:`qlinear` / :func:`qconv2d`,
which dispatch on a :class:`PrecisionPolicy` and on the weight leaf's type:

  PrecisionPolicy.FLOAT          — no quantization
  PrecisionPolicy.QAT8           — fixed 8-bit PACT fake-quant (warmup)
  PrecisionPolicy.search(tau)    — the DNAS mixture of Eq. 4-6 (search)
  PrecisionPolicy.FROZEN         — argmax assignment (fine-tuning phase)
  PrecisionPolicy.deployed(bk)   — the weight leaf is a :class:`QTensor`;
                                   ``bk="cuda"`` serves it as ONE fused
                                   kernel launch, ``"cuda-pergroup"`` as
                                   one launch per precision group,
                                   ``"torch"`` through the dense fall-back

``policy.train_compute`` picks the arithmetic of a training phase's product
after the fake quantization: ``"f32"``, ``"bf16"`` (bf16 operands, f32 sums)
or ``"int8"`` (:func:`repro_torch.qtrain.int8_linear`: forward and both
backward products through the int8 kernel, the backward rounding
stochastically when ``policy.sr_key`` is set).

A site's NAS state is ``{"gamma", "delta"}``; the PACT clips live in the
params (``{"aw", "ax"}``).  Weights are stored ``(c_out, c_in[, kh, kw])``;
activations are NHWC, as in the reference.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.api.policy import Phase, PrecisionPolicy
from repro_torch.api.qtensor import QTensor
from repro_torch.core import mixedprec as mp
from repro_torch.core import quantizers as qz
from repro_torch.kernels import quant_conv as qc
from repro_torch.qtrain import linear as qt_linear


# ---------------------------------------------------------------------------
# Initializers (weights from a torch.Generator; the reference's jax.random
# numbers cannot be reproduced, so parity tests bridge the weights instead)
# ---------------------------------------------------------------------------

def linear_init(gen: torch.Generator, c_in: int, c_out: int,
                bias: bool = False) -> dict:
    w = torch.randn((c_out, c_in), generator=gen, dtype=torch.float32)
    w = w * (1.0 / math.sqrt(c_in))
    p = {"w": w, "aw": qz.init_weight_alpha(w), "ax": qz.init_act_alpha()}
    if bias:
        p["b"] = torch.zeros((c_out,), dtype=torch.float32)
    return p


def conv2d_init(gen: torch.Generator, c_in: int, c_out: int, kh: int, kw: int,
                bias: bool = True, groups: int = 1) -> dict:
    fan_in = c_in // groups * kh * kw
    w = torch.randn((c_out, c_in // groups, kh, kw), generator=gen,
                    dtype=torch.float32) / math.sqrt(fan_in)
    p = {"w": w, "aw": qz.init_weight_alpha(w), "ax": qz.init_act_alpha()}
    if bias:
        p["b"] = torch.zeros((c_out,), dtype=torch.float32)
    return p


def nas_init(c_out: int, qcfg: mp.MixedPrecConfig) -> dict:
    return mp.init_nas_params(c_out, qcfg)


# ---------------------------------------------------------------------------
# Quantization-aware apply
# ---------------------------------------------------------------------------

def _quant_pair(x, w, p, nas, policy: PrecisionPolicy,
                qcfg: mp.MixedPrecConfig, signed_act: bool):
    """(x', w') after the policy's fake quantization."""
    if policy.phase is Phase.FLOAT:
        return x, w
    if policy.phase is Phase.QAT8:
        aw = p["aw"].reshape((w.shape[0],) + (1,) * (w.ndim - 1))
        return (qz.quantize_act_any(x, p["ax"], 8, signed_act),
                qz.quantize_weight(w, aw, 8))
    if policy.phase is Phase.SEARCH:
        return (mp.effective_act(x, nas["delta"], p["ax"], policy.tau, qcfg,
                                 signed_act),
                mp.effective_weight(w, nas["gamma"], p["aw"], policy.tau, qcfg))
    if policy.phase is Phase.FROZEN:
        return (mp.frozen_act(x, nas["delta"], p["ax"], qcfg, signed_act),
                mp.frozen_weight(w, nas["gamma"], p["aw"], qcfg))
    raise ValueError(f"unhandled policy {policy!r}")


def _site_key(policy: PrecisionPolicy, w: torch.Tensor) -> Optional[int]:
    """Per-site stochastic-rounding seed: the policy's seed folded with the
    reference's salt from the weight's shape, so same-step sites of other
    shapes draw independent noise."""
    if policy.sr_key is None:
        return None
    salt = (w.shape[0] * 1000003 + w.shape[-1]) & 0x7FFFFFFF
    return qt_linear.fold_in(policy.sr_key, salt)


def deployed_act(x: torch.Tensor, qt: QTensor, signed: bool) -> torch.Tensor:
    """Layer-wise activation quantization of the deployed path.

    ``qt.act_scale`` is the unsigned step ``alpha_x / (2^b - 1)``; the clip
    ``qt.act_alpha`` is ``act_scale * levels`` in Python float64, cast to
    f32 once at deploy, and the quantizer divides it by ``levels`` in f32 —
    the reference's exact sequence, so the deployed activations equal
    ``frozen_act``'s.
    """
    return qz.quantize_act_any(x, qt.act_alpha, qt.act_bits, signed)


def qlinear(x: torch.Tensor, p: dict, nas: Optional[dict],
            policy: PrecisionPolicy, qcfg: mp.MixedPrecConfig,
            signed_act: bool = True) -> torch.Tensor:
    """Quantization-aware linear: ``x (..., c_in) @ w (c_out, c_in)^T``."""
    w = p["w"]
    if isinstance(w, QTensor):
        y = w.matmul(deployed_act(x, w, signed_act), policy.backend)
    elif policy.phase is Phase.DEPLOYED:
        raise TypeError("DEPLOYED policy requires a QTensor weight leaf "
                        "(run Engine.deploy / core.deploy.deploy_linear)")
    else:
        x, w = _quant_pair(x, w, p, nas, policy, qcfg, signed_act)
        if policy.train_compute == "int8":
            y = qt_linear.int8_linear(x, w, _site_key(policy, w), qt_linear.DEFAULT)
        elif policy.train_compute == "bf16":
            y = _bf16(x) @ _bf16(w).T
        else:
            y = x @ w.T
    if "b" in p:
        y = y + p["b"]
    return y


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 and held in f32: a product of two such values
    is exact in f32, so an f32 matmul of them is the bf16-operand,
    f32-accumulation product (``preferred_element_type=f32``)."""
    return t.to(torch.bfloat16).to(torch.float32)


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                padding: str = "SAME", groups: int = 1) -> torch.Tensor:
    """Dense NHWC conv with ``(c_out, c_in/g, kh, kw)`` weights and lax's
    padding (asymmetric ``SAME`` at stride 2)."""
    kh, kw = w.shape[2:]
    xp = qc.pad_nhwc(x, kh, kw, stride, padding).permute(0, 3, 1, 2)
    y = F.conv2d(xp, w, stride=stride, groups=groups)
    return y.permute(0, 2, 3, 1)


def qconv2d(x: torch.Tensor, p: dict, nas: Optional[dict],
            policy: PrecisionPolicy, qcfg: mp.MixedPrecConfig,
            stride: int = 1, padding: str = "SAME",
            groups: int = 1, signed_act: bool = False) -> torch.Tensor:
    """Quantization-aware NHWC conv.  A :class:`QTensor` weight runs fully
    packed (``QTensor.conv2d``: im2col patch-GEMM, or the depthwise
    fall-back); a float weight is fake-quantized per the policy."""
    w = p["w"]
    if isinstance(w, QTensor):
        y = w.conv2d(deployed_act(x, w, signed_act), stride=stride,
                     padding=padding, groups=groups, backend=policy.backend)
    elif policy.phase is Phase.DEPLOYED:
        raise TypeError("DEPLOYED policy requires a QTensor weight leaf")
    else:
        x, w = _quant_pair(x, w, p, nas, policy, qcfg, signed_act)
        if policy.train_compute == "int8" and groups == 1:
            # im2col (differentiable: pad + unfold) and the int8 patch-GEMM,
            # the deployed path's channel-major lowering; a depthwise conv
            # contracts kh*kw <= 9 values and stays on the float path
            patches = qc.im2col(x, w.shape[2], w.shape[3], stride, padding)
            y = qt_linear.int8_linear(patches, w.reshape(w.shape[0], -1),
                                      _site_key(policy, w), qt_linear.DEFAULT)
        elif policy.train_compute == "bf16":
            y = conv2d_nhwc(x.to(torch.bfloat16), w.to(torch.bfloat16), stride,
                            padding, groups).to(torch.float32)
        else:
            y = conv2d_nhwc(x, w, stride, padding, groups)
    if "b" in p:
        y = y + p["b"]
    return y


# ---------------------------------------------------------------------------
# Norms, activations and positional encodings of the language models (float:
# the paper leaves normalization and elementwise ops unquantized)
# ---------------------------------------------------------------------------

def norm_init(d: int, kind: str = "rmsnorm", dtype=torch.float32,
              device=None) -> dict:
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


def rmsnorm(x: torch.Tensor, p: dict, eps: float = 1e-5) -> torch.Tensor:
    """In f32, cast back to ``x``'s dtype; the mean is a sum divided by the
    width, as the reference's ``jnp.mean``."""
    x32 = x.to(torch.float32)
    var = qz.over(torch.sum(x32 * x32, dim=-1, keepdim=True), x.shape[-1])
    out = x32 * torch.rsqrt(var + eps) * p["scale"].to(torch.float32)
    return out.to(x.dtype)


def layernorm(x: torch.Tensor, p: dict, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.to(torch.float32)
    n = x.shape[-1]
    mu = qz.over(torch.sum(x32, dim=-1, keepdim=True), n)
    var = qz.over(torch.sum((x32 - mu) ** 2, dim=-1, keepdim=True), n)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    out = out * p["scale"].to(torch.float32)
    if "bias" in p:
        out = out + p["bias"].to(torch.float32)
    return out.to(x.dtype)


def apply_norm(x: torch.Tensor, p: dict, kind: str) -> torch.Tensor:
    return rmsnorm(x, p) if kind == "rmsnorm" else layernorm(x, p)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


def rope_freqs(head_dim: int, theta: float, positions: torch.Tensor,
               partial: float = 1.0) -> tuple:
    """cos/sin tables (f32) for (possibly partial) RoPE over ``positions``
    (any shape ``(..., S)``); returns ``(cos, sin, rot_dim)``.  ``partial``
    below 1 rotates only the first ``int(head_dim * partial)`` dims."""
    rot = int(head_dim * partial)
    rot -= rot % 2
    dev = positions.device
    exps = qz.over(torch.arange(0, rot, 2, dtype=torch.float32, device=dev), rot)
    inv = 1.0 / torch.pow(torch.full((), theta, dtype=torch.float32, device=dev), exps)
    ang = positions.to(torch.float32)[..., None] * inv       # (..., S, rot/2)
    return torch.cos(ang), torch.sin(ang), rot


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               rot: int) -> torch.Tensor:
    """``x (..., S, n_heads, head_dim)``; ``cos``/``sin`` ``(..., S, rot/2)``.

    As in the reference, a bf16 ``x`` times the f32 tables promotes: the
    rotated result is f32 (the pass-through dims too, by concatenation).
    """
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    o1 = x1 * c - x2 * s
    o2 = x2 * c + x1 * s
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape)
    return torch.cat([out, xp.to(out.dtype)], dim=-1) if xp.shape[-1] else out
