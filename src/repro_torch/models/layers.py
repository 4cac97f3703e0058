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

import contextlib
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.api.policy import Phase, PrecisionPolicy
from repro_torch.api.qtensor import QTensor
from repro_torch.core import mixedprec as mp
from repro_torch.core import quantizers as qz
from repro_torch.dist.sharding import Local
from repro_torch.kernels import quant_conv as qc
from repro_torch.qtrain import linear as qt_linear


# ---------------------------------------------------------------------------
# Initializers (weights from a torch.Generator; the reference's jax.random
# numbers cannot be reproduced, so parity tests bridge the weights instead)
# ---------------------------------------------------------------------------

# where the leaves ``linear_init`` and ``embedding_init`` draw go once drawn
# (``drawn_to``); None: they stay on the generator's device
_DRAWN_TO = None


@contextlib.contextmanager
def drawn_to(device):
    """Inside: each leaf ``linear_init`` and ``embedding_init`` return is
    moved to ``device`` as soon as it is drawn, so a model drawn on a card
    can be built in host memory while the card holds one weight at a time
    (the same numbers as a draw kept on the card)."""
    global _DRAWN_TO
    prev, _DRAWN_TO = _DRAWN_TO, device
    try:
        yield
    finally:
        _DRAWN_TO = prev


def _drawn(t: torch.Tensor) -> torch.Tensor:
    return t if _DRAWN_TO is None else t.to(_DRAWN_TO)


def linear_init(gen: torch.Generator, c_in: int, c_out: int,
                bias: bool = False, dtype=torch.float32, lead: tuple = ()) -> dict:
    """``{"w" (c_out, c_in), "aw" (c_out,), "ax" (), ["b" (c_out,)]}`` drawn
    on ``gen``'s device; ``lead`` prepends axes to every leaf (a stack of
    layers, the reference's vmapped init) and each ``(c_out, c_in)`` slice
    gets its own clips.  ``w`` is stored in ``dtype``, its clips from the
    f32 draw."""
    dev = gen.device
    w = torch.randn(tuple(lead) + (c_out, c_in), generator=gen, dtype=torch.float32,
                    device=dev)
    w = w * (1.0 / math.sqrt(c_in))
    aw = qz.init_weight_alpha(w.reshape(-1, c_in)).reshape(tuple(lead) + (c_out,))
    p = {"w": w.to(dtype), "aw": aw,
         "ax": qz.init_act_alpha().to(dev).expand(tuple(lead)).clone()}
    if bias:
        p["b"] = torch.zeros(tuple(lead) + (c_out,), dtype=dtype, device=dev)
    return {k: _drawn(v) for k, v in p.items()}


def conv2d_init(gen: torch.Generator, c_in: int, c_out: int, kh: int, kw: int,
                bias: bool = True, groups: int = 1) -> dict:
    fan_in = c_in // groups * kh * kw
    w = torch.randn((c_out, c_in // groups, kh, kw), generator=gen,
                    dtype=torch.float32) / math.sqrt(fan_in)
    p = {"w": w, "aw": qz.init_weight_alpha(w), "ax": qz.init_act_alpha()}
    if bias:
        p["b"] = torch.zeros((c_out,), dtype=torch.float32)
    return p


def nas_init(c_out: int, qcfg: mp.MixedPrecConfig, device="cpu", lead: tuple = ()) -> dict:
    """Uniform NAS logits of one linear map, with ``lead`` axes prepended."""
    n = mp.init_nas_params(c_out, qcfg, device)
    return {k: v.expand(tuple(lead) + v.shape).clone() for k, v in n.items()}


def embedding_init(gen: torch.Generator, vocab: int, d: int, dtype=torch.float32) -> torch.Tensor:
    """``(vocab, d)`` normal(0, 0.02) on ``gen``'s device."""
    e = torch.randn((vocab, d), generator=gen, dtype=torch.float32, device=gen.device)
    return _drawn((e * 0.02).to(dtype))


# ---------------------------------------------------------------------------
# Quantization-aware apply
# ---------------------------------------------------------------------------

def _quant_pair(x, w, p, nas, policy: PrecisionPolicy,
                qcfg: mp.MixedPrecConfig, signed_act: bool):
    """(x', w') after the policy's fake quantization.  A weight kept on its
    process's block (a ``sharding.Local``, in a step across processes) is
    quantized there, with the block's rows of its clips and NAS logits, and
    gathered whole (the quantizers are elementwise: the gathered result is
    the whole weight's, bitwise)."""
    local = isinstance(w, Local)
    if policy.phase is Phase.FLOAT:
        return x, (w.whole() if local else w)
    # the reference's clips promote a bf16 x against its f32 clip to f32;
    # torch would round the 0-dim clip to x's dtype instead
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    rows, numel = (w.rows(), w.numel()) if local else (slice(None), None)
    blk = w.block if local else w
    if policy.phase is Phase.QAT8:
        aw = p["aw"][rows].reshape((blk.shape[0],) + (1,) * (blk.ndim - 1))
        xq = qz.quantize_act_any(x, p["ax"], 8, signed_act)
        wq = mp.fake_quant_weight(blk, aw, 8, numel)
    elif policy.phase is Phase.SEARCH:
        xq = mp.effective_act(x, nas["delta"], p["ax"], policy.tau, qcfg, signed_act)
        wq = mp.effective_weight(blk, nas["gamma"], p["aw"], policy.tau, qcfg, rows, numel)
    elif policy.phase is Phase.FROZEN:
        gamma = nas["gamma"]
        xq = mp.frozen_act(x, nas["delta"], p["ax"], qcfg, signed_act)
        wq = mp.frozen_weight(blk, gamma if gamma.shape[0] == 1 else gamma[rows],
                              p["aw"][rows], qcfg)
    else:
        raise ValueError(f"unhandled policy {policy!r}")
    return xq, (w.whole(wq) if local else wq)


def _site_key(policy: PrecisionPolicy, w: torch.Tensor) -> Optional[int]:
    """Per-site stochastic-rounding seed: the policy's seed folded with the
    reference's salt from the (whole) weight's shape, so same-step sites of
    other shapes draw independent noise."""
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


def partial_dtype_of(cfg) -> Optional[torch.dtype]:
    """The result dtype of a training product's sum, from ``cfg`` (``None``:
    the f32 sum)."""
    pd = getattr(cfg, "partial_dtype", "")
    return getattr(torch, pd) if pd else None


def qlinear(x: torch.Tensor, p: dict, nas: Optional[dict],
            policy: PrecisionPolicy, qcfg: mp.MixedPrecConfig,
            signed_act: bool = True, compute_dtype=None,
            partial_dtype=None) -> torch.Tensor:
    """Quantization-aware linear: ``x (..., c_in) @ w (c_out, c_in)^T``.

    ``compute_dtype`` (the language models' ``cfg.cdtype``; ``None`` for
    the MLPerf-Tiny models) sets the reference's rounding points after the
    fake quantization: under ``train_compute="f32"`` x and w are rounded
    to it and the product comes out in it (XLA sums a bf16 dot in f32 and
    rounds once); under ``"bf16"`` the bf16-operand product (f32 sums, or
    ``partial_dtype``) and under ``"int8"`` the f32 product are cast to
    it.  The bias is added in the product's dtype.
    """
    w = p["w"]
    if isinstance(w, QTensor):
        y = w.matmul(deployed_act(x, w, signed_act), policy.backend,
                     compute_dtype or torch.float32)
    elif policy.phase is Phase.DEPLOYED:
        raise TypeError("DEPLOYED policy requires a QTensor weight leaf "
                        "(run Engine.deploy / core.deploy.deploy_linear)")
    else:
        x, w = _quant_pair(x, w, p, nas, policy, qcfg, signed_act)
        if policy.train_compute == "int8":
            y = qt_linear.int8_linear(x, w, _site_key(policy, w), qt_linear.DEFAULT)
            if compute_dtype is not None:
                y = y.to(compute_dtype)
        elif policy.train_compute == "bf16":
            y = _rounded(x, torch.bfloat16) @ _rounded(w, torch.bfloat16).T
            if partial_dtype is not None:
                y = y.to(partial_dtype)
            if compute_dtype is not None:
                y = y.to(compute_dtype)
        elif compute_dtype is not None:
            y = (_rounded(x, compute_dtype) @ _rounded(w, compute_dtype).T).to(
                partial_dtype or compute_dtype)
        else:
            y = x @ w.T
    if "b" in p:
        y = y + p["b"].to(y.dtype)
    return y


def _rounded(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype`` and held in f32 (an f32 ``dtype`` leaves
    it as it is): a product of two bf16 values is exact in f32, so an f32
    matmul of them is the reference's bf16-operand dot with f32 sums."""
    return t.to(dtype).to(torch.float32)


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
              device=None, lead: tuple = ()) -> dict:
    """A norm's ``scale`` (and a layernorm's ``bias``), ``lead`` axes
    prepended (a stack of layers)."""
    shape = tuple(lead) + (d,)
    p = {"scale": torch.ones(shape, dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(shape, dtype=dtype, device=device)
    return p


def halving_sum(t: torch.Tensor) -> torch.Tensor:
    """``t``'s sum over the last axis (kept, size 1) by pairwise halving:
    elementwise adds of the two halves (a zero padded onto an odd width)
    until one column is left, so each row's sum is the same whatever the
    other rows are."""
    while t.shape[-1] > 1:
        if t.shape[-1] % 2:
            t = F.pad(t, (0, 1))
        h = t.shape[-1] // 2
        t = t[..., :h] + t[..., h:]
    return t


def row_sum(t: torch.Tensor) -> torch.Tensor:
    """``t.sum(-1, keepdim=True)`` in an order that does not depend on the
    number of rows.  On the card the library's reduction picks its split of
    a row by the row count, so a speculative verify's row (B x W rows)
    would not sum as the decode step's (B rows): :func:`halving_sum`.  On
    the CPU ``torch.sum``, whose loop over a row is the same at any row
    count (and gives the reference's bits at the tests' widths)."""
    if t.device.type == "cpu":
        return torch.sum(t, dim=-1, keepdim=True)
    return halving_sum(t)


def rmsnorm(x: torch.Tensor, p: dict, eps: float = 1e-5) -> torch.Tensor:
    """In f32, cast back to ``x``'s dtype; the mean is a sum
    (:func:`row_sum`) divided by the width, as the reference's
    ``jnp.mean``."""
    x32 = x.to(torch.float32)
    var = qz.over(row_sum(x32 * x32), x.shape[-1])
    out = x32 * torch.rsqrt(var + eps) * p["scale"].to(torch.float32)
    return out.to(x.dtype)


def layernorm(x: torch.Tensor, p: dict, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.to(torch.float32)
    n = x.shape[-1]
    mu = qz.over(row_sum(x32), n)
    var = qz.over(row_sum((x32 - mu) ** 2), n)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    out = out * p["scale"].to(torch.float32)
    if "bias" in p:
        out = out + p["bias"].to(torch.float32)
    return out.to(x.dtype)


def apply_norm(x: torch.Tensor, p: dict, kind: str) -> torch.Tensor:
    return rmsnorm(x, p) if kind == "rmsnorm" else layernorm(x, p)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` in ``x``'s dtype as XLA computes ``jax.nn.silu``:
    the sigmoid as ``1 / (1 + exp(-x))`` with every op rounded to it
    (``F.silu`` rounds once at bf16, one bf16 ulp off on a third of
    values)."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """The serving path's gated MLP activation (``F.silu``, rounded once);
    the training forward takes :func:`silu`, the reference's roundings."""
    return F.silu(gate) * up


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh GELU in ``x``'s dtype as XLA computes ``jax.nn.gelu`` (its
    default ``approximate=True``): ``x * 0.5 (1 + tanh(c (x + 0.044715
    x^3)))`` with the constants and every op rounded to the dtype
    (``F.gelu(approximate="tanh")`` rounds otherwise at bf16)."""
    c = torch.tensor(math.sqrt(2 / math.pi), dtype=x.dtype, device=x.device)
    a = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
    return x * (0.5 * (1 + torch.tanh(c * (x + a * (x * x * x)))))


def sinusoidal_positions(seq: int, d: int, device=None) -> torch.Tensor:
    """Whisper's fixed sinusoidal position embeddings ``(seq, d)`` in f32:
    ``[sin, cos]`` of ``pos / 10000^(2i/d)``."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(torch.full((), 10000.0, device=device), qz.over(2 * dim, d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


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


def quantize_kv(kv: torch.Tensor, bits: int = 8) -> tuple:
    """Symmetric int8 quantization of KV entries with one scale per
    ``(batch, head)`` slice over the last two axes: ``(q int8, scale)`` with
    ``kv ~ q * scale`` (``bits`` is accepted, as in the reference, and the
    codes are int8 whatever it is)."""
    amax = torch.amax(torch.abs(kv), dim=(-2, -1), keepdim=True)
    scale = qz.over(torch.clamp_min(amax, 1e-6), 127.0)
    return torch.clamp(torch.round(kv / scale), -127, 127).to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """``q * scale`` in f32, rounded to ``dtype``."""
    return qz.dequantize(q, scale, dtype)
