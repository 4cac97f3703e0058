"""Mamba2 (state-space duality, arXiv:2405.21060): the chunked SSD scan of
a full sequence and the one-token recurrent step of decode.

Counterpart of the serving parts of ``repro.models.ssm``.  The block: x ->
in_proj -> [z | xBC | dt]; a depthwise causal conv over xBC; split into x,
B and C; the SSD recurrence over heads with one decay rate a head; the
output gated by silu(z); out_proj.  The linears are deployed ones
(``serving.dq_linear``: the kernels on the card); the conv and the
recurrence are plain PyTorch, as they are plain jnp in the reference (it
has no Pallas kernel for them).

:func:`ssd_chunked` is the reference's chunked algorithm: within a chunk of
``Q`` tokens the recurrence is a masked, decay-weighted quadratic form;
across chunks a Python loop carries the ``(B, H, P, N)`` state, with the
reference's per-chunk algebra and chunk length, so the two sum in the same
order.  :func:`mamba2_decode` is the O(1) step: the conv ring of the last
``CONV_K - 1`` inputs and the f32 state, written in place.

The conv rounds as the reference's does: over a sequence each product and
sum of its ``CONV_K`` taps is rounded to the compute dtype (an elementwise
loop), at one token the taps are summed in f32 and rounded once (a dot), so
the two differ by a few bf16 ulps.  :func:`ssd_step` is the recurrence
alone: fed the sequence conv's outputs token by token it reaches the
chunked scan's final state up to f32 rounding.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L

CONV_K = 4  # mamba2 depthwise conv kernel size


def dims(cfg) -> tuple:
    """``(d_inner, n_heads, state N, head dim P)`` of the SSM layers."""
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, n_heads, cfg.ssm_state, cfg.ssm_head_dim


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` in ``x``'s dtype as XLA computes ``jax.nn.silu``:
    the sigmoid as ``1 / (1 + exp(-x))`` with every op rounded to it."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d and silu: ``xbc (B, S, C)``, ``w (CONV_K,
    C)``, ``b (C,)``, all in the compute dtype, each product and sum rounded
    to it, as the reference's elementwise loop over the taps."""
    S = xbc.shape[1]
    pad = F.pad(xbc, (0, 0, CONV_K - 1, 0))
    out = torch.zeros_like(xbc)
    for i in range(CONV_K):
        out = out + pad[:, i:i + S] * w[i]
    return silu(out + b)


def conv_step(window: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The conv at one token over its ring ``window (B, CONV_K, C)``: the
    taps summed in f32 and rounded once (the reference's one-token
    ``einsum``), the bias added and silu in the compute dtype."""
    acc = window[:, 0].to(torch.float32) * w[0].to(torch.float32)
    for i in range(1, CONV_K):
        acc = acc + window[:, i].to(torch.float32) * w[i].to(torch.float32)
    return silu(acc.to(window.dtype) + b)


def ssd_step(h: torch.Tensor, xbc: torch.Tensor, dt_raw: torch.Tensor, p: dict, cfg) -> tuple:
    """One token of the SSD recurrence: the state ``h (B, H, P, N)`` f32,
    the conv output ``xbc (B, C)`` and the raw steps ``dt_raw (B, H)`` ->
    ``(h', y (B, H, P) f32)`` with the skip term ``D x`` added."""
    B = xbc.shape[0]
    d_inner, H, N, P = dims(cfg)
    f32 = torch.float32
    xs = xbc[..., :d_inner].reshape(B, H, P).to(f32)
    Bm = xbc[..., d_inner:d_inner + N].to(f32)
    Cm = xbc[..., d_inner + N:].to(f32)
    dt = F.softplus(dt_raw.to(f32) + p["dt_bias"])               # (B, H)
    decay = torch.exp(-torch.exp(p["A_log"]) * dt)
    xdt = xs * dt[..., None]                                     # (B, H, P)
    h = h * decay[:, :, None, None] + xdt[..., None] * Bm[:, None, None, :]
    y = torch.einsum("bn,bhpn->bhp", Cm, h)
    return h, y + xs * p["D"][None, :, None]


def ssd_chunked(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, chunk: int, h0: Optional[torch.Tensor] = None) -> tuple:
    """Chunked SSD.

    ``xh (B, S, H, P)`` inputs per head; ``dt (B, S, H)`` softplus'd steps;
    ``A (H,)`` decay rates (positive); ``Bm``/``Cm (B, S, N)`` shared across
    heads (one group).  Returns ``(y (B, S, H, P), final state (B, H, P,
    N))``, f32.  The sequence is zero-padded to whole chunks, as in the
    reference (a padded step has ``dt = 0``: decay 1, no input).
    """
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    nc = -(-S // chunk)
    pad = nc * chunk - S
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    negA = -A
    dev = xh.device
    mask = (torch.arange(chunk, device=dev)[:, None]
            >= torch.arange(chunk, device=dev)[None, :])[None, :, :, None]
    h = torch.zeros((Bsz, H, P, N), dtype=xh.dtype, device=dev) if h0 is None else h0
    ys = []
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        xq, dtq, Bq, Cq = xh[:, sl], dt[:, sl], Bm[:, sl], Cm[:, sl]
        dA = dtq * negA                                         # (B, Q, H), <= 0
        cum = torch.cumsum(dA, dim=1)
        # intra-chunk: L[t, s] = exp(cum[t] - cum[s]) for s <= t
        diff = cum[:, :, None, :] - cum[:, None, :, :]          # (B, Qt, Qs, H)
        Lmat = torch.where(mask, torch.exp(diff), torch.zeros((), device=dev))
        CB = torch.einsum("btn,bsn->bts", Cq, Bq)
        W = CB[:, :, :, None] * Lmat
        xdt = xq * dtq[..., None]                               # (B, Q, H, P)
        y_intra = torch.einsum("btsh,bshp->bthp", W, xdt)
        # inter-chunk: the carried state's contribution
        decay_in = torch.exp(cum)
        y_inter = torch.einsum("btn,bhpn->bthp", Cq, h) * decay_in[..., None]
        # h' = exp(cum[-1]) h + sum_s exp(cum[-1] - cum[s]) B_s xdt_s
        tail = torch.exp(cum[:, -1:, :] - cum)
        h = h * torch.exp(cum[:, -1, :])[:, :, None, None]
        h = h + torch.einsum("bsn,bshp->bhpn", Bq, xdt * tail[..., None])
        ys.append(y_intra + y_inter)
        del diff, Lmat, W
    y = torch.cat(ys, dim=1)[:, :S]
    return y, h


def init_ssm_cache(cfg, batch: int, device=None) -> dict:
    """One layer's recurrent cache: the state ``h (batch, H, P, N)`` f32 and
    the conv ring of the last ``CONV_K - 1`` inputs ``(batch, CONV_K - 1,
    C)`` bf16."""
    d_inner, H, N, P = dims(cfg)
    return {"h": torch.zeros((batch, H, P, N), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, CONV_K - 1, d_inner + 2 * N), dtype=torch.bfloat16,
                                device=device)}


def mamba2_decode(p: dict, cfg, x: torch.Tensor, cache: dict, dq_linear,
                  live: Optional[torch.Tensor] = None) -> tuple:
    """One-token recurrent step: ``x (B, 1, d) -> (y (B, 1, d), cache)``.

    ``dq_linear`` applies a deployed linear.  ``live (B,)`` bool: rows with
    ``live=False`` keep their state and conv ring untouched (freed slots of
    a fixed-width batch must not drift while they wait for admission).
    Writes ``cache`` in place and returns it.
    """
    B = x.shape[0]
    d_inner, H, N, P = dims(cfg)
    cd = cfg.cdtype
    zxbcdt = dq_linear(x, p["in_proj"])[:, 0]                  # (B, 2 di + 2 N + H)
    z = zxbcdt[..., :d_inner]
    xbc_new = zxbcdt[..., d_inner:2 * d_inner + 2 * N]
    dt_raw = zxbcdt[..., -H:]
    window = torch.cat([cache["conv"].to(cd), xbc_new[:, None].to(cd)], dim=1)  # (B, K, C)
    xbc = conv_step(window, p["conv_w"].to(cd), p["conv_b"].to(cd))
    h, y = ssd_step(cache["h"], xbc, dt_raw, p, cfg)
    y = y.reshape(B, 1, d_inner).to(cd)
    y = L.rmsnorm(y * silu(z[:, None].to(cd)), p["norm"])
    out = dq_linear(y, p["out_proj"])
    new_conv = window[:, 1:].to(torch.bfloat16)
    if live is not None:
        h = torch.where(live[:, None, None, None], h, cache["h"])
        new_conv = torch.where(live[:, None, None], new_conv, cache["conv"])
    cache["h"].copy_(h)
    cache["conv"].copy_(new_conv)
    return out, cache
