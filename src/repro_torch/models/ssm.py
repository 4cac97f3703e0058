"""Mamba2 (state-space duality, arXiv:2405.21060): the block's training
init and forward, the chunked SSD scan of a full sequence and the
one-token recurrent step of decode.

Counterpart of ``repro.models.ssm``.  The block: x -> in_proj -> [z | xBC
| dt]; a depthwise causal conv over xBC; split into x, B and C; the SSD
recurrence over heads with one decay rate a head; the output gated by
silu(z); out_proj.  The linears are searched ones in training
(:func:`mamba2_forward`: ``layers.qlinear``, K5 under int8 compute) and
deployed ones in serving (``serving.dq_linear``: the kernels on the card);
both run the part between them through :func:`mamba2_mix`.  The conv and
the recurrence are plain PyTorch, as they are plain jnp in the reference
(it has no Pallas kernel for them).

:func:`ssd_chunked` is the reference's chunked algorithm: within a chunk of
``Q`` tokens the recurrence is a masked, decay-weighted quadratic form;
across chunks a Python loop carries the ``(B, H, P, N)`` state, with the
reference's per-chunk algebra and chunk length, so the two sum in the same
order.  It differs in one place: the reference exponentiates the decay
differences above the diagonal too and masks the result, where they
overflow to ``inf`` and its gradient is NaN; the port masks the exponent
(the forward is the same).  :func:`mamba2_decode` is the O(1) step: the
conv ring of the last ``CONV_K - 1`` inputs and the f32 state, written in
place.

The conv rounds as the reference's does: over a sequence each product and
sum of its ``CONV_K`` taps is rounded to the compute dtype (an elementwise
loop), at one token the taps are summed in f32 and rounded once (a dot), so
the two differ by a few bf16 ulps.  :func:`ssd_step` is the recurrence
alone: fed the sequence conv's outputs token by token it reaches the
chunked scan's final state up to f32 rounding.
"""
from __future__ import annotations

from typing import Optional

import math

import torch
import torch.nn.functional as F

from repro_torch.dist import sharding as shd
from repro_torch.models import layers as L

CONV_K = 4  # mamba2 depthwise conv kernel size


def dims(cfg) -> tuple:
    """``(d_inner, n_heads, state N, head dim P)`` of the SSM layers."""
    d_inner = cfg.ssm_expand * cfg.d_model
    n_heads = d_inner // cfg.ssm_head_dim
    return d_inner, n_heads, cfg.ssm_state, cfg.ssm_head_dim


silu = L.silu


def init_mamba2(gen: torch.Generator, cfg, dtype=torch.float32, lead: tuple = ()) -> tuple:
    """``(params, nas)`` of one Mamba2 block (a stack with ``lead`` axes):
    the two searched linears, the conv taps (normal / sqrt(CONV_K)) and
    bias, the decay rates ``A_log`` (log 1..16), ``D`` and ``dt_bias``
    (always f32), and the gate's RMS norm."""
    dev = gen.device
    d_inner, H, N, P = dims(cfg)
    C = d_inner + 2 * N                                 # x + B + C (one group)
    lead = tuple(lead)
    conv_w = torch.randn(lead + (CONV_K, C), generator=gen, device=dev) / math.sqrt(CONV_K)
    a_log = torch.log(torch.linspace(1.0, 16.0, H, device=dev))
    params = {
        "in_proj": L.linear_init(gen, cfg.d_model, 2 * d_inner + 2 * N + H, False, dtype, lead),
        "out_proj": L.linear_init(gen, d_inner, cfg.d_model, False, dtype, lead),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros(lead + (C,), dtype=dtype, device=dev),
        "A_log": a_log.expand(lead + (H,)).clone(),
        "D": torch.ones(lead + (H,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros(lead + (H,), dtype=torch.float32, device=dev),
        "norm": L.norm_init(d_inner, "rmsnorm", dtype, dev, lead),
    }
    nas = {k: L.nas_init(params[k]["w"].shape[-2], cfg.quant, dev, lead)
           for k in ("in_proj", "out_proj")}
    return params, nas


def mamba2_mix(zxbcdt: torch.Tensor, p: dict, cfg, real: Optional[torch.Tensor] = None) -> tuple:
    """The block between its two linears: ``in_proj``'s output ``zxbcdt
    (B, S, 2 d_inner + 2 N + H)`` in the compute dtype -> ``(the gated,
    normed ``(B, S, d_inner)`` input of out_proj, the final SSD state (B,
    H, P, N) f32)``.  ``real (B, S)`` bool zeroes ``dt`` at padded steps
    (decay 1, no input), so the state is each row's at its last real
    token."""
    B, S, _ = zxbcdt.shape
    d_inner, H, N, P = dims(cfg)
    cd, f32 = cfg.cdtype, torch.float32
    z = zxbcdt[..., :d_inner]
    xbc = causal_conv(zxbcdt[..., d_inner:2 * d_inner + 2 * N], p["conv_w"].to(cd),
                      p["conv_b"].to(cd))
    xs = xbc[..., :d_inner].reshape(B, S, H, P)
    Bm = xbc[..., d_inner:d_inner + N]
    Cm = xbc[..., d_inner + N:]
    dt = F.softplus(zxbcdt[..., -H:].to(f32) + p["dt_bias"])
    if real is not None:
        dt = torch.where(real[..., None], dt, torch.zeros((), device=dt.device))
    y, hT = ssd_chunked(xs.to(f32), dt, torch.exp(p["A_log"]), Bm.to(f32), Cm.to(f32),
                        cfg.ssm_chunk)
    y = y + xs.to(f32) * p["D"][None, None, :, None]
    y = y.reshape(B, S, d_inner).to(cd)
    return L.rmsnorm(y * silu(z.to(cd)), p["norm"]), hT


def mamba2_forward(p: dict, nas: Optional[dict], policy, cfg, x: torch.Tensor) -> torch.Tensor:
    """The full-sequence Mamba2 block under a training ``policy``: ``x (B,
    S, d)`` -> ``(B, S, d)`` in ``cfg.cdtype``; differentiable.  in_proj and
    out_proj are searched linears at the compute dtype (K5 under int8)."""
    getn = (lambda n: nas[n]) if nas is not None else (lambda n: None)
    zxbcdt = L.qlinear(x, p["in_proj"], getn("in_proj"), policy, cfg.quant,
                       compute_dtype=cfg.cdtype)
    y, _ = mamba2_mix(zxbcdt, p, cfg)
    return L.qlinear(y, p["out_proj"], getn("out_proj"), policy, cfg.quant,
                     compute_dtype=cfg.cdtype)


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


def ssd_step(h: torch.Tensor, xbc: torch.Tensor, dt_raw: torch.Tensor, p: dict, cfg,
             dt: Optional[torch.Tensor] = None) -> tuple:
    """One token of the SSD recurrence: the state ``h (B, H, P, N)`` f32,
    the conv output ``xbc (B, C)`` and the raw steps ``dt_raw (B, H)`` (or
    their softplus ``dt`` computed already) -> ``(h', y (B, H, P) f32)``
    with the skip term ``D x`` added."""
    B = xbc.shape[0]
    d_inner, H, N, P = dims(cfg)
    f32 = torch.float32
    xs = xbc[..., :d_inner].reshape(B, H, P).to(f32)
    Bm = xbc[..., d_inner:d_inner + N].to(f32)
    Cm = xbc[..., d_inner + N:].to(f32)
    if dt is None:
        dt = F.softplus(dt_raw.to(f32) + p["dt_bias"])           # (B, H)
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
    reference (a padded step has ``dt = 0``: decay 1, no input).  The
    ``constrain`` sites are the reference's, in its order.
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
    to_chunks = lambda t: t.reshape(Bsz, nc, chunk, *t.shape[2:]).transpose(0, 1)
    xc = shd.constrain(to_chunks(xh), None, "D", None, "M", None)
    dtc = shd.constrain(to_chunks(dt), None, "D", None, "M")
    Bc = shd.constrain(to_chunks(Bm), None, "D", None, None)
    Cc = shd.constrain(to_chunks(Cm), None, "D", None, None)
    negA = -A
    dev = xh.device
    mask = (torch.arange(chunk, device=dev)[:, None]
            >= torch.arange(chunk, device=dev)[None, :])[None, :, :, None]
    if h0 is None:
        h = shd.constrain(torch.zeros((Bsz, H, P, N), dtype=xh.dtype, device=dev),
                          "D", "M", None, None)
    else:
        h = h0
    ys = []
    for c in range(nc):
        xq, dtq, Bq, Cq = xc[c], dtc[c], Bc[c], Cc[c]
        if c == 0:      # the reference's scan traces its body, and these sites, once
            xq = shd.constrain(xq, "D", None, "M", None)
            h = shd.constrain(h, "D", "M", None, None)
        dA = dtq * negA                                         # (B, Q, H), <= 0
        cum = torch.cumsum(dA, dim=1)
        # intra-chunk: L[t, s] = exp(cum[t] - cum[s]) for s <= t
        # above the diagonal diff is a positive sum that overflows exp: the
        # exponent is masked, not its result, so no inf meets the backward
        diff = cum[:, :, None, :] - cum[:, None, :, :]          # (B, Qt, Qs, H)
        Lmat = torch.exp(torch.where(mask, diff, torch.full((), -torch.inf, device=dev)))
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
    # the steps are the token's own (and torch's CPU softplus rounds by the
    # tensor's size): on the whole batch
    dt = F.softplus(zxbcdt[..., -H:].to(torch.float32) + p["dt_bias"])   # (B, H)
    rows = shd.row_work(cache["h"], B)
    if rows is None:
        y = _state_step(p, cfg, cache, xbc_new, dt, live)
    else:                           # each data row steps its own slots' conv ring and state
        y = shd.replicate_serving([
            _state_step(shd.row_params(p, r), cfg, {k: cache[k].row(r) for k in ("h", "conv")},
                        xbc_new[sl].to(dev), dt[sl].to(dev),
                        None if live is None else live[sl].to(dev), plan_slots=B)
            for r, sl, dev in rows])
    y = y.reshape(B, 1, d_inner).to(cd)
    y = L.rmsnorm(y * silu(z[:, None].to(cd)), p["norm"])
    return dq_linear(y, p["out_proj"]), cache


def _state_step(p: dict, cfg, cache: dict, xbc_new, dt, live,
                plan_slots: Optional[int] = None) -> torch.Tensor:
    """The cache-bound half of :func:`mamba2_decode` over one set of slots:
    the conv ring and the SSD state step (``dt`` the softplus'd steps),
    written in place (``live=False`` slots keep theirs) -> ``y (B, H, P)``
    f32.  ``plan_slots``: the whole batch's slots, when these are a data
    row's: the state step runs padded to them (``sharding.pad_rows``; its
    output ``einsum`` is a library product), bitwise the whole batch's."""
    cd = cfg.cdtype
    B = xbc_new.shape[0]
    window = torch.cat([cache["conv"].to(cd), xbc_new[:, None].to(cd)], dim=1)  # (B, K, C)
    xbc = conv_step(window, p["conv_w"].to(cd), p["conv_b"].to(cd))
    h, y = ssd_step(*(shd.pad_rows(t, plan_slots) for t in (cache["h"], xbc)), None, p, cfg,
                    dt=shd.pad_rows(dt, plan_slots))
    h, y = h[:B], y[:B]
    new_conv = window[:, 1:].to(torch.bfloat16)
    if live is not None:
        h = torch.where(live[:, None, None, None], h, cache["h"])
        new_conv = torch.where(live[:, None, None], new_conv, cache["conv"])
    cache["h"].copy_(h)
    cache["conv"].copy_(new_conv)
    return y
