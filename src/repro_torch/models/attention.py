"""Attention of the language models: grouped-query attention (GQA) and
DeepSeek's multi-head latent attention (MLA), full-sequence (prefill) and
one-token cached decode.

Counterpart of the GQA and MLA parts of ``repro.models.attention``.  Full-sequence
attention is the reference's blockwise online softmax over KV chunks,
mirrored chunk by chunk in plain PyTorch, so the S x S score matrix never
materializes.

KV caches default to int8 with one scale per token
(:func:`quant_per_token`); a ``kv_spec`` (``models/kv_quant.KVQuantSpec``)
stores the ring channel-wise packed instead, and decode then attends
through the hand-written CUDA kernel (``backend="cuda"``,
``kernels/decode_attention.py``) or through the dequantized ring.

Dot products whose bf16 result the reference casts to f32 at once are
summed in f32 here without the bf16 rounding: XLA folds such a cast into
the dot, so that is what the reference computes.

MLA caches the normalized KV latent (int8 per token, or channel-wise
packed over ``kv_lora_rank``) and the shared rotary key; decode expands the
whole ring through the packed ``wkv_b`` linear every step, as the
reference does (it no longer absorbs ``wkv_b`` into the query from a dense
view of the weight).

Unlike the reference, :func:`gqa_decode` and :func:`mla_decode` write the
new cache entries in place (the caller's ring tensors are updated and
returned).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core import quantizers as qz
from repro_torch.kernels import decode_attention as datt
from repro_torch.models import kv_quant as kvq
from repro_torch.models import layers as L


# ---------------------------------------------------------------------------
# Blockwise (online-softmax) attention core
# ---------------------------------------------------------------------------

def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, k_chunk: int = 1024,
                        q_offset: int = 0) -> torch.Tensor:
    """``softmax(q k^T / sqrt(d)) v`` over KV chunks with a running
    (max, denominator, numerator).  ``q (B, H, Sq, D)``, ``k``/``v
    (B, H, Skv, D)``; returns ``(B, H, Sq, Dv)`` in ``q``'s dtype."""
    B, H, Sq, D = q.shape
    Dv = v.shape[-1]
    Skv = k.shape[2]
    k_chunk = min(k_chunk, Skv)
    n_chunks = math.ceil(Skv / k_chunk)
    pad = n_chunks * k_chunk - Skv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    dev = q.device
    scale = 1.0 / math.sqrt(D)
    q_pos = q_offset + torch.arange(Sq, device=dev)
    q32 = q.to(torch.float32)
    m = torch.full((B, H, Sq), -math.inf, dtype=torch.float32, device=dev)
    d_sum = torch.zeros((B, H, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, Sq, Dv), dtype=torch.float32, device=dev)
    neg_inf = torch.full((), -math.inf, device=dev)
    zero = torch.zeros((), device=dev)
    for ci in range(n_chunks):
        kb = k[:, :, ci * k_chunk:(ci + 1) * k_chunk]
        vb = v[:, :, ci * k_chunk:(ci + 1) * k_chunk]
        kv_pos = ci * k_chunk + torch.arange(k_chunk, device=dev)
        s = torch.matmul(q32, kb.to(torch.float32).transpose(-1, -2)) * scale
        mask = kv_pos[None, :] < Skv
        if causal:
            mask = mask & (kv_pos[None, :] <= q_pos[:, None])
        else:
            mask = mask.expand(Sq, k_chunk)
        s = torch.where(mask, s, neg_inf)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        # a fully masked chunk leaves -inf rows: exp(-inf - -inf) needs a safe max
        m_safe = torch.where(torch.isfinite(m_new), m_new, zero)
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(mask, p, zero)
        fin = torch.isfinite(m)
        corr = torch.exp(torch.where(fin, m - m_safe, neg_inf))
        corr = torch.where(fin, corr, zero)
        d_sum = d_sum * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + torch.matmul(
            p.to(vb.dtype).to(torch.float32), vb.to(torch.float32))
        m = m_new
    out = acc / torch.clamp_min(d_sum, 1e-30)[..., None]
    return out.to(q.dtype)


def gqa_core(q, k, v, n_heads: int, n_kv: int, causal: bool,
             q_offset: int = 0, k_chunk: int = 1024) -> torch.Tensor:
    """Grouped-query attention: ``q (B, S, H, D)``, ``k``/``v
    (B, S, KV, D)`` -> ``(B, S, H, Dv)``."""
    B, Sq, H, D = q.shape
    Dv = v.shape[-1]
    rep = n_heads // n_kv
    qh = q.transpose(1, 2)
    kh = k.transpose(1, 2)
    vh = v.transpose(1, 2)
    if rep > 1:
        kh = torch.repeat_interleave(kh, rep, dim=1)
        vh = torch.repeat_interleave(vh, rep, dim=1)
    out = blockwise_attention(qh, kh, vh, causal, k_chunk, q_offset)
    return out.reshape(B, H, Sq, Dv).transpose(1, 2)


# ---------------------------------------------------------------------------
# KV ring caches and cached decode
# ---------------------------------------------------------------------------

def init_gqa_cache(cfg, batch: int, max_len: int,
                   spec: Optional[kvq.KVQuantSpec] = None, device=None) -> dict:
    """GQA ring cache.  ``spec=None``: int8 values and one f32 scale per
    token; with a spec, packed rows (uint8, feature axis in bytes) and one
    f32 scale per channel group.  Same keys either way."""
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    if spec is None:
        nb, G, vdt = hd, 1, torch.int8
    else:
        if spec.feat != hd:
            raise ValueError(f"spec width {spec.feat} != head_dim {hd}")
        nb, G, vdt = spec.packed_bytes, spec.n_groups, torch.uint8
    shape = (batch, KV, max_len)
    return {
        "k": torch.zeros(shape + (nb,), dtype=vdt, device=device),
        "v": torch.zeros(shape + (nb,), dtype=vdt, device=device),
        "k_scale": torch.zeros(shape + (G,), dtype=torch.float32, device=device),
        "v_scale": torch.zeros(shape + (G,), dtype=torch.float32, device=device),
    }


def quant_per_token(t: torch.Tensor) -> tuple:
    """Per-token symmetric int8 quantization of KV entries: ``t (..., D) ->
    (q int8 (..., D), scale f32 (..., 1))`` with ``t ~ q * scale``."""
    return kvq.quant_symmetric(t, 8)


def slot_write_pos(pos: torch.Tensor, live: Optional[torch.Tensor],
                   max_len: int) -> torch.Tensor:
    """Per-slot ring-write index: dead slots write out of bounds (at
    ``max_len``), which the writers drop."""
    pos = pos.to(torch.int64)
    if live is None:
        return pos
    return torch.where(live, pos, torch.full_like(pos, max_len))


def _ring_write(ring: torch.Tensor, wpos: torch.Tensor, new: torch.Tensor) -> None:
    """``ring[b, :, wpos[b]] = new[b]`` in place for every row whose
    ``wpos`` lies in the ring; other rows are left as they are (the
    reference's ``mode="drop"``).  No host sync: dropped rows write back
    what they read."""
    B, S = ring.shape[0], ring.shape[2]
    keep = (wpos >= 0) & (wpos < S)
    at = torch.clamp(wpos, 0, S - 1)
    bidx = torch.arange(B, device=ring.device)
    old = ring[bidx, :, at]                                   # (B, KV, F)
    ring[bidx, :, at] = torch.where(keep[:, None, None], new.to(ring.dtype), old)


def gqa_decode(p: dict, cfg, x: torch.Tensor, cache: dict, pos: torch.Tensor,
               dq_linear, live: Optional[torch.Tensor] = None,
               kv_spec: Optional[kvq.KVQuantSpec] = None,
               backend: str = "cuda") -> tuple:
    """One-token decode over a dense ring cache, per-slot positions.

    ``x (B, 1, d)``; ``pos (B,)`` int: row ``b`` writes its new KV at ring
    index ``pos[b]`` and attends to ``<= pos[b]``; ``live (B,)`` bool: rows
    with ``live=False`` drop their ring write.  ``dq_linear`` applies a
    deployed linear.  ``kv_spec``: the channel-wise packed ring of
    ``init_gqa_cache(..., spec=kv_spec)``; with ``backend="cuda"`` it is
    attended through the decode-attention kernel (on CPU tensors, its
    plain version), otherwise through the dequantized ring.  Writes
    ``cache`` in place and returns ``(y (B, 1, d), cache)``.
    """
    if x.shape[1] != 1:
        raise NotImplementedError(
            "multi-token (speculative verify) decode is not ported yet: "
            "ROADMAP.md queue 1 item 6")
    B = x.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cd = cfg.cdtype
    pos = torch.as_tensor(pos, device=x.device).to(torch.int32)
    if pos.ndim == 0:
        pos = pos.expand(B).contiguous()
    q = dq_linear(x, p["wq"]).reshape(B, 1, H, hd)
    k = dq_linear(x, p["wk"]).reshape(B, 1, KV, hd)
    v = dq_linear(x, p["wv"]).reshape(B, 1, KV, hd)
    if cfg.rope_partial > 0:
        cos, sin, rot = L.rope_freqs(hd, cfg.rope_theta, pos[:, None], cfg.rope_partial)
        q = L.apply_rope(q, cos, sin, rot)
        k = L.apply_rope(k, cos, sin, rot)
    if kv_spec is None:
        kq, ks = quant_per_token(k.transpose(1, 2))          # (B, KV, 1, hd)
        vq, vs = quant_per_token(v.transpose(1, 2))
    else:
        kq, ks = kvq.quant_channelwise(k.transpose(1, 2), kv_spec)
        vq, vs = kvq.quant_channelwise(v.transpose(1, 2), kv_spec)
    S = cache["k"].shape[2]
    wpos = slot_write_pos(pos, live, S)
    for key, new in (("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs)):
        _ring_write(cache[key], wpos, new[:, :, 0])
    rep = H // KV
    qg = q.transpose(1, 2).reshape(B, KV, rep, hd)        # q keeps its dtype (f32 after RoPE)
    if kv_spec is not None and backend == "cuda":
        o = datt.decode_attention(qg, cache["k"], cache["k_scale"], cache["v"],
                                  cache["v_scale"], pos, kv_spec.bits, kv_spec.sizes,
                                  out_dtype=cd)
    else:
        if kv_spec is None:
            kf = (cache["k"].to(torch.float32) * cache["k_scale"]).to(cd)
            vf = (cache["v"].to(torch.float32) * cache["v_scale"]).to(cd)
        else:
            kf = kvq.dequant_channelwise(cache["k"], cache["k_scale"], kv_spec, cd)
            vf = kvq.dequant_channelwise(cache["v"], cache["v_scale"], kv_spec, cd)
        o = datt.attend(qg, kf, vf, pos, cd)
    return dq_linear(o.reshape(B, 1, H * hd), p["wo"]), cache


# ---------------------------------------------------------------------------
# Multi-head latent attention (deepseek-v3): latent ring cache and decode
# ---------------------------------------------------------------------------

def init_mla_cache(cfg, batch: int, max_len: int,
                   spec: Optional[kvq.KVQuantSpec] = None, device=None) -> dict:
    """MLA ring cache, ``(batch, max_len, F)`` per leaf: the latent ``ckv``
    (int8 with one f32 scale per token, or packed channel-wise over
    ``kv_lora_rank`` with one scale per group) and the shared rotary key
    ``krope`` in bf16."""
    kvr = cfg.kv_lora_rank
    if spec is None:
        nb, G, vdt = kvr, 1, torch.int8
    else:
        if spec.feat != kvr:
            raise ValueError(f"spec width {spec.feat} != kv_lora_rank {kvr}")
        nb, G, vdt = spec.packed_bytes, spec.n_groups, torch.uint8
    shape = (batch, max_len)
    return {
        "ckv": torch.zeros(shape + (nb,), dtype=vdt, device=device),
        "ckv_scale": torch.zeros(shape + (G,), dtype=torch.float32, device=device),
        "krope": torch.zeros(shape + (cfg.qk_rope_dim,), dtype=torch.bfloat16, device=device),
    }


def mla_decode(p: dict, cfg, x: torch.Tensor, cache: dict, pos: torch.Tensor,
               dq_linear, live: Optional[torch.Tensor] = None,
               kv_spec: Optional[kvq.KVQuantSpec] = None) -> tuple:
    """One-token MLA decode over a dense ring cache, per-slot positions.

    ``x (B, 1, d)``; ``pos (B,)``: row ``b`` writes its latent at ring
    index ``pos[b]`` and attends to ``<= pos[b]``; ``live=False`` rows drop
    their write.  The cached latents of every slot are dequantized and
    expanded to per-head keys and values through the packed ``wkv_b``
    linear (``dq_linear``; on the kernel path the fused GEMM over all ``B *
    S`` cached latents), then one query attends: the score dots summed in
    f32 (bf16 operands, no bf16 rounding, as XLA folds the reference's
    cast), divided by ``sqrt(nope + rope)``, an f32 softmax rounded to the
    compute dtype, the value dot rounded once.  Writes ``cache`` in place
    and returns ``(y (B, 1, d), cache)``.
    """
    if x.shape[1] != 1:
        raise NotImplementedError(
            "multi-token (speculative verify) MLA decode, _mla_decode_multi, is not "
            "ported yet: ROADMAP.md queue 1 item 6")
    B = x.shape[0]
    H = cfg.n_heads
    nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank
    cd = cfg.cdtype
    pos = torch.as_tensor(pos, device=x.device).to(torch.int32)
    if pos.ndim == 0:
        pos = pos.expand(B).contiguous()

    cq = L.rmsnorm(dq_linear(x, p["wq_a"]), p["q_norm"])
    q = dq_linear(cq, p["wq_b"]).reshape(B, 1, H, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    ckv_new = dq_linear(x, p["wkv_a"])
    c_kv, k_rope_new = ckv_new[..., :kvr], ckv_new[..., kvr:]
    c_kv = L.rmsnorm(c_kv, p["kv_norm"])
    cos, sin, rot = L.rope_freqs(rope, cfg.rope_theta, pos[:, None], 1.0)
    q_rope = L.apply_rope(q_rope, cos, sin, rot)
    k_rope_new = L.apply_rope(k_rope_new[:, :, None, :], cos, sin, rot)[:, :, 0]

    if kv_spec is None:
        qc, qs = quant_per_token(c_kv)                       # (B, 1, kvr), (B, 1, 1)
    else:
        qc, qs = kvq.quant_channelwise(c_kv, kv_spec)
    S = cache["ckv"].shape[1]
    wpos = slot_write_pos(pos, live, S)
    # the (B, S, F) rings seen as (B, 1, S, F): one "kv-head" of the GQA writer
    for key, new in (("ckv", qc), ("ckv_scale", qs),
                     ("krope", k_rope_new.to(torch.bfloat16))):
        _ring_write(cache[key].unsqueeze(1), wpos, new)

    if kv_spec is None:
        ckv_f = (cache["ckv"].to(torch.float32) * cache["ckv_scale"]).to(cd)
    else:
        ckv_f = kvq.dequant_channelwise(cache["ckv"], cache["ckv_scale"], kv_spec, cd)
    kv = dq_linear(ckv_f, p["wkv_b"]).reshape(B, S, H, nope + vd)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    f32 = torch.float32
    s = torch.einsum("bqhn,bkhn->bhqk", q_nope.to(cd).to(f32), k_nope.to(cd).to(f32))
    s = s + torch.einsum("bqhr,bkr->bhqk", q_rope.to(cd).to(f32),
                         cache["krope"].to(cd).to(f32))
    s = qz.over(s, math.sqrt(nope + rope))
    valid = torch.arange(S, device=x.device)[None, None, None, :] <= pos[:, None, None, None]
    s = torch.where(valid, s, torch.full((), -math.inf, device=x.device))
    e = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    w = (e / torch.sum(e, dim=-1, keepdim=True)).to(cd)
    o = torch.einsum("bhqk,bkhv->bqhv", w.to(f32), v.to(cd).to(f32)).to(cd)
    return dq_linear(o.reshape(B, 1, H * vd), p["wo"]), cache
