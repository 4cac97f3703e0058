"""Attention of the language models: grouped-query attention (GQA) and
DeepSeek's multi-head latent attention (MLA), full-sequence (prefill) and
one-token cached decode, and their training forwards (:func:`init_gqa`,
:func:`gqa_forward`, whisper's :func:`cross_forward`, :func:`init_mla`,
:func:`mla_forward`: every projection a quantization-aware ``qlinear``
under the step's policy, differentiable end to end).

Counterpart of the GQA, MLA and cross-attention parts of
``repro.models.attention``.  Full-sequence attention is the reference's
blockwise online softmax over KV chunks, mirrored chunk by chunk in plain
PyTorch, so the S x S score matrix never materializes.

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

Both decodes also take the paged layout (``pages``, ``page_size``): the
cache leaves are then physical page pools, the new entry lands through the
page table (``cache/paged.write_coords``) and attention reads the slot's
pages gathered into the dense ring view, so the decode-attention kernel
takes no page table.

Both decodes also take ``W > 1`` query tokens a slot (the speculative
verify, the reference's ``_gqa_decode_multi`` and ``_mla_decode_multi``): all ``W``
entries land in one scatter, then ``W`` single-query steps run, each as the
one-token decode would, so the verify's rows are those of ``W`` sequential
decode steps.

Unlike the reference, :func:`gqa_decode` and :func:`mla_decode` write the
new cache entries in place (the caller's ring tensors are updated and
returned).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.cache import paged
from repro_torch.core import quantizers as qz
from repro_torch.dist import sharding as shd
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
    (B, H, Skv, D)``; returns ``(B, H, Sq, Dv)`` in ``q``'s dtype.  The
    ``constrain`` sites are the reference's, in its order."""
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
    q = shd.constrain(q, "D", "M", None, None)
    kc = shd.constrain(k.reshape(B, H, n_chunks, k_chunk, D).permute(2, 0, 1, 3, 4),
                       None, "D", "M", None, None)
    vc = shd.constrain(v.reshape(B, H, n_chunks, k_chunk, Dv).permute(2, 0, 1, 3, 4),
                       None, "D", "M", None, None)
    scale = 1.0 / math.sqrt(D)
    q_pos = q_offset + torch.arange(Sq, device=dev)
    q32 = q.to(torch.float32)
    m = shd.constrain(torch.full((B, H, Sq), -math.inf, dtype=torch.float32, device=dev),
                      "D", "M", None)
    d_sum = shd.constrain(torch.zeros((B, H, Sq), dtype=torch.float32, device=dev), "D", "M", None)
    acc = shd.constrain(torch.zeros((B, H, Sq, Dv), dtype=torch.float32, device=dev),
                        "D", "M", None, None)
    neg_inf = torch.full((), -math.inf, device=dev)
    zero = torch.zeros((), device=dev)
    for ci in range(n_chunks):
        kb, vb = kc[ci], vc[ci]
        if ci == 0:      # the reference's scan traces its body, and these sites, once
            kb = shd.constrain(kb, "D", "M", None, None)
            vb = shd.constrain(vb, "D", "M", None, None)
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
    out = acc / torch.maximum(d_sum, torch.full((), 1e-30, device=dev))[..., None]
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
# GQA for training: init and the full-sequence forward
# ---------------------------------------------------------------------------

def init_gqa(gen: torch.Generator, cfg, dtype=torch.float32, lead: tuple = ()) -> tuple:
    """``(params, nas)`` of one GQA attention block (``lead`` axes
    prepended: a stack of layers), drawn on ``gen``'s device."""
    d, hd = cfg.d_model, cfg.head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads
    params = {
        "wq": L.linear_init(gen, d, H * hd, cfg.qkv_bias, dtype, lead),
        "wk": L.linear_init(gen, d, KV * hd, cfg.qkv_bias, dtype, lead),
        "wv": L.linear_init(gen, d, KV * hd, cfg.qkv_bias, dtype, lead),
        "wo": L.linear_init(gen, H * hd, d, False, dtype, lead),
    }
    nas = {name: L.nas_init(p["w"].shape[-2], cfg.quant, gen.device, lead)
           for name, p in params.items()}
    return params, nas


def gqa_forward(p: dict, nas: Optional[dict], policy, cfg, x: torch.Tensor,
                positions: torch.Tensor, causal: bool = True,
                k_chunk: int = 1024) -> torch.Tensor:
    """Full-sequence GQA with RoPE under a training ``policy``: ``x (B, S,
    d)`` -> ``(B, S, d)`` in ``cfg.cdtype``; differentiable."""
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cd, pd = cfg.cdtype, L.partial_dtype_of(cfg)
    getn = (lambda n: nas[n]) if nas is not None else (lambda n: None)

    def lin(name, t):
        return L.qlinear(t, p[name], getn(name), policy, cfg.quant, compute_dtype=cd,
                         partial_dtype=pd)

    q = shd.constrain(lin("wq", x).reshape(B, S, H, hd), "D", None, "M", None)
    k = shd.constrain(lin("wk", x).reshape(B, S, KV, hd), "D", None, "M", None)
    v = shd.constrain(lin("wv", x).reshape(B, S, KV, hd), "D", None, "M", None)
    if cfg.rope_partial > 0:
        cos, sin, rot = L.rope_freqs(hd, cfg.rope_theta, positions, cfg.rope_partial)
        q = L.apply_rope(q, cos, sin, rot)
        k = L.apply_rope(k, cos, sin, rot)
    o = gqa_core(q, k, v, H, KV, causal, k_chunk=k_chunk)
    return lin("wo", o.reshape(B, S, H * hd))


def cross_forward(p: dict, nas: Optional[dict], policy, cfg, x: torch.Tensor,
                  enc: torch.Tensor, k_chunk: int = 1024) -> torch.Tensor:
    """Whisper's decoder cross-attention under a training ``policy``: the
    queries from ``x (B, S, d)``, the keys and values from the encoded
    frames ``enc (B, Se, d)``, no rope, no causal mask -> ``(B, S, d)`` in
    ``cfg.cdtype``; differentiable."""
    B, S, _ = x.shape
    Se = enc.shape[1]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cd, pd = cfg.cdtype, L.partial_dtype_of(cfg)
    getn = (lambda n: nas[n]) if nas is not None else (lambda n: None)

    def lin(name, t):
        return L.qlinear(t, p[name], getn(name), policy, cfg.quant, compute_dtype=cd,
                         partial_dtype=pd)

    q = lin("wq", x).reshape(B, S, H, hd)
    k = lin("wk", enc).reshape(B, Se, KV, hd)
    v = lin("wv", enc).reshape(B, Se, KV, hd)
    o = gqa_core(q, k, v, H, KV, causal=False, k_chunk=k_chunk)
    return lin("wo", o.reshape(B, S, H * hd))


def init_mla(gen: torch.Generator, cfg, dtype=torch.float32, lead: tuple = ()) -> tuple:
    """``(params, nas)`` of one MLA block (``lead`` axes prepended): the
    query's and the KV latent's down and up projections, ``wo``, and the
    latents' RMS norms."""
    d, H = cfg.d_model, cfg.n_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    params = {
        "wq_a": L.linear_init(gen, d, qr, False, dtype, lead),
        "wq_b": L.linear_init(gen, qr, H * (nope + rope), False, dtype, lead),
        "wkv_a": L.linear_init(gen, d, kvr + rope, False, dtype, lead),
        "wkv_b": L.linear_init(gen, kvr, H * (nope + vd), False, dtype, lead),
        "wo": L.linear_init(gen, H * vd, d, False, dtype, lead),
    }
    nas = {name: L.nas_init(p["w"].shape[-2], cfg.quant, gen.device, lead)
           for name, p in params.items()}
    params["q_norm"] = L.norm_init(qr, "rmsnorm", dtype, gen.device, lead)
    params["kv_norm"] = L.norm_init(kvr, "rmsnorm", dtype, gen.device, lead)
    return params, nas


def mla_forward(p: dict, nas: Optional[dict], policy, cfg, x: torch.Tensor,
                positions: torch.Tensor, k_chunk: int = 1024) -> torch.Tensor:
    """Full-sequence MLA under a training ``policy``: the latents expanded
    to per-head keys and values, ``x (B, S, d)`` -> ``(B, S, d)`` in
    ``cfg.cdtype``; differentiable.  The rotary halves are f32 (the tables
    promote a bf16 input), so the concatenated query and key are f32, as in
    the reference; the one rotary key head is broadcast to every head (an
    ``expand``: its gradient sums over the heads)."""
    B, S, _ = x.shape
    H = cfg.n_heads
    nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank
    cd, pd = cfg.cdtype, L.partial_dtype_of(cfg)
    getn = (lambda n: nas[n]) if nas is not None else (lambda n: None)

    def lin(name, t):
        return L.qlinear(t, p[name], getn(name), policy, cfg.quant, compute_dtype=cd,
                         partial_dtype=pd)

    cq = L.rmsnorm(lin("wq_a", x), p["q_norm"])
    q = lin("wq_b", cq).reshape(B, S, H, nope + rope)
    ckv = lin("wkv_a", x)
    c_kv = L.rmsnorm(ckv[..., :kvr], p["kv_norm"])
    kv = lin("wkv_b", c_kv).reshape(B, S, H, nope + vd)
    cos, sin, rot = L.rope_freqs(rope, cfg.rope_theta, positions, 1.0)
    q_rope = L.apply_rope(q[..., nope:], cos, sin, rot)
    k_rope = L.apply_rope(ckv[..., kvr:][:, :, None, :], cos, sin, rot)
    q_full = torch.cat([q[..., :nope].to(q_rope.dtype), q_rope], dim=-1)
    k_full = torch.cat([kv[..., :nope].to(k_rope.dtype), k_rope.expand(B, S, H, rope)],
                       dim=-1)
    o = gqa_core(q_full, k_full, kv[..., nope:], H, H, causal=True, k_chunk=k_chunk)
    return lin("wo", o.reshape(B, S, H * vd))


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
    """Per-slot ring-write index (``pos (B,)``, or ``(B, W)`` for W entries
    a slot): dead slots write out of bounds (at ``max_len``), which the
    writers drop."""
    pos = pos.to(torch.int64)
    if live is None:
        return pos
    live = live.reshape(live.shape + (1,) * (pos.ndim - 1))
    return torch.where(live, pos, torch.full_like(pos, max_len))


def _ring_write(ring: torch.Tensor, wpos: torch.Tensor, new: torch.Tensor) -> None:
    """``ring[b, :, wpos[b, j]] = new[b, j]`` in place for every entry
    whose ``wpos`` lies in the ring (``wpos (B, W)``, ``new (B, W, KV,
    F)``); the others are dropped (the reference's ``mode="drop"``).  No
    host sync: a dropped entry is sent to the ring's edge and carries the
    value that position ends with (the write that lands there, else what
    it holds), so the duplicate indices of one scatter all write the same
    value (a scatter's duplicates land in no set order on the card)."""
    B, S = ring.shape[0], ring.shape[2]
    keep = (wpos >= 0) & (wpos < S)
    at = torch.clamp(wpos, 0, S - 1)
    hit = keep[:, None, :] & (wpos[:, None, :] == at[:, :, None])   # (B, W, W): j' lands at j's
    src = torch.argmax(hit.to(torch.int8), dim=-1)                  # (B, W)
    bidx = torch.arange(B, device=ring.device)[:, None]
    old = ring[bidx, :, at]                                         # (B, W, KV, F)
    landing = new.to(ring.dtype)[bidx, src]
    ring[bidx, :, at] = torch.where(hit.any(-1)[..., None, None], landing, old)


def _write_and_read(cache: dict, keys: tuple, new: tuple, pos, live, pages, page_size,
                    mid: bool, row: int = 0) -> tuple:
    """Write each leaf's new entries (``new[i]`` of ``(B, W, [KV,] F)``
    into ``cache[keys[i]]``) at the slots' positions ``pos (B, W)``, in
    place, and return the leaves as per-slot rings: the dense rings
    themselves, or with ``pages`` the pools written through the page table
    and gathered back.  ``mid``: the leaves carry the KV-head axis before
    the ring axis.  Pools on the data rows (``row``'s slots' entries and
    table): each entry written into, and each page read from, the row that
    owns it (``paged.RowRoute``)."""
    if pages is None:
        S = cache[keys[0]].shape[2 if mid else 1]
        wpos = slot_write_pos(pos, live, S)
        for key, t in zip(keys, new):
            _ring_write(cache[key] if mid else cache[key].unsqueeze(1), wpos,
                        t if mid else t[:, :, None])
        return tuple(cache[k] for k in keys)
    phys, off = paged.write_coords(pos, live, pages, page_size, cache[keys[0]].shape[0])
    if isinstance(cache[keys[0]], shd.Rows):
        route = paged.RowRoute(cache[keys[0]], row, phys, off, pages)
        for key, t in zip(keys, new):
            route.write(cache[key], t)
        return tuple(route.gather(cache[k]) for k in keys)
    for key, t in zip(keys, new):
        paged.write_pages(cache[key], phys, off, t)
    return tuple(paged.gather_pages(cache[k], pages) for k in keys)


def _row_cache(cache: dict, keys: tuple, r: int, paged_: bool) -> dict:
    """Row ``r``'s view of a cache on the data rows: its slot blocks of the
    dense leaves, or the page pools as they are (the route finds each
    page's row)."""
    return {k: cache[k] if paged_ else cache[k].row(r) for k in keys}


def _on(t, sl, dev):
    """Rows ``sl`` of ``t`` (None stays None) on ``dev``."""
    return None if t is None else t[sl].to(dev)


def gqa_decode(p: dict, cfg, x: torch.Tensor, cache: dict, pos: torch.Tensor,
               dq_linear, live: Optional[torch.Tensor] = None,
               kv_spec: Optional[kvq.KVQuantSpec] = None,
               backend: str = "cuda", pages: Optional[torch.Tensor] = None,
               page_size: Optional[int] = None) -> tuple:
    """Cached decode over a ring cache, per-slot positions.

    ``x (B, W, d)``: ``W`` is 1 in a decode step; ``W > 1`` is the
    speculative verify (the reference's ``_gqa_decode_multi``), row ``b``'s
    token ``j`` at position ``pos[b] + j``.  ``pos (B,)`` int: row ``b``
    writes its new KV at ring index ``pos[b]`` (``pos[b] .. pos[b] + W - 1``)
    and query ``j`` attends to ``<= pos[b] + j``; ``live (B,)`` bool: rows
    with ``live=False`` drop their ring writes, and writes past the ring or
    the mapped pages are dropped.  All ``W`` entries land in one scatter
    first; entries past what a round accepts are never undone, the ``<=
    pos`` mask hides them until later writes overwrite them.  Attention
    then runs ``W`` single-query steps whose operands are those of ``W``
    sequential one-token decodes (one decode-attention launch each), so
    the verify's rows are theirs.  ``dq_linear`` applies a deployed
    linear.  ``kv_spec``: the channel-wise packed ring of
    ``init_gqa_cache(..., spec=kv_spec)``; with ``backend="cuda"`` it is
    attended through the decode-attention kernel (on CPU tensors, its
    plain version), otherwise through the dequantized ring.  ``pages (B,
    P)``: the leaves are page pools ``(num_pages, KV, page_size, F)``;
    position ``t`` of row ``b`` lives in page ``pages[b, t // page_size]``
    and attention reads the gathered ``(B, KV, P * page_size, F)`` ring.
    Writes ``cache`` in place and returns ``(y (B, W, d), cache)``.
    """
    B, W = x.shape[:2]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    posk = _positions(pos, B, W, x.device)                             # (B, W)
    q = dq_linear(x, p["wq"]).reshape(B, W, H, hd)
    k = dq_linear(x, p["wk"]).reshape(B, W, KV, hd)
    v = dq_linear(x, p["wv"]).reshape(B, W, KV, hd)
    if cfg.rope_partial > 0:
        cos, sin, rot = L.rope_freqs(hd, cfg.rope_theta, posk, cfg.rope_partial)
        q = L.apply_rope(q, cos, sin, rot)
        k = L.apply_rope(k, cos, sin, rot)
    if kv_spec is None:
        kq, ks = quant_per_token(k.transpose(1, 2))          # (B, KV, W, hd)
        vq, vs = quant_per_token(v.transpose(1, 2))
    else:
        kq, ks = kvq.quant_channelwise(k.transpose(1, 2), kv_spec)
        vq, vs = kvq.quant_channelwise(v.transpose(1, 2), kv_spec)
    new = tuple(t.transpose(1, 2) for t in (kq, vq, ks, vs))
    keys = ("k", "v", "k_scale", "v_scale")
    rows = shd.row_work(cache["k"], B)
    if rows is None:
        o = _gqa_attend(cfg, cache, keys, new, q, posk, live, pages, page_size, kv_spec, backend)
    else:                           # the cache-bound work on each data row, over its slots
        o = shd.replicate_serving([
            _gqa_attend(cfg, _row_cache(cache, keys, r, pages is not None), keys,
                        tuple(t[sl].to(dev) for t in new), q[sl].to(dev), posk[sl].to(dev),
                        _on(live, sl, dev), _on(pages, sl, dev), page_size, kv_spec, backend,
                        row=r, plan_slots=B)
            for r, sl, dev in rows])
    return dq_linear(o, p["wo"]), cache


def _gqa_attend(cfg, cache, keys, new, q, posk, live, pages, page_size, kv_spec, backend,
                row: int = 0, plan_slots: Optional[int] = None) -> torch.Tensor:
    """The cache-bound half of :func:`gqa_decode` over one set of slots:
    the ring write, the read (the page gather) and the ``W`` single-query
    attention steps -> ``(B, W, H * hd)`` before ``wo``.  ``plan_slots``:
    the whole batch's slots, when these are a data row's: K4 (a packed ring
    under ``"cuda"``) plans its ring split for them, and the dequantized
    attention's products run padded to them (``sharding.pad_rows``), so
    that the row's results are bitwise its slice of the whole batch's."""
    B, W = q.shape[:2]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cd = cfg.cdtype
    ki, vi, ksc, vsc = _write_and_read(cache, keys, new, posk, live, pages, page_size,
                                       mid=True, row=row)
    rep = H // KV
    kernel = kv_spec is not None and backend == "cuda"
    if not kernel:
        if kv_spec is None:
            kf = (ki.to(torch.float32) * ksc).to(cd)
            vf = (vi.to(torch.float32) * vsc).to(cd)
        else:
            kf = kvq.dequant_channelwise(ki, ksc, kv_spec, cd)
            vf = kvq.dequant_channelwise(vi, vsc, kv_spec, cd)
    outs = []
    for j in range(W):
        qg = q[:, j:j + 1].transpose(1, 2).reshape(B, KV, rep, hd)   # its dtype (f32 after RoPE)
        if kernel:
            qg = qg.contiguous()                  # a strided view when W > 1
            o = datt.decode_attention(qg, ki, ksc, vi, vsc, posk[:, j].contiguous(), kv_spec.bits,
                                      kv_spec.sizes, out_dtype=cd, plan_slots=plan_slots)
        else:
            o = datt.attend(*(shd.pad_rows(t, plan_slots) for t in (qg, kf, vf, posk[:, j])),
                            cd)[:B]
        outs.append(o.reshape(B, 1, H * hd))
    return torch.cat(outs, dim=1) if W > 1 else outs[0]


def _positions(pos, B: int, W: int, device) -> torch.Tensor:
    """``(B, W)`` int32 positions ``pos[b] + j`` of a decode's tokens
    (``pos`` a ``(B,)`` vector or a scalar for every slot)."""
    pos = torch.as_tensor(pos, device=device).to(torch.int32)
    if pos.ndim == 0:
        pos = pos.expand(B)
    return pos[:, None] + torch.arange(W, dtype=torch.int32, device=device)[None]


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
               kv_spec: Optional[kvq.KVQuantSpec] = None,
               pages: Optional[torch.Tensor] = None,
               page_size: Optional[int] = None) -> tuple:
    """Cached MLA decode over a ring cache, per-slot positions.

    ``x (B, W, d)``: ``W`` is 1 in a decode step; ``W > 1`` is the
    speculative verify (the reference's ``_mla_decode_multi``), row ``b``'s
    token ``j`` at position ``pos[b] + j``.  ``pos (B,)``: row ``b`` writes
    its latents at ring indices ``pos[b] .. pos[b] + W - 1`` and query ``j``
    attends to ``<= pos[b] + j``; ``live=False`` rows drop their writes,
    and so do writes past the ring or the mapped pages.  The ``W`` latents
    land in one scatter.  Then the cached latents of every slot are
    dequantized and expanded to per-head keys and values through the packed
    ``wkv_b`` linear, once over the whole ring (``dq_linear``; on the kernel
    path the fused GEMM over all ``B * S`` cached latents, as in a decode
    step), and ``W`` single-query steps attend: the score dots summed in f32
    (bf16 operands, no bf16 rounding, as XLA folds the reference's cast),
    divided by ``sqrt(nope + rope)``, an f32 softmax rounded to the compute
    dtype, the value dot rounded once.  ``pages (B, P)``: the leaves are
    page pools ``(num_pages, page_size, F)`` written and read through the
    page table, as in :func:`gqa_decode`.  Writes ``cache`` in place and
    returns ``(y (B, W, d), cache)``.
    """
    B, W = x.shape[:2]
    H = cfg.n_heads
    nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank
    posk = _positions(pos, B, W, x.device)                             # (B, W)

    cq = L.rmsnorm(dq_linear(x, p["wq_a"]), p["q_norm"])
    q = dq_linear(cq, p["wq_b"]).reshape(B, W, H, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    ckv_new = dq_linear(x, p["wkv_a"])
    c_kv, k_rope_new = ckv_new[..., :kvr], ckv_new[..., kvr:]
    c_kv = L.rmsnorm(c_kv, p["kv_norm"])
    cos, sin, rot = L.rope_freqs(rope, cfg.rope_theta, posk, 1.0)
    q_rope = L.apply_rope(q_rope, cos, sin, rot)
    k_rope_new = L.apply_rope(k_rope_new[:, :, None, :], cos, sin, rot)[:, :, 0]

    if kv_spec is None:
        qc, qs = quant_per_token(c_kv)                       # (B, W, kvr), (B, W, 1)
    else:
        qc, qs = kvq.quant_channelwise(c_kv, kv_spec)
    new = (qc, qs, k_rope_new.to(torch.bfloat16))
    keys = ("ckv", "ckv_scale", "krope")
    rows = shd.row_work(cache["ckv"], B)
    if rows is None:
        o = _mla_attend(p, cfg, cache, keys, new, q_nope, q_rope, posk, live, pages, page_size,
                        kv_spec, dq_linear)
    else:                           # the cache-bound work on each data row, over its slots
        o = shd.replicate_serving([
            _mla_attend(shd.row_params(p, r), cfg, _row_cache(cache, keys, r, pages is not None),
                        keys, tuple(t[sl].to(dev) for t in new), q_nope[sl].to(dev),
                        q_rope[sl].to(dev), posk[sl].to(dev), _on(live, sl, dev),
                        _on(pages, sl, dev), page_size, kv_spec, dq_linear, row=r,
                        plan_slots=B)
            for r, sl, dev in rows])
    return dq_linear(o, p["wo"]), cache


def _mla_attend(p, cfg, cache, keys, new, q_nope, q_rope, posk, live, pages, page_size,
                kv_spec, dq_linear, row: int = 0, plan_slots: Optional[int] = None) -> torch.Tensor:
    """The cache-bound half of :func:`mla_decode` over one set of slots:
    the latent write and read, the latents' dequantization, their
    expansion through ``p["wkv_b"]`` (K1 on the kernel path, over these
    slots' ``B * S`` latents: its sums do not depend on the rows' count)
    and the ``W`` single-query attention steps -> ``(B, W, H * vd)``
    before ``wo``.  ``plan_slots``: the whole batch's slots, when these are
    a data row's: the attention's products run padded to them
    (``sharding.pad_rows``), bitwise the whole batch's rows."""
    B, W = q_nope.shape[:2]
    H = cfg.n_heads
    nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    cd = cfg.cdtype
    # dense: the (B, S, F) rings seen as (B, 1, S, F), one "kv-head" of the GQA writer
    ckv_i, ckv_s, krope_i = _write_and_read(cache, keys, new, posk, live, pages, page_size,
                                            mid=False, row=row)
    S = ckv_i.shape[1]
    if kv_spec is None:
        ckv_f = (ckv_i.to(torch.float32) * ckv_s).to(cd)
    else:
        ckv_f = kvq.dequant_channelwise(ckv_i, ckv_s, kv_spec, cd)
    kv = dq_linear(ckv_f, p["wkv_b"]).reshape(B, S, H, nope + vd)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    f32 = torch.float32
    k_nope32, krope32, v32, q_nope, q_rope, posk = (shd.pad_rows(t, plan_slots) for t in (
        k_nope.to(cd).to(f32), krope_i.to(cd).to(f32), v.to(cd).to(f32), q_nope, q_rope, posk))
    dev = q_nope.device
    ring = torch.arange(S, device=dev)[None, None, None, :]
    outs = []
    for j in range(W):
        s = torch.einsum("bqhn,bkhn->bhqk", q_nope[:, j:j + 1].to(cd).to(f32), k_nope32)
        s = s + torch.einsum("bqhr,bkr->bhqk", q_rope[:, j:j + 1].to(cd).to(f32), krope32)
        s = qz.over(s, math.sqrt(nope + rope))
        valid = ring <= posk[:, j, None, None, None]
        s = torch.where(valid, s, torch.full((), -math.inf, device=dev))
        e = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
        w = (e / torch.sum(e, dim=-1, keepdim=True)).to(cd)
        o = torch.einsum("bhqk,bkhv->bqhv", w.to(f32), v32).to(cd)[:B]
        outs.append(o.reshape(B, 1, H * vd))
    return torch.cat(outs, dim=1) if W > 1 else outs[0]
