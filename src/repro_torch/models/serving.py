"""Deployed language-model serving: packed mixed-precision weights and
quantized KV caches, the dense GQA family.

Counterpart of the dense part of ``repro.models.serving``.  Each linear of
the model is a :class:`~repro_torch.api.qtensor.QTensor` with the config's
static channel-group sizes (``DeploySpec``), packed sub-byte; at full width
(c_in above ``K_SINGLE_STEP_MAX``) every linear runs the per-group kernel,
one launch per precision group.  Decode streams the packed weight bytes, so
the bits a channel is given set the decode bandwidth.

A deployed linear is ``{"w": QTensor[, "bias": (c_out,) bf16]}``; the model
is ``{"embed", "blocks": [per-layer dicts], "ln_f", "lm_head"}``.  Caches are
stacked per layer: ``{"k", "v", "k_scale", "v_scale"}`` each
``(n_layers, B, KV, S, F)``.  PyTorch runs eagerly: the layer loops are
Python loops, and :func:`decode_step` updates the caches in place.

Backends: ``"cuda"`` (the kernels, and the decode-attention kernel over a
packed cache), ``"cuda-pergroup"`` and ``"torch"`` (plain PyTorch), as in
:class:`QTensor`.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.api.engine import resolve_device
from repro_torch.api.qtensor import QTensor, _auto_tile_n
from repro_torch.core import quantizers as qz
from repro_torch.models import attention as attn
from repro_torch.models import kv_quant as kvq
from repro_torch.models import layers as L

CACHE_KEYS = ("k", "v", "k_scale", "v_scale")


def _dense_only(cfg) -> None:
    if cfg.family != "dense" or cfg.use_mla or cfg.mlp_type != "swiglu":
        raise NotImplementedError(
            f"{cfg.name}: only the dense GQA family with a SwiGLU MLP is "
            "ported so far (ROADMAP.md queue 1 item 5 ports the others)")


# ---------------------------------------------------------------------------
# Deployed linear: init (static assignment from DeploySpec) and apply
# ---------------------------------------------------------------------------

def init_deployed_linear(gen: torch.Generator, c_in: int, c_out: int, cfg,
                         bias: bool = False, tile_n="auto", device=None) -> dict:
    """Random-weight deployed linear with the config's static group sizes.

    Weights are drawn from ``gen`` on ``device`` (``N(0, 1/c_in)``) and
    truly quantized and packed, group by group; static assignments are
    group-contiguous, so no permutation is carried.  ``tile_n="auto"``
    also builds the fused single-launch layout (where the contraction fits
    ``K_SINGLE_STEP_MAX``), with a tile no wider than the group
    alignment.  Built by :meth:`QTensor.from_codes`, the port's one builder.
    """
    sizes = cfg.deploy.group_sizes(c_out, sorted(cfg.quant.weight_bits))
    if tile_n == "auto":
        # group sizes are align-rounded, so an align-divisible tile keeps
        # the walk order the identity (no output gather) for most layers
        tile_n = min(_auto_tile_n(c_out), cfg.deploy.align)
    groups = []
    for b, n in sizes.items():
        if n == 0:
            continue
        w = torch.randn((n, c_in), generator=gen, device=device) / math.sqrt(c_in)
        alpha = torch.amax(torch.abs(w), dim=-1, keepdim=True)
        q, scale = qz.quantize_weight_int(w, alpha, b)
        groups.append((b, q, scale[:, 0]))
    out = {"w": QTensor.from_codes(groups, c_in, tile_n=tile_n,
                                   act_bits=cfg.deploy.act_bits)}
    if bias:
        out["bias"] = torch.zeros((c_out,), dtype=torch.bfloat16, device=device)
    return out


def dq_linear(x: torch.Tensor, dp: dict, compute_dtype=torch.bfloat16,
              backend: str = "cuda") -> torch.Tensor:
    """Apply a deployed linear: ``x (..., c_in) -> (..., c_out)`` in
    ``compute_dtype``, plus the optional bias."""
    y = dp["w"].matmul(x, backend, compute_dtype)
    if "bias" in dp:
        y = y + dp["bias"].to(y.dtype)
    return y


def _init_deployed_attn(gen, cfg, device):
    d, hd = cfg.d_model, cfg.head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads

    def dl(c_in, c_out, bias=False):
        return init_deployed_linear(gen, c_in, c_out, cfg, bias=bias, device=device)
    return {"wq": dl(d, H * hd, cfg.qkv_bias), "wk": dl(d, KV * hd, cfg.qkv_bias),
            "wv": dl(d, KV * hd, cfg.qkv_bias), "wo": dl(H * hd, d)}


def _init_deployed_ffn(gen, cfg, device):
    d = cfg.d_model

    def dl(c_in, c_out):
        return init_deployed_linear(gen, c_in, c_out, cfg, device=device)
    return {"w_gate": dl(d, cfg.d_ff), "w_up": dl(d, cfg.d_ff), "w_down": dl(cfg.d_ff, d)}


def _init_deployed_block(gen, cfg, device):
    return {"attn": _init_deployed_attn(gen, cfg, device),
            "ffn": _init_deployed_ffn(gen, cfg, device),
            "ln1": L.norm_init(cfg.d_model, cfg.norm, torch.bfloat16, device),
            "ln2": L.norm_init(cfg.d_model, cfg.norm, torch.bfloat16, device)}


def init_deployed_model(cfg, seed: int = 0, device=None) -> dict:
    """Random deployed model of ``cfg`` at its own width and depth, drawn
    from one ``torch.Generator`` seeded with ``seed`` on ``device`` (the
    card by default; it must exist)."""
    _dense_only(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    embed = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen, device=device)
    params = {"embed": (embed * 0.02).to(torch.bfloat16)}
    del embed
    params["blocks"] = [_init_deployed_block(gen, cfg, device) for _ in range(cfg.n_layers)]
    params["ln_f"] = L.norm_init(cfg.d_model, cfg.norm, torch.bfloat16, device)
    params["lm_head"] = init_deployed_linear(gen, cfg.d_model, cfg.vocab_size, cfg,
                                             device=device)
    return params


# ---------------------------------------------------------------------------
# Serving forward passes
# ---------------------------------------------------------------------------

def _dq(cd, backend):
    return lambda x, dp: dq_linear(x, dp, cd, backend)


def kv_specs(cfg, kv_bits) -> Optional[kvq.KVQuantSpec]:
    """The GQA rings' channel-group spec for the ``kv_bits`` cache policy
    (``None``: the int8-per-token cache).  Raises at resolution time (engine
    construction) when ``head_dim`` cannot take the packing."""
    if kv_bits is None:
        return None
    _dense_only(cfg)
    return kvq.spec_for(kv_bits, cfg.head_dim)


def _deployed_attn_full(p, cfg, x, positions, causal=True, backend="cuda",
                        build_cache=False, kv_spec=None):
    """Full-sequence attention on deployed weights; optionally emits the
    sequence's quantized cache (int8 per token, or packed under
    ``kv_spec``), ``(B, KV, S, F)`` per leaf."""
    B, S, _ = x.shape
    dq = _dq(cfg.cdtype, backend)
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = dq(x, p["wq"]).reshape(B, S, H, hd)
    k = dq(x, p["wk"]).reshape(B, S, KV, hd)
    v = dq(x, p["wv"]).reshape(B, S, KV, hd)
    if cfg.rope_partial > 0:
        cos, sin, rot = L.rope_freqs(hd, cfg.rope_theta, positions, cfg.rope_partial)
        q = L.apply_rope(q, cos, sin, rot)
        k = L.apply_rope(k, cos, sin, rot)
    o = attn.gqa_core(q, k, v, H, KV, causal=causal)
    y = dq(o.reshape(B, S, H * hd), p["wo"])
    cache = None
    if build_cache:
        if kv_spec is None:
            kq, ksc = attn.quant_per_token(k.transpose(1, 2))
            vq, vsc = attn.quant_per_token(v.transpose(1, 2))
        else:
            kq, ksc = kvq.quant_channelwise(k.transpose(1, 2), kv_spec)
            vq, vsc = kvq.quant_channelwise(v.transpose(1, 2), kv_spec)
        cache = {"k": kq, "v": vq, "k_scale": ksc, "v_scale": vsc}
    return y, cache


def _deployed_ffn_full(p, cfg, x, backend="cuda"):
    dq = _dq(cfg.cdtype, backend)
    return dq(L.swiglu(dq(x, p["w_gate"]), dq(x, p["w_up"])), p["w_down"])


def _last_token(x, lens):
    """Per-row last real token of a right-padded batch: ``(B, S, d) ->
    (B, 1, d)``; ``lens=None`` takes the last position."""
    if lens is None:
        return x[:, -1:]
    idx = (torch.clamp_min(lens, 1) - 1).to(torch.int64).to(x.device)
    return x[torch.arange(x.shape[0], device=x.device), idx][:, None]


def block_forward(p, cfg, h, positions, backend="cuda", kv_spec=None):
    """One decoder block over a full sequence: ``(h', cache)``."""
    hn = L.apply_norm(h, p["ln1"], cfg.norm)
    a, c = _deployed_attn_full(p["attn"], cfg, hn, positions, backend=backend,
                               build_cache=True, kv_spec=kv_spec)
    h = h + a.to(h.dtype)
    f = _deployed_ffn_full(p["ffn"], cfg, L.apply_norm(h, p["ln2"], cfg.norm), backend)
    return h + f.to(h.dtype), c


def prefill(dparams, cfg, batch, backend: str = "cuda", lens=None, kv_bits=None):
    """Full-sequence deployed forward: ``(last-token logits (B, 1, V) f32,
    caches)``.

    ``batch["tokens"] (B, S)``; ``lens`` (B,) the true prompt lengths of a
    right-padded batch: logits are taken at each row's last real token.
    The caches also hold entries for the padded tail, above each slot's
    position: decode masks ``<= pos`` and overwrites index ``lens`` first,
    so they are never attended.  ``kv_bits``: the cache policy
    (:func:`kv_specs`), the same one ``init_caches``/``decode_step`` take.
    """
    _dense_only(cfg)
    cd = cfg.cdtype
    spec = kv_specs(cfg, kv_bits)
    tokens = batch["tokens"]
    x = dparams["embed"][tokens].to(cd)
    positions = torch.arange(x.shape[1], device=x.device)
    per_layer = []
    for p in dparams["blocks"]:
        x, c = block_forward(p, cfg, x, positions, backend, spec)
        per_layer.append(c)
    caches = {k: torch.stack([c[k] for c in per_layer]) for k in CACHE_KEYS}
    x = L.apply_norm(x, dparams["ln_f"], cfg.norm)
    logits = dq_linear(_last_token(x, lens), dparams["lm_head"], cd, backend)
    return logits.to(torch.float32), caches


def init_caches(cfg, batch: int, max_len: int, kv_bits=None, device=None) -> dict:
    """Empty ring caches on ``device`` (the card by default; it must
    exist), stacked per layer: ``(n_layers, batch, KV, max_len, F)`` per
    leaf; ``kv_bits`` packs them channel-wise."""
    _dense_only(cfg)
    device = resolve_device(device)
    one = attn.init_gqa_cache(cfg, batch, max_len, kv_specs(cfg, kv_bits), device="meta")
    return {k: torch.zeros((cfg.n_layers,) + tuple(t.shape), dtype=t.dtype, device=device)
            for k, t in one.items()}


def embed_caches(prefill_caches: dict, ring: dict) -> dict:
    """Right-pad the S-deep prefill caches along the sequence axis to the
    ring's shape (zero padding is the empty-slot convention: decode masks
    by position)."""
    out = {}
    for k, pc in prefill_caches.items():
        full = ring[k]
        diff = [i for i, (a, b) in enumerate(zip(pc.shape, full.shape)) if a != b]
        if len(diff) > 1:
            raise ValueError(f"{k}: prefill {tuple(pc.shape)} vs ring {tuple(full.shape)}")
        if diff:
            widths = [0, 0] * pc.ndim
            widths[2 * (pc.ndim - 1 - diff[0]) + 1] = full.shape[diff[0]] - pc.shape[diff[0]]
            pc = torch.nn.functional.pad(pc, widths)
        out[k] = pc.to(full.dtype)
    return out


def decode_block(p, cfg, h, cache, pos, live=None, kv_spec=None, backend="cuda"):
    """One decoder block of a decode step over its layer's ring ``cache``
    (written in place): ``h (B, 1, d) -> h'``."""
    hn = L.apply_norm(h, p["ln1"], cfg.norm)
    a, _ = attn.gqa_decode(p["attn"], cfg, hn, cache, pos, _dq(cfg.cdtype, backend),
                           live, kv_spec, backend)
    h = h + a.to(h.dtype)
    f = _deployed_ffn_full(p["ffn"], cfg, L.apply_norm(h, p["ln2"], cfg.norm), backend)
    return h + f.to(h.dtype)


def decode_step(dparams, cfg, tokens, caches, pos, backend: str = "cuda",
                live=None, kv_bits=None):
    """One decode step: ``tokens (B, 1) -> (logits (B, 1, V) f32, caches)``.

    ``pos (B,)``: row ``b`` writes its new cache entry at ring index
    ``pos[b]`` and attends to ``<= pos[b]``; a scalar broadcasts.  ``live
    (B,)`` bool: rows with ``live=False`` leave the caches untouched (their
    logits are garbage).  ``kv_bits`` must be the policy the caches were
    built with; with a packed cache and ``backend="cuda"`` attention runs
    the decode-attention kernel, once per layer.  The caches are updated
    in place and returned.
    """
    _dense_only(cfg)
    spec = kv_specs(cfg, kv_bits)
    cd = cfg.cdtype
    x = dparams["embed"][tokens].to(cd)
    B = tokens.shape[0]
    pos = torch.as_tensor(pos, device=x.device).to(torch.int32)
    if pos.ndim == 0:
        pos = pos.expand(B).contiguous()
    if live is not None:
        live = torch.as_tensor(live, device=x.device)
    for layer, p in enumerate(dparams["blocks"]):
        x = decode_block(p, cfg, x, {k: caches[k][layer] for k in CACHE_KEYS},
                         pos, live, spec, backend)
    x = L.apply_norm(x, dparams["ln_f"], cfg.norm)
    logits = dq_linear(x, dparams["lm_head"], cd, backend)
    return logits.to(torch.float32), caches
