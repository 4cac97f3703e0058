"""Deployed language-model serving: packed mixed-precision weights and
quantized KV caches, for the dense GQA family (and the VLM, whose prompt
starts with image patch embeddings), the MoE family (GQA or MLA attention,
arctic's dense residual MLP), the SSM family (Mamba2) and the hybrid
(Mamba2 layers with one shared attention block).

Counterpart of ``repro.models.serving`` but for the audio family.  Each
linear of the model is a :class:`~repro_torch.api.qtensor.QTensor` with the
config's static channel-group sizes (``DeploySpec``), packed sub-byte; a
linear whose contraction fits ``K_SINGLE_STEP_MAX`` also carries the fused
layout and runs ONE launch of the fused kernel, a deeper one runs the
per-group kernel, one launch per precision group.  MoE expert weights are
expert stacks (a leading expert axis on every tensor): a fused stack runs
ONE launch of the expert kernel for all experts, a deeper one the
per-group kernel once per group over all experts.  Decode streams the
packed weight bytes, so the bits a channel is given set the decode
bandwidth.

A deployed linear is ``{"w": QTensor[, "bias": (c_out,) bf16]}``; the model
is ``{"embed", "blocks": [per-layer dicts], "ln_f", "lm_head"}``, and the
hybrid's one ``"shared_attn"`` block beside them.  Caches are stacked per
layer in one flat dict with the family's keys (:func:`cache_keys`): GQA
rings ``{"k", "v", "k_scale", "v_scale"}`` each ``(n_layers, B, KV, S, F)``,
MLA rings ``{"ckv", "ckv_scale", "krope"}`` each ``(n_layers, B, S, F)``,
the SSM state ``{"ssm_h" (n_layers, B, H, P, N), "ssm_conv" (n_layers, B,
CONV_K - 1, C)}``; the hybrid's GQA rings are stacked per group of
``attn_every`` layers (one a shared-block application).
PyTorch runs eagerly: the layer loops are Python loops, and
:func:`decode_step` updates the caches in place.

Backends: ``"cuda"`` (the kernels, and the decode-attention kernel over a
packed GQA cache), ``"cuda-pergroup"`` and ``"torch"`` (plain PyTorch), as
in :class:`QTensor`.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.api.engine import resolve_device
from repro_torch.api.qtensor import QTensor, _auto_tile_n
from repro_torch.core import quantizers as qz
from repro_torch.kernels import quant_matmul as qmk
from repro_torch.models import attention as attn
from repro_torch.models import kv_quant as kvq
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod

GQA_CACHE_KEYS = ("k", "v", "k_scale", "v_scale")
MLA_CACHE_KEYS = ("ckv", "ckv_scale", "krope")
SSM_CACHE_KEYS = ("ssm_h", "ssm_conv")          # ssm_mod.init_ssm_cache's "h", "conv"
ATTN_FAMILIES = ("dense", "vlm", "moe")


def _check_ported(cfg) -> None:
    """Raise, naming what is missing, unless the port serves ``cfg``: the
    dense, VLM, MoE, SSM and hybrid families with SwiGLU MLPs."""
    missing = []
    if cfg.family not in ATTN_FAMILIES + ("ssm", "hybrid"):
        missing.append(f"the {cfg.family} family (audio encoder-decoder serving)")
    if cfg.mlp_type != "swiglu":
        missing.append(f"{cfg.mlp_type} MLPs")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet (ROADMAP.md queue 1 item 5)")


def cache_keys(cfg) -> tuple:
    """The keys of the family's caches: MLA's latent ring, GQA's ring, the
    SSM state, or the hybrid's SSM state and GQA rings."""
    if cfg.family == "ssm":
        return SSM_CACHE_KEYS
    if cfg.family == "hybrid":
        return SSM_CACHE_KEYS + GQA_CACHE_KEYS
    return MLA_CACHE_KEYS if cfg.use_mla else GQA_CACHE_KEYS


def n_attn_groups(cfg) -> int:
    """The hybrid's shared-block applications: one per group of
    ``attn_every`` layers."""
    return -(-cfg.n_layers // cfg.attn_every)


def _group(cfg) -> int:
    """Mamba2 layers a group: ``attn_every`` in the hybrid, all in the SSM."""
    return cfg.attn_every if cfg.family == "hybrid" else cfg.n_layers


# ---------------------------------------------------------------------------
# Deployed linear: init (static assignment from DeploySpec) and apply
# ---------------------------------------------------------------------------

def _random_codes(gen, shape, c_in, bits, device):
    """``N(0, 1/c_in)`` weights of ``shape + (c_in,)`` drawn from ``gen``
    and quantized to ``bits`` with their row amax as the clip: ``(codes
    int8, step f32 shape)``."""
    w = torch.randn(shape + (c_in,), generator=gen, device=device) / math.sqrt(c_in)
    alpha = torch.amax(torch.abs(w), dim=-1, keepdim=True)
    q, scale = qz.quantize_weight_int(w, alpha, bits)
    return q, scale[..., 0]


def init_deployed_linear(gen: torch.Generator, c_in: int, c_out: int, cfg,
                         bias: bool = False, expert_axis: int = 0, tile_n="auto",
                         device=None) -> dict:
    """Random-weight deployed linear with the config's static group sizes.

    Weights are drawn from ``gen`` on ``device`` (``N(0, 1/c_in)``) and
    truly quantized and packed, group by group; static assignments are
    group-contiguous, so no permutation is carried.  ``expert_axis=E > 0``
    builds an expert stack (every tensor with a leading E axis, one tile
    schedule), its weights drawn a chunk of experts at a time (one
    deepseek-v3 group drawn at once would be 8.5 GB in f32).
    ``tile_n="auto"`` also builds the fused single-launch layout (where the
    contraction fits ``K_SINGLE_STEP_MAX``), with a tile no wider than the
    group alignment.  Built by :meth:`QTensor.from_codes`, the port's one
    builder.
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
        if not expert_axis:
            groups.append((b, *_random_codes(gen, (n,), c_in, b, device)))
            continue
        q = torch.empty((expert_axis, n, c_in), dtype=torch.int8, device=device)
        step = torch.empty((expert_axis, n), dtype=torch.float32, device=device)
        for sl in qmk.expert_chunks(expert_axis, n * c_in):
            q[sl], step[sl] = _random_codes(gen, (sl.stop - sl.start, n), c_in, b, device)
        groups.append((b, q, step))
    out = {"w": QTensor.from_codes(groups, c_in, tile_n=tile_n,
                                   act_bits=cfg.deploy.act_bits)}
    if bias:
        shape = (expert_axis, c_out) if expert_axis else (c_out,)
        out["bias"] = torch.zeros(shape, dtype=torch.bfloat16, device=device)
    return out


def dq_linear(x: torch.Tensor, dp: dict, compute_dtype=torch.bfloat16,
              backend: str = "cuda") -> torch.Tensor:
    """Apply a deployed linear: ``x (..., c_in) -> (..., c_out)`` in
    ``compute_dtype``, plus the optional bias; an expert stack maps ``x (E,
    ..., c_in) -> (E, ..., c_out)``."""
    y = dp["w"].matmul(x, backend, compute_dtype)
    if "bias" in dp:
        b = dp["bias"].to(y.dtype)
        if dp["w"].experts is not None:         # (E, c_out) over the rows
            b = b.reshape((b.shape[0],) + (1,) * (y.ndim - 2) + (b.shape[-1],))
        y = y + b
    return y


def _init_deployed_attn(gen, cfg, device):
    d, hd = cfg.d_model, cfg.head_dim
    H, KV = cfg.n_heads, cfg.n_kv_heads

    def dl(c_in, c_out, bias=False):
        return init_deployed_linear(gen, c_in, c_out, cfg, bias=bias, device=device)
    if cfg.use_mla:
        qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
        nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
        return {"wq_a": dl(d, qr), "wq_b": dl(qr, H * (nope + rope)),
                "wkv_a": dl(d, kvr + rope), "wkv_b": dl(kvr, H * (nope + vd)),
                "wo": dl(H * vd, d),
                "q_norm": L.norm_init(qr, "rmsnorm", torch.bfloat16, device),
                "kv_norm": L.norm_init(kvr, "rmsnorm", torch.bfloat16, device)}
    return {"wq": dl(d, H * hd, cfg.qkv_bias), "wk": dl(d, KV * hd, cfg.qkv_bias),
            "wv": dl(d, KV * hd, cfg.qkv_bias), "wo": dl(H * hd, d)}


def _init_deployed_ffn(gen, cfg, device):
    d = cfg.d_model

    def dl(c_in, c_out, expert_axis=0):
        return init_deployed_linear(gen, c_in, c_out, cfg, expert_axis=expert_axis,
                                    device=device)
    if cfg.n_experts:
        E, ff = cfg.n_experts, cfg.moe_d_ff
        router = torch.randn((E, d), generator=gen, device=device) / math.sqrt(d)
        p = {"router": router.to(torch.bfloat16),
             "we_gate": dl(d, ff, E), "we_up": dl(d, ff, E), "we_down": dl(ff, d, E)}
        if cfg.n_shared_experts:
            sff = ff * cfg.n_shared_experts
            p["shared"] = {"w_gate": dl(d, sff), "w_up": dl(d, sff), "w_down": dl(sff, d)}
        if cfg.dense_residual_ff:
            rff = cfg.dense_residual_ff
            p["dense_res"] = {"w_gate": dl(d, rff), "w_up": dl(d, rff), "w_down": dl(rff, d)}
        return p
    return {"w_gate": dl(d, cfg.d_ff), "w_up": dl(d, cfg.d_ff), "w_down": dl(cfg.d_ff, d)}


def _init_deployed_block(gen, cfg, device):
    return {"attn": _init_deployed_attn(gen, cfg, device),
            "ffn": _init_deployed_ffn(gen, cfg, device),
            "ln1": L.norm_init(cfg.d_model, cfg.norm, torch.bfloat16, device),
            "ln2": L.norm_init(cfg.d_model, cfg.norm, torch.bfloat16, device)}


def _init_deployed_mamba(gen, cfg, device):
    d = cfg.d_model
    d_inner, H, N, P = ssm_mod.dims(cfg)
    C = d_inner + 2 * N
    conv_w = torch.randn((ssm_mod.CONV_K, C), generator=gen, device=device) / 2.0
    return {
        "in_proj": init_deployed_linear(gen, d, 2 * d_inner + 2 * N + H, cfg, device=device),
        "out_proj": init_deployed_linear(gen, d_inner, d, cfg, device=device),
        "conv_w": conv_w.to(torch.bfloat16),
        "conv_b": torch.zeros((C,), dtype=torch.bfloat16, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=device)),
        "D": torch.ones((H,), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=device),
        "norm": L.norm_init(d_inner, "rmsnorm", torch.bfloat16, device),
        "ln": L.norm_init(d, cfg.norm, torch.bfloat16, device),
    }


def init_deployed_model(cfg, seed: int = 0, device=None) -> dict:
    """Random deployed model of ``cfg`` at its own width and depth, drawn
    from one ``torch.Generator`` seeded with ``seed`` on ``device`` (the
    card by default; it must exist)."""
    _check_ported(cfg)
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    embed = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen, device=device)
    params = {"embed": (embed * 0.02).to(torch.bfloat16)}
    del embed
    init_block = (_init_deployed_mamba if cfg.family in ("ssm", "hybrid")
                  else _init_deployed_block)
    params["blocks"] = [init_block(gen, cfg, device) for _ in range(cfg.n_layers)]
    if cfg.family == "hybrid":
        params["shared_attn"] = _init_deployed_block(gen, cfg, device)
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
    """The channel-group spec of the family's rings for the ``kv_bits``
    cache policy (``None``: the int8-per-token cache): over ``head_dim`` for
    GQA's K and V (the hybrid's shared block too), over ``kv_lora_rank`` for
    MLA's latent; ``ssm`` has no per-token ring, so the policy is a no-op
    there.  Raises at resolution time (engine construction) when the
    feature axis cannot take the packing."""
    _check_ported(cfg)
    if kv_bits is None or cfg.family == "ssm":
        return None
    return kvq.spec_for(kv_bits, cfg.kv_lora_rank if cfg.use_mla else cfg.head_dim)


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


def _deployed_mla_full(p, cfg, x, positions, backend="cuda", build_cache=False,
                       kv_spec=None):
    """Full-sequence MLA on deployed weights; optionally emits the
    sequence's latent cache (int8 per token, or packed under ``kv_spec``)
    and its rotary key, ``(B, S, F)`` per leaf."""
    B, S, _ = x.shape
    dq = _dq(cfg.cdtype, backend)
    H = cfg.n_heads
    nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank
    cq = L.rmsnorm(dq(x, p["wq_a"]), p["q_norm"])
    q = dq(cq, p["wq_b"]).reshape(B, S, H, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    ckv = dq(x, p["wkv_a"])
    c_kv, k_rope = ckv[..., :kvr], ckv[..., kvr:]
    c_kv = L.rmsnorm(c_kv, p["kv_norm"])
    kv = dq(c_kv, p["wkv_b"]).reshape(B, S, H, nope + vd)
    k_nope, v = kv[..., :nope], kv[..., nope:]
    cos, sin, rot = L.rope_freqs(rope, cfg.rope_theta, positions, 1.0)
    q_rope = L.apply_rope(q_rope, cos, sin, rot)                   # f32
    k_rope_r = L.apply_rope(k_rope[:, :, None, :], cos, sin, rot)  # (B, S, 1, rope) f32
    # bf16 next to the f32 rotary halves promotes to f32, as in the reference
    k_full = torch.cat([k_nope.to(torch.float32), k_rope_r.expand(B, S, H, rope)], dim=-1)
    q_full = torch.cat([q_nope.to(torch.float32), q_rope], dim=-1)
    o = attn.gqa_core(q_full, k_full, v, H, H, causal=True)
    y = dq(o.reshape(B, S, H * vd), p["wo"])
    cache = None
    if build_cache:
        if kv_spec is None:
            qc, qs = attn.quant_per_token(c_kv)
        else:
            qc, qs = kvq.quant_channelwise(c_kv, kv_spec)
        cache = {"ckv": qc, "ckv_scale": qs, "krope": k_rope_r[:, :, 0].to(torch.bfloat16)}
    return y, cache


def _deployed_moe(p, cfg, x, backend="cuda"):
    """The MoE FFN on deployed weights: an f32 router, top-k gates, a
    fixed-capacity dispatch into ``(E, capacity, d)`` buffers, the expert
    stacks, a gated combine and the shared expert.

    As in the reference: ``capacity = max(8, min(int(1.25 T k / E), T))``
    rows per expert (8 at decode with 4 slots, so every expert's bytes
    stream every step), pad tokens of a right-padded prefill routed like any
    other (they take capacity, so they decide drops), and the combine sums
    each token's k gated expert outputs in slot order in the compute dtype,
    each add rounded (no atomics: a bf16 sum's order would change its
    result from run to run).  Kept assignments have unique buffer rows, so
    the dispatch is a copy; dropped ones are written to a spare row past
    the buffer (no host sync) and read back as zeros.  Arctic's dense
    residual MLP (``dense_res``) adds after the shared expert, as in the
    reference (arctic has none, so its router is a softmax).
    """
    B, S, d = x.shape
    cd = cfg.cdtype
    dq = _dq(cd, backend)
    E, k = cfg.n_experts, cfg.experts_per_token
    T = B * S
    xt = x.reshape(T, d)
    logits = xt.to(torch.float32) @ p["router"].to(torch.float32).T
    routing = "sigmoid" if cfg.n_shared_experts else "softmax"
    gates, topi = moe_mod.route_topk(logits, k, routing)
    capacity = max(8, min(int(cfg.capacity_factor * T * k / E), T))
    dest, keep, _ = moe_mod.dispatch_indices(topi.reshape(-1), E, capacity)
    src = torch.arange(T, device=x.device).repeat_interleave(k)
    rows = torch.where(keep, dest, torch.full_like(dest, E * capacity))
    buf = torch.zeros((E * capacity + 1, d), dtype=cd, device=x.device)
    buf[rows] = xt[src].to(cd)
    buf = buf[:E * capacity].reshape(E, capacity, d)
    h = L.swiglu(dq(buf, p["we_gate"]), dq(buf, p["we_up"]))
    out_buf = dq(h, p["we_down"]).reshape(E * capacity, d)
    gathered = torch.where(keep[:, None], out_buf[dest], torch.zeros((), dtype=cd,
                                                                     device=x.device))
    contrib = (gathered * gates.reshape(-1, 1).to(cd)).reshape(T, k, d)
    out = torch.zeros((T, d), dtype=cd, device=x.device)
    for j in range(k):
        out = out + contrib[:, j]
    for name in ("shared", "dense_res"):      # the shared expert, arctic's dense MLP
        if name in p:
            sp = p[name]
            hs = L.swiglu(dq(xt, sp["w_gate"]), dq(xt, sp["w_up"]))
            out = out + dq(hs, sp["w_down"])
    return out.reshape(B, S, d)


def _deployed_ffn_full(p, cfg, x, backend="cuda"):
    if cfg.n_experts:
        return _deployed_moe(p, cfg, x, backend)
    dq = _dq(cfg.cdtype, backend)
    return dq(L.swiglu(dq(x, p["w_gate"]), dq(x, p["w_up"])), p["w_down"])


def _deployed_mamba_full(p, cfg, x, backend="cuda", lens=None):
    """One Mamba2 layer over a full sequence, with its pre-norm and residual:
    ``(x', {"h": final state (B, H, P, N) f32, "conv": conv ring (B,
    CONV_K - 1, C) bf16})``.

    ``lens (B,)``: the true lengths of a right-padded batch.  Padded steps
    are exact no-ops on the recurrence (``dt`` zeroed there: decay 1, no
    input), so the state is each row's at its own last real token, and the
    conv ring is gathered at ``lens`` (zeros before the sequence start).
    """
    B, S, _ = x.shape
    cd, f32 = cfg.cdtype, torch.float32
    dq = _dq(cd, backend)
    d_inner, H, N, P = ssm_mod.dims(cfg)
    zxbcdt = dq(L.apply_norm(x, p["ln"], cfg.norm), p["in_proj"])
    z = zxbcdt[..., :d_inner]
    xbc_in = zxbcdt[..., d_inner:2 * d_inner + 2 * N]
    xbc = ssm_mod.causal_conv(xbc_in, p["conv_w"].to(cd), p["conv_b"].to(cd))
    xs = xbc[..., :d_inner].reshape(B, S, H, P)
    Bm = xbc[..., d_inner:d_inner + N]
    Cm = xbc[..., d_inner + N:]
    dt = torch.nn.functional.softplus(zxbcdt[..., -H:].to(f32) + p["dt_bias"])
    if lens is not None:
        real = torch.arange(S, device=x.device)[None, :] < lens.to(x.device)[:, None]
        dt = torch.where(real[..., None], dt, torch.zeros((), device=x.device))
    y, hT = ssm_mod.ssd_chunked(xs.to(f32), dt, torch.exp(p["A_log"]), Bm.to(f32), Cm.to(f32),
                                cfg.ssm_chunk)
    y = y + xs.to(f32) * p["D"][None, None, :, None]
    y = y.reshape(B, S, d_inner).to(cd)
    y = L.rmsnorm(y * ssm_mod.silu(z), p["norm"])
    K1 = ssm_mod.CONV_K - 1
    if lens is None:
        conv_tail = xbc_in[:, -K1:]
    else:
        idx = lens.to(x.device)[:, None].long() - K1 + torch.arange(K1, device=x.device)[None]
        tail = torch.gather(xbc_in, 1, idx.clamp_min(0)[..., None].expand(-1, -1, xbc_in.shape[-1]))
        conv_tail = torch.where((idx >= 0)[..., None], tail, torch.zeros((), dtype=tail.dtype,
                                                                           device=x.device))
    return x + dq(y, p["out_proj"]).to(x.dtype), {"h": hT, "conv": conv_tail.to(torch.bfloat16)}


def mamba_decode_block(p, cfg, h, cache, live=None, backend="cuda"):
    """One Mamba2 layer of a decode step over its layer's ``{"h", "conv"}``
    cache (written in place): ``h (B, 1, d) -> h'``."""
    y, _ = ssm_mod.mamba2_decode(p, cfg, L.apply_norm(h, p["ln"], cfg.norm), cache,
                                 _dq(cfg.cdtype, backend), live)
    return h + y.to(h.dtype)


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
    if cfg.use_mla:
        a, c = _deployed_mla_full(p["attn"], cfg, hn, positions, backend=backend,
                                  build_cache=True, kv_spec=kv_spec)
    else:
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
    The attention caches also hold entries for the padded tail, above each
    slot's position: decode masks ``<= pos`` and overwrites index ``lens``
    first, so they are never attended; the SSM state stops at ``lens``.
    ``batch["prefix_embeds"] (B, n, d)`` (a model with ``n_prefix_tokens``,
    the VLM) replaces the first ``n`` token embeddings, cast to the compute
    dtype.  ``kv_bits``: the cache policy (:func:`kv_specs`), the same one
    ``init_caches``/``decode_step`` take.
    """
    cd = cfg.cdtype
    spec = kv_specs(cfg, kv_bits)
    tokens = batch["tokens"]
    x = dparams["embed"][tokens].to(cd)
    if cfg.n_prefix_tokens and "prefix_embeds" in batch:
        n = cfg.n_prefix_tokens
        x = torch.cat([batch["prefix_embeds"].to(x.device).to(cd), x[:, n:]], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)
    blocks = dparams["blocks"]
    if cfg.family in ATTN_FAMILIES:
        per_layer = []
        for p in blocks:
            x, c = block_forward(p, cfg, x, positions, backend, spec)
            per_layer.append(c)
        caches = {k: torch.stack([c[k] for c in per_layer]) for k in cache_keys(cfg)}
    else:                                   # Mamba2 layers; the hybrid's shared block first
        rings, states = [], []              # in each group of attn_every
        for start in range(0, cfg.n_layers, _group(cfg)):
            if cfg.family == "hybrid":
                x, c = block_forward(dparams["shared_attn"], cfg, x, positions, backend, spec)
                rings.append(c)
            for p in blocks[start:start + _group(cfg)]:
                x, st = _deployed_mamba_full(p, cfg, x, backend, lens)
                states.append(st)
        caches = {"ssm_h": torch.stack([st["h"] for st in states]),
                  "ssm_conv": torch.stack([st["conv"] for st in states])}
        caches.update({k: torch.stack([c[k] for c in rings]) for k in GQA_CACHE_KEYS if rings})
    x = L.apply_norm(x, dparams["ln_f"], cfg.norm)
    logits = dq_linear(_last_token(x, lens), dparams["lm_head"], cd, backend)
    return logits.to(torch.float32), caches


def init_caches(cfg, batch: int, max_len: int, kv_bits=None, device=None) -> dict:
    """Empty caches on ``device`` (the card by default; it must exist),
    stacked per layer: ``(n_layers, batch, KV, max_len, F)`` per GQA leaf,
    ``(n_layers, batch, max_len, F)`` per MLA leaf, the SSM state and conv
    ring ``(n_layers, batch, ...)``; the hybrid's GQA rings are stacked per
    group (:func:`n_attn_groups`).  ``kv_bits`` packs the rings
    channel-wise."""
    spec = kv_specs(cfg, kv_bits)
    device = resolve_device(device)
    stacks = []                              # (depth, one layer's leaves)
    if cfg.family in ("ssm", "hybrid"):
        one = ssm_mod.init_ssm_cache(cfg, batch, device="meta")
        stacks.append((cfg.n_layers, {"ssm_" + k: t for k, t in one.items()}))
    if cfg.family == "hybrid":
        stacks.append((n_attn_groups(cfg),
                       attn.init_gqa_cache(cfg, batch, max_len, spec, device="meta")))
    elif cfg.family in ATTN_FAMILIES:
        init = attn.init_mla_cache if cfg.use_mla else attn.init_gqa_cache
        stacks.append((cfg.n_layers, init(cfg, batch, max_len, spec, device="meta")))
    return {k: torch.zeros((depth,) + tuple(t.shape), dtype=t.dtype, device=device)
            for depth, one in stacks for k, t in one.items()}


def embed_caches(prefill_caches: dict, ring: dict) -> dict:
    """Right-pad the S-deep prefill caches along the sequence axis to the
    ring's shape (zero padding is the empty-slot convention: decode masks
    by position); a leaf with no ring axis (the SSM state) is copied as it
    is."""
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
    dq = _dq(cfg.cdtype, backend)
    if cfg.use_mla:
        a, _ = attn.mla_decode(p["attn"], cfg, hn, cache, pos, dq, live, kv_spec)
    else:
        a, _ = attn.gqa_decode(p["attn"], cfg, hn, cache, pos, dq, live, kv_spec, backend)
    h = h + a.to(h.dtype)
    f = _deployed_ffn_full(p["ffn"], cfg, L.apply_norm(h, p["ln2"], cfg.norm), backend)
    return h + f.to(h.dtype)


def decode_step(dparams, cfg, tokens, caches, pos, backend: str = "cuda",
                live=None, kv_bits=None):
    """One decode step: ``tokens (B, 1) -> (logits (B, 1, V) f32, caches)``.

    ``pos (B,)``: row ``b`` writes its new cache entry at ring index
    ``pos[b]`` and attends to ``<= pos[b]``; a scalar broadcasts.  ``live
    (B,)`` bool: rows with ``live=False`` leave the caches untouched (their
    logits are garbage; their SSM state does not move).  ``kv_bits`` must
    be the policy the caches were built with; with a packed GQA cache and
    ``backend="cuda"`` attention runs the decode-attention kernel, once per
    layer (once per shared-block application in the hybrid; MLA has no
    fused attention dot: its latent ring is dequantized and expanded
    through the packed ``wkv_b`` linear).  The caches are updated in place
    and returned.
    """
    spec = kv_specs(cfg, kv_bits)
    cd = cfg.cdtype
    x = dparams["embed"][tokens].to(cd)
    B = tokens.shape[0]
    pos = torch.as_tensor(pos, device=x.device).to(torch.int32)
    if pos.ndim == 0:
        pos = pos.expand(B).contiguous()
    if live is not None:
        live = torch.as_tensor(live, device=x.device)
    blocks = dparams["blocks"]
    if cfg.family in ATTN_FAMILIES:
        for layer, p in enumerate(blocks):
            x = decode_block(p, cfg, x, {k: caches[k][layer] for k in cache_keys(cfg)},
                             pos, live, spec, backend)
    else:                                   # Mamba2 layers; the hybrid's shared block first
        for g, start in enumerate(range(0, cfg.n_layers, _group(cfg))):
            if cfg.family == "hybrid":
                x = decode_block(dparams["shared_attn"], cfg, x,
                                 {k: caches[k][g] for k in GQA_CACHE_KEYS}, pos, live, spec,
                                 backend)
            for layer in range(start, min(start + _group(cfg), cfg.n_layers)):
                ssm_cache = {"h": caches["ssm_h"][layer], "conv": caches["ssm_conv"][layer]}
                x = mamba_decode_block(blocks[layer], cfg, x, ssm_cache, live, backend)
    x = L.apply_norm(x, dparams["ln_f"], cfg.norm)
    logits = dq_linear(x, dparams["lm_head"], cd, backend)
    return logits.to(torch.float32), caches
