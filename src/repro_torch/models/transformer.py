"""The language models' training path: init, full-sequence forward, loss and
the cost specs of the search, for the dense, VLM and MoE families.

PyTorch counterpart of ``repro.models.transformer``:

  init_model(cfg, gen)                      -> (params, nas)
  forward(params, nas, cfg, batch, policy)  -> logits (B, S, padded vocab), f32
  forward_with_mtp(...)                     -> (logits, MTP logits or None)
  lm_loss(logits, batch)                    -> scalar cross-entropy
  cost_specs(cfg, tokens)                   -> {site: LayerCostSpec} (Eq. 7/8)

The block stack keeps the reference's stacked layout: every leaf of
``params["blocks"]`` and ``nas["blocks"]`` carries a leading layer axis, so
the optimizer states, the checkpoint and the NAS sites' cost specs are the
reference's.  The forward takes each layer's views with one
``torch.unbind`` per leaf (whose backward stacks the layers' gradients
once; a per-layer ``t[i]`` would write a full-size zero tensor per layer in
the backward) and runs the blocks in a Python loop, each under
``torch.utils.checkpoint`` when ``remat`` is set (the reference's
``jax.checkpoint`` inside ``lax.scan``).

``policy`` is a :class:`repro_torch.api.PrecisionPolicy` (FLOAT, QAT8,
search(tau), FROZEN), with the step's training arithmetic
(``train_compute``) and, for int8, the stochastic-rounding seed, which each
layer folds with its index as the reference splits its key per layer.
``batch`` holds ``tokens`` and ``labels`` (``(B, S)`` integers) and, for
the VLM, ``prefix_embeds`` ``(B, n_prefix_tokens, d)``.

A block's attention is GQA or, with ``use_mla``, DeepSeek's MLA; its FFN
the MLP or, with ``n_experts``, the MoE FFN (``models/moe.py``).
DeepSeek's multi-token prediction (``mtp``) adds one unstacked block and
its input norm (``mtp_block``, ``mtp_ln``), run outside the checkpointed
stack on the embeddings under the step's own policy, and the lm_head a
second time.  The SSM, hybrid and audio families raise
``NotImplementedError`` naming the ``ROADMAP.md`` item that ports their
training path; :func:`cost_specs` covers every family.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.regularizers import LayerCostSpec
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.qtrain.linear import fold_in

# families whose training path is still to port, with the ROADMAP.md item
NOT_PORTED = {"ssm": "queue 1 item 7.3", "hybrid": "queue 1 item 7.3",
              "audio": "queue 1 item 7.4"}


def check_trainable(cfg) -> None:
    """Raise ``NotImplementedError`` for a family whose training path the
    port does not have yet."""
    item = NOT_PORTED.get(cfg.family)
    if item is not None:
        raise NotImplementedError(
            f"training {cfg.name!r} ({cfg.family} family) is not ported yet: "
            f"ROADMAP.md {item}")


# ---------------------------------------------------------------------------
# Blocks (one layer's params, or a stack of them with ``lead`` axes)
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg, d_in: int, d_ff: int, dtype=torch.float32,
             lead: tuple = ()) -> tuple:
    if cfg.mlp_type == "swiglu":
        p = {"w_gate": L.linear_init(gen, d_in, d_ff, False, dtype, lead),
             "w_up": L.linear_init(gen, d_in, d_ff, False, dtype, lead),
             "w_down": L.linear_init(gen, d_ff, d_in, False, dtype, lead)}
    else:
        p = {"w_in": L.linear_init(gen, d_in, d_ff, False, dtype, lead),
             "w_down": L.linear_init(gen, d_ff, d_in, False, dtype, lead)}
    n = {k: L.nas_init(v["w"].shape[-2], cfg.quant, gen.device, lead) for k, v in p.items()}
    return p, n


def mlp_forward(p: dict, nas: Optional[dict], policy, cfg, x: torch.Tensor) -> torch.Tensor:
    cd, pd = cfg.cdtype, L.partial_dtype_of(cfg)
    getn = (lambda n: nas[n]) if nas is not None else (lambda n: None)

    def lin(name, t):
        return L.qlinear(t, p[name], getn(name), policy, cfg.quant, compute_dtype=cd,
                         partial_dtype=pd)

    if cfg.mlp_type == "swiglu":       # jax.nn.silu's bf16 roundings (layers.silu)
        h = L.silu(lin("w_gate", x)) * lin("w_up", x)
    else:
        h = L.gelu(lin("w_in", x))
    return lin("w_down", h)


def init_block(gen: torch.Generator, cfg, dtype=torch.float32, lead: tuple = ()) -> tuple:
    """One decoder block of the dense/VLM/MoE families (a stack with
    ``lead``)."""
    check_trainable(cfg)
    p_attn, n_attn = (attn.init_mla if cfg.use_mla else attn.init_gqa)(gen, cfg, dtype, lead)
    if cfg.n_experts:
        p_ffn, n_ffn = moe_mod.init_moe(gen, cfg, dtype, lead)
    else:
        p_ffn, n_ffn = init_mlp(gen, cfg, cfg.d_model, cfg.d_ff, dtype, lead)
    p = {"attn": p_attn, "ffn": p_ffn,
         "ln1": L.norm_init(cfg.d_model, cfg.norm, dtype, gen.device, lead),
         "ln2": L.norm_init(cfg.d_model, cfg.norm, dtype, gen.device, lead)}
    n = {**{f"attn.{k}": v for k, v in n_attn.items()},
         **{f"ffn.{k}": v for k, v in n_ffn.items()}}
    return p, n


def _sub(nas: Optional[dict], pre: str) -> Optional[dict]:
    if nas is None:
        return None
    return {k[len(pre):]: v for k, v in nas.items() if k.startswith(pre)}


def block_forward(p: dict, nas: Optional[dict], policy, cfg, x: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    h = L.apply_norm(x, p["ln1"], cfg.norm)
    attend = attn.mla_forward if cfg.use_mla else attn.gqa_forward
    a = attend(p["attn"], _sub(nas, "attn."), policy, cfg, h, positions)
    x = x + a.to(x.dtype)
    h = L.apply_norm(x, p["ln2"], cfg.norm)
    ffn = moe_mod.moe_forward if cfg.n_experts else mlp_forward
    f = ffn(p["ffn"], _sub(nas, "ffn."), policy, cfg, h)
    return x + f.to(x.dtype)


# ---------------------------------------------------------------------------
# Whole-model init
# ---------------------------------------------------------------------------

def init_model(cfg, gen: torch.Generator) -> tuple:
    """``(params, nas)`` of the whole model, drawn on ``gen``'s device in
    ``cfg.pdtype``: the embedding and lm_head at the padded vocab, the
    blocks stacked on a leading layer axis (and with ``mtp`` one more
    block and its norm).  ``tie_embeddings`` is not read: the lm_head is
    its own weight, as in the reference."""
    check_trainable(cfg)
    dtype, dev = cfg.pdtype, gen.device
    params = {"embed": L.embedding_init(gen, cfg.padded_vocab, cfg.d_model, dtype)}
    nas = {}
    params["blocks"], nas["blocks"] = init_block(gen, cfg, dtype, (cfg.n_layers,))
    params["ln_f"] = L.norm_init(cfg.d_model, cfg.norm, dtype, dev)
    params["lm_head"] = L.linear_init(gen, cfg.d_model, cfg.padded_vocab, False, dtype)
    nas["lm_head"] = L.nas_init(cfg.padded_vocab, cfg.quant, dev)
    if cfg.mtp:
        params["mtp_block"], nas["mtp_block"] = init_block(gen, cfg, dtype)
        params["mtp_ln"] = L.norm_init(cfg.d_model, cfg.norm, dtype, dev)
    return params, nas


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _embed_inputs(params: dict, cfg, batch: dict) -> torch.Tensor:
    x = params["embed"][batch["tokens"].long()].to(cfg.cdtype)
    if cfg.n_prefix_tokens and "prefix_embeds" in batch:
        n = cfg.n_prefix_tokens
        x = torch.cat([batch["prefix_embeds"].to(cfg.cdtype), x[:, n:]], dim=1)
    return x


def _layer_keys(policy, n_layers: int, tag: int) -> Optional[list]:
    """Per-layer stochastic-rounding seeds of a block stack (``None`` when
    the policy carries none): the policy's seed folded with ``tag`` (one
    stack of a forward from another), then with the layer index."""
    if policy.sr_key is None:
        return None
    base = fold_in(policy.sr_key, tag)
    return [fold_in(base, i) for i in range(n_layers)]


def unstack(tree, n: int) -> list:
    """The ``n`` per-layer views of a stacked tree (``None`` -> ``None``s):
    one ``torch.unbind`` per leaf."""
    if tree is None:
        return [None] * n
    if isinstance(tree, dict):
        subs = {k: unstack(v, n) for k, v in tree.items()}
        return [{k: subs[k][i] for k in tree} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _scan_blocks(block_fn, params_blocks: dict, nas_blocks: Optional[dict], x: torch.Tensor,
                 remat: bool = True, keys: Optional[list] = None) -> torch.Tensor:
    """``x`` through every layer of a stacked stack in order:
    ``block_fn(h, p, n, key)`` per layer, under ``torch.utils.checkpoint``
    when ``remat`` (the recomputed forward draws the same seeds)."""
    n = next(iter(_leaves(params_blocks))).shape[0]
    ps, ns = unstack(params_blocks, n), unstack(nas_blocks, n)
    ks = keys if keys is not None else [None] * n
    for p, nn, k in zip(ps, ns, ks):
        if remat:
            x = checkpoint(block_fn, x, p, nn, k, use_reentrant=False)
        else:
            x = block_fn(x, p, nn, k)
    return x


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def forward(params: dict, nas: Optional[dict], cfg, batch: dict, policy,
            remat: bool = True) -> torch.Tensor:
    """Full-sequence forward -> logits ``(B, S, padded_vocab)`` in f32, the
    padding's logits masked."""
    check_trainable(cfg)
    x = _embed_inputs(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    keys = _layer_keys(policy, cfg.n_layers, 0)

    def bf(h, p, n, k=None):
        pol = policy if k is None else policy.with_sr_key(k)
        return block_forward(p, n, pol, cfg, h, positions)

    x = _scan_blocks(bf, params["blocks"], None if nas is None else nas["blocks"], x,
                     remat, keys=keys)
    x = L.apply_norm(x, params["ln_f"], cfg.norm)
    head_nas = nas["lm_head"] if nas is not None else None
    logits = L.qlinear(x, params["lm_head"], head_nas, policy, cfg.quant,
                       compute_dtype=cfg.cdtype)
    return _mask_pad(logits.to(torch.float32), cfg)


def forward_with_mtp(params: dict, nas: Optional[dict], cfg, batch: dict, policy,
                     remat: bool = True) -> tuple:
    """``(logits, mtp_logits)``: the forward's logits, and with ``mtp`` the
    multi-token-prediction head's f32 logits (its block on the normed
    embeddings, outside the checkpoint, then ``ln_f`` and the lm_head
    under the step's own policy, unmasked as in the reference), else
    ``None``."""
    logits = forward(params, nas, cfg, batch, policy, remat)
    if not cfg.mtp:
        return logits, None
    x = _embed_inputs(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    n_mtp = nas["mtp_block"] if nas is not None else None
    h = block_forward(params["mtp_block"], n_mtp, policy, cfg,
                      L.apply_norm(x, params["mtp_ln"], cfg.norm), positions)
    head_nas = nas["lm_head"] if nas is not None else None
    mtp_logits = L.qlinear(L.apply_norm(h, params["ln_f"], cfg.norm), params["lm_head"],
                           head_nas, policy, cfg.quant, compute_dtype=cfg.cdtype)
    return logits, mtp_logits.to(torch.float32)


def _mask_pad(logits: torch.Tensor, cfg) -> torch.Tensor:
    """The vocab padding's logits set to -1e9 (never predicted)."""
    if cfg.padded_vocab == cfg.vocab_size:
        return logits
    keep = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab_size
    return torch.where(keep, logits, torch.full((), -1e9, device=logits.device))


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

def lm_loss(logits: torch.Tensor, batch: dict) -> torch.Tensor:
    """Next-token cross-entropy (the pipeline has shifted the labels),
    averaged over ``batch["mask"]`` (all ones when absent)."""
    labels = batch["labels"].long()
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    ll = torch.gather(logp, -1, labels[..., None])[..., 0]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    total = torch.sum(mask)
    return -torch.sum(ll * mask) / torch.maximum(total, torch.ones_like(total))


# ---------------------------------------------------------------------------
# NAS-tree flattening: {"blocks": {"attn.wq": {...}}} -> {"blocks.attn.wq": ...},
# the keys of cost_specs.  A site is a dict holding "gamma".
# ---------------------------------------------------------------------------

def flatten_nas(nas: dict, prefix: str = "") -> dict:
    flat = {}
    for k, v in nas.items():
        path = f"{prefix}{k}" if not prefix else f"{prefix}.{k}"
        if isinstance(v, dict) and "gamma" in v:
            flat[path] = v
        elif isinstance(v, dict):
            flat.update(flatten_nas(v, path))
        else:
            raise TypeError(f"unexpected NAS leaf at {path}: {type(v)}")
    return flat


# ---------------------------------------------------------------------------
# Cost specs (Eq. 7/8) of every searchable site, for every family
# ---------------------------------------------------------------------------

def _site_specs_for_linear(name: str, c_out: int, c_in: int, tokens: int,
                           n_layers: int = 1) -> LayerCostSpec:
    return LayerCostSpec(name=name, c_out=n_layers * c_out, weights_per_channel=c_in,
                         ops=n_layers * c_out * c_in * tokens)


def cost_specs(cfg, tokens: int) -> dict:
    """A ``LayerCostSpec`` per NAS site, keyed as :func:`flatten_nas` keys
    the NAS tree (a stacked site folds the layer axis into its channels)."""
    d, ff = cfg.d_model, cfg.d_ff
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    Ln = cfg.n_layers
    specs = {}

    def add(prefix, name, c_out, c_in, layers=1, tok=tokens):
        specs[f"{prefix}{name}"] = _site_specs_for_linear(f"{prefix}{name}", c_out, c_in,
                                                          tok, layers)

    if cfg.family in ("dense", "vlm", "moe", "hybrid", "audio"):
        if cfg.use_mla:
            qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
            nope, rope, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
            att = [("attn.wq_a", qr, d), ("attn.wq_b", H * (nope + rope), qr),
                   ("attn.wkv_a", kvr + rope, d), ("attn.wkv_b", H * (nope + vd), kvr),
                   ("attn.wo", d, H * vd)]
        else:
            att = [("attn.wq", H * hd, d), ("attn.wk", KV * hd, d),
                   ("attn.wv", KV * hd, d), ("attn.wo", d, H * hd)]
        n_attn_layers = Ln if cfg.family != "hybrid" else 1      # the shared block
        prefix = "blocks." if cfg.family != "hybrid" else "shared_attn."
        if cfg.family == "audio":
            for nm, co, ci in att:
                add("enc_blocks.", nm, co, ci, cfg.n_encoder_layers, cfg.encoder_seq)
                add("dec_blocks.", nm, co, ci, Ln)
                add("dec_blocks.", nm.replace("attn.", "xattn."), co, ci, Ln)
        else:
            for nm, co, ci in att:
                add(prefix, nm, co, ci, n_attn_layers)
                if cfg.mtp:
                    add("mtp_block.", nm, co, ci, 1)
        if cfg.n_experts:
            E, eff = cfg.n_experts, cfg.moe_d_ff
            act_frac = cfg.experts_per_token / E       # only the top-k experts run
            for pfx in ["blocks."] + (["mtp_block."] if cfg.mtp else []):
                nl = Ln if pfx == "blocks." else 1
                for nm, co, ci in [("ffn.we_gate", E * eff, d), ("ffn.we_up", E * eff, d),
                                   ("ffn.we_down", E * d, eff)]:
                    specs[pfx + nm] = _site_specs_for_linear(
                        pfx + nm, co, ci, max(1, int(tokens * act_frac)), nl)
                if cfg.n_shared_experts:
                    sff = cfg.moe_d_ff * cfg.n_shared_experts
                    add(pfx, "ffn.shared.w_gate", sff, d, nl)
                    add(pfx, "ffn.shared.w_up", sff, d, nl)
                    add(pfx, "ffn.shared.w_down", d, sff, nl)
                if cfg.dense_residual_ff:
                    rff = cfg.dense_residual_ff
                    add(pfx, "ffn.dense_res.w_gate", rff, d, nl)
                    add(pfx, "ffn.dense_res.w_up", rff, d, nl)
                    add(pfx, "ffn.dense_res.w_down", d, rff, nl)
        elif cfg.d_ff:
            mlp_prefix = ("blocks.ffn." if cfg.family in ("dense", "vlm")
                          else "shared_attn.ffn." if cfg.family == "hybrid"
                          else "dec_blocks.mlp.")
            n_mlp = 1 if cfg.family == "hybrid" else Ln
            if cfg.mlp_type == "swiglu":
                names = [("w_gate", ff, d), ("w_up", ff, d), ("w_down", d, ff)]
            else:
                names = [("w_in", ff, d), ("w_down", d, ff)]
            for nm, co, ci in names:
                add(mlp_prefix, nm, co, ci, n_mlp)
            if cfg.family == "audio":
                for nm, co, ci in names:
                    add("enc_blocks.mlp.", nm, co, ci, cfg.n_encoder_layers, cfg.encoder_seq)

    if cfg.family in ("ssm", "hybrid"):
        d_inner, Hs, N, P = ssm_mod.dims(cfg)
        add("blocks.", "in_proj", 2 * d_inner + 2 * N + Hs, d, Ln)
        add("blocks.", "out_proj", d, d_inner, Ln)

    add("", "lm_head", cfg.padded_vocab, d, 1)
    return specs
