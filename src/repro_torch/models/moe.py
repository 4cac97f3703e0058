"""Mixture-of-experts layer: per-token top-k routing, the sort-based
dispatch of (token, slot) assignments into fixed-capacity expert buffers,
the combine of the experts' outputs, and the search-phase (training) FFN.

Counterpart of ``repro.models.moe``: ``init_moe``, ``_expert_weights``,
``moe_forward`` (float expert stacks under a training policy),
``aux_load_balance_loss``, ``route_topk`` and ``dispatch_indices``; the
deployed expert GEMMs live in ``models/serving.py``, which routes,
dispatches and combines through the same functions.  Routing and dispatch
keep the reference's integer results exactly: ties in the top-k go to the
lower expert index (as ``jax.lax.top_k``), and the dispatch ranks each
expert's assignments in flat ``(token, slot)`` order through a stable sort.

:func:`dispatch` and :func:`combine` replace the reference's
``.at[].add`` scatters, which CUDA would run as atomic adds in an order
(and so a bf16 result) that changes from run to run: kept assignments
have unique buffer rows, so the dispatch is a copy, and the combine sums
each token's k slots in slot order.  Under autograd the token repeat is an
``expand`` (its backward a sum over the k slots) and each kept row is
read once (the drops read a spare zero row, whose gradient is dropped), so
no gradient that is kept is an atomic sum either.  Their ``constrain``
sites are the reference's six in ``moe_forward``, in its order.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.api.policy import Phase, PrecisionPolicy
from repro_torch.core import mixedprec as mp
from repro_torch.core import quantizers as qz
from repro_torch.dist import collectives as coll
from repro_torch.dist import sharding as shd
from repro_torch.models import layers as L


def _total_order(x: torch.Tensor) -> torch.Tensor:
    """An int32 key that sorts f32 values in IEEE total order (``-0.0``
    below ``+0.0``), the order ``jax.lax.top_k`` ranks in."""
    bits = x.contiguous().view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def route_topk(logits: torch.Tensor, k: int, routing: str = "softmax") -> tuple:
    """Per-token top-k gates: ``logits (T, E) -> (gates (T, k) f32, experts
    (T, k) int64)``.

    ``"sigmoid"`` (deepseek-v3) ranks the sigmoid scores and normalizes the
    k chosen ones to sum to 1; ``"softmax"`` ranks the logits and takes a
    softmax over the k chosen.  A stable descending sort in IEEE total
    order keeps the lower index first among equal scores and ranks ``+0.0``
    above ``-0.0``, as ``jax.lax.top_k`` does (``torch.topk`` promises no
    order among ties).
    """
    x = logits.to(torch.float32)
    scores = torch.sigmoid(x) if routing == "sigmoid" else x
    order = torch.sort(_total_order(scores), dim=-1, descending=True,
                       stable=True).indices[..., :k]
    topv = torch.gather(scores, -1, order)
    if routing == "sigmoid":
        gates = topv / torch.clamp_min(L.row_sum(topv), 1e-9)
    else:
        gates = torch.softmax(topv, dim=-1)
    return gates, order


def dispatch_indices(experts: torch.Tensor, n_experts: int, capacity: int) -> tuple:
    """Sort-based buffer positions of flat ``(T * k,)`` expert ids:
    ``(dest, keep, order)``.

    ``dest[i] = e_i * capacity + r_i`` where ``r_i`` is assignment ``i``'s
    rank among those of its expert in flat order; assignments ranked at or
    past ``capacity`` are dropped (``keep`` False, ``dest`` 0).  ``order`` is
    the stable sort of the ids.
    """
    n = experts.shape[0]
    experts = experts.to(torch.int64)
    order = torch.argsort(experts, stable=True)
    sorted_e = experts[order]
    # the ids' counts, (n_experts,) whatever the ids: a static shape (bincount's
    # depends on the largest id, so the card reads it back and a fake tensor
    # has none)
    counts = torch.zeros(n_experts, dtype=torch.int64, device=experts.device).scatter_add_(
        0, experts, torch.ones_like(experts))
    starts = torch.cumsum(counts, 0) - counts                    # exclusive
    rank = torch.arange(n, device=experts.device) - starts[sorted_e]
    keep_sorted = rank < capacity
    dest_sorted = torch.where(keep_sorted, sorted_e * capacity + rank,
                              torch.zeros_like(rank))
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, device=experts.device)          # undo the sort
    return dest_sorted[inv], keep_sorted[inv], order


def capacity_of(cfg, tokens: int) -> int:
    """Rows per expert: ``max(8, min(int(capacity_factor T k / E), T))``."""
    E, k = cfg.n_experts, cfg.experts_per_token
    return max(8, min(int(cfg.capacity_factor * tokens * k / E), tokens))


def dispatch(xt: torch.Tensor, dest: torch.Tensor, keep: torch.Tensor, n_experts: int,
             capacity: int) -> torch.Tensor:
    """The ``(E, capacity, d)`` expert buffer of tokens ``xt (T, d)``, each
    repeated for its ``k = dest.numel() / T`` slots: kept assignments copied
    to their (unique) rows, dropped ones to a spare row past the buffer that
    is cut off (no host sync), unused rows zero."""
    T, d = xt.shape
    k = dest.shape[0] // T
    xt = shd.constrain(xt, "D", None)
    contrib = shd.constrain(xt[:, None, :].expand(T, k, d).reshape(T * k, d), "D", None)
    rows = torch.where(keep, dest, torch.full_like(dest, n_experts * capacity))
    buf = torch.zeros((n_experts * capacity + 1, d), dtype=xt.dtype, device=xt.device)
    buf = buf.index_put((rows,), contrib)
    return shd.constrain(buf[:n_experts * capacity].reshape(n_experts, capacity, d),
                         "M", "D", None)


def combine(out_buf: torch.Tensor, dest: torch.Tensor, keep: torch.Tensor,
            gates: torch.Tensor) -> torch.Tensor:
    """``(T, d)``: each token's k expert outputs (rows ``dest`` of the
    ``(E, capacity, d)`` buffer; zeros where dropped) times their gates,
    summed in slot order in the buffer's dtype, each add rounded."""
    E, C, d = out_buf.shape
    T, k = gates.shape
    out_buf = shd.constrain(out_buf, "M", "D", None)
    flat = torch.cat([out_buf.reshape(E * C, d), out_buf.new_zeros((1, d))])
    rows = torch.where(keep, dest, torch.full_like(dest, E * C))
    gathered = shd.constrain(flat[rows], "D", None)
    contrib = (gathered * gates.reshape(T * k, 1).to(out_buf.dtype)).reshape(T, k, d)
    out = torch.zeros((T, d), dtype=out_buf.dtype, device=out_buf.device)
    for j in range(k):
        out = out + contrib[:, j]
    return shd.constrain(out, "D", None)


# ---------------------------------------------------------------------------
# The search-phase (training) FFN on float expert stacks
# ---------------------------------------------------------------------------

def init_moe(gen: torch.Generator, cfg, dtype=torch.float32, lead: tuple = ()) -> tuple:
    """``(params, nas)`` of one MoE FFN (``lead`` axes prepended: a stack of
    layers): the f32-routed ``router``, the expert stacks ``we_gate``,
    ``we_up`` ``(E, moe_d_ff, d)`` and ``we_down`` ``(E, d, moe_d_ff)`` with
    their clips ``aw (E, c_out)``, NAS gammas ``(E, c_out, |P_W|)`` per
    channel (the reference's layout), and the shared expert's or arctic's
    dense residual MLP (``shared.*``, ``dense_res.*`` NAS sites)."""
    d, E, ff = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    lead = tuple(lead)
    params = {"router": L.linear_init(gen, d, E, False, dtype, lead)}
    nas = {}
    for name, c_out, c_in in (("we_gate", ff, d), ("we_up", ff, d), ("we_down", d, ff)):
        p = L.linear_init(gen, c_in, E * c_out, False, dtype, lead)
        params[name] = {"w": p["w"].reshape(lead + (E, c_out, c_in)),
                        "aw": p["aw"].reshape(lead + (E, c_out)), "ax": p["ax"]}
        n = L.nas_init(E * c_out, cfg.quant, gen.device, lead)
        if cfg.quant.per_channel:
            n["gamma"] = n["gamma"].reshape(lead + (E, c_out, -1))
        nas[name] = n
    for name, width in (("shared", ff * cfg.n_shared_experts),
                        ("dense_res", cfg.dense_residual_ff)):
        if not width:
            continue
        params[name] = {"w_gate": L.linear_init(gen, d, width, False, dtype, lead),
                        "w_up": L.linear_init(gen, d, width, False, dtype, lead),
                        "w_down": L.linear_init(gen, width, d, False, dtype, lead)}
        for k, c_out in (("w_gate", width), ("w_up", width), ("w_down", d)):
            nas[f"{name}.{k}"] = L.nas_init(c_out, cfg.quant, gen.device, lead)
    return params, nas


def _expert_weights(p: dict, nas: Optional[dict], policy, qcfg) -> torch.Tensor:
    """The policy's fake quantization of a float ``(E, c_out, c_in)``
    stack, over its ``(E * c_out, c_in)`` rows (per channel: each expert's
    output channels are channels of their own)."""
    w = p["w"]
    E, co, ci = w.shape
    if policy.phase is Phase.FLOAT:
        return w
    aw, wf = p["aw"].reshape(E * co), w.reshape(E * co, ci)
    if policy.phase is Phase.QAT8:
        out = mp.fake_quant_weight(wf, aw[:, None], 8)
    elif policy.phase is Phase.SEARCH:
        out = mp.effective_weight(wf, nas["gamma"].reshape(E * co, -1), aw, policy.tau, qcfg)
    elif policy.phase is Phase.FROZEN:
        out = mp.frozen_weight(wf, nas["gamma"].reshape(E * co, -1), aw, qcfg)
    else:
        raise ValueError(f"unhandled policy {policy!r}")
    return out.reshape(E, co, ci)


def _experts_mm(eq: str, a: torch.Tensor, b: torch.Tensor, cd) -> torch.Tensor:
    """An expert-batched product in the compute dtype as XLA computes a
    bf16 dot: exact products of the rounded operands summed in f32 and
    rounded once."""
    return torch.einsum(eq, L._rounded(a, cd), L._rounded(b, cd)).to(cd)


def moe_forward(p: dict, nas: Optional[dict], policy, cfg, x: torch.Tensor) -> torch.Tensor:
    """The MoE FFN under a training ``policy``: ``x (B, S, d)`` -> ``(B,
    S, d)``, differentiable.  The router is an f32 product under the float
    policy whatever the step's arithmetic; the routed experts' products are
    plain batched products over the fake-quantized stacks (no int8 kernel,
    as in the reference); the shared expert and the dense residual MLP are
    searched linears (``qlinear``, so int8 steps run them on K5).

    Not across a data group of processes: the capacity couples the whole
    batch's tokens (the reference puts it on ``data``), and their dispatch
    across the rows is ROADMAP item 8.3 part 2; it raises
    ``NotImplementedError`` there."""
    if coll.active() is not None:
        raise NotImplementedError(
            "MoE training across processes (the dispatch across the data rows, the "
            "expert-parallel products) is ROADMAP item 8.3 part 2; train MoE models in one "
            "process")
    B, S, d = x.shape
    E, k, cd = cfg.n_experts, cfg.experts_per_token, cfg.cdtype
    T = B * S
    xt = x.reshape(T, d)
    getn = (lambda n: nas[n]) if nas is not None else (lambda n: None)

    logits = L.qlinear(xt, p["router"], None, PrecisionPolicy.FLOAT, cfg.quant,
                       compute_dtype=torch.float32)
    gates, topi = route_topk(logits, k, "sigmoid" if cfg.n_shared_experts else "softmax")
    capacity = capacity_of(cfg, T)
    dest, keep, _ = dispatch_indices(topi.reshape(-1), E, capacity)
    buf = dispatch(xt.to(cd), dest, keep, E, capacity)
    wg, wu, wd = (_expert_weights(p[n], getn(n), policy, cfg.quant).to(cd)
                  for n in ("we_gate", "we_up", "we_down"))
    h = (L.silu(_experts_mm("ecd,efd->ecf", buf, wg, cd))
         * _experts_mm("ecd,efd->ecf", buf, wu, cd))
    out = combine(_experts_mm("ecf,edf->ecd", h, wd, cd), dest, keep, gates)
    for name in ("shared", "dense_res"):
        if name not in p:
            continue
        sp = p[name]

        def lin(site, t):
            return L.qlinear(t, sp[site], getn(f"{name}.{site}"), policy, cfg.quant,
                             compute_dtype=cd)
        out = out + lin("w_down", L.silu(lin("w_gate", xt)) * lin("w_up", xt))
    return out.reshape(B, S, d).to(x.dtype)


def aux_load_balance_loss(logits: torch.Tensor, topi: torch.Tensor,
                          n_experts: int) -> torch.Tensor:
    """Switch-style load balance: ``E * sum_e mean_t p_te * frac_e``, the
    router's mean softmax against the share of tokens whose first choice
    is ``e``.  Defined as in the reference, and, as there, no step adds it
    to the loss."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    T = probs.shape[0]
    me = qz.over(torch.sum(probs, dim=0), T)
    onehot = torch.nn.functional.one_hot(topi[:, 0].long(), n_experts).to(torch.float32)
    ce = qz.over(torch.sum(onehot, dim=0), T)
    return n_experts * torch.sum(me * ce)
