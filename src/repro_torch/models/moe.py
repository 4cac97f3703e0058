"""Mixture-of-experts routing: per-token top-k gates and the sort-based
dispatch of (token, slot) assignments into fixed-capacity expert buffers.

Counterpart of ``repro.models.moe`` (``route_topk``, ``dispatch_indices``),
as plain functions on tensors; the deployed expert GEMMs that consume the
dispatch live in ``models/serving.py``.  Both keep the reference's integer
results exactly: ties in the top-k go to the lower expert index (as
``jax.lax.top_k``), and the dispatch ranks each expert's assignments in
flat ``(token, slot)`` order through a stable sort.
"""
from __future__ import annotations

import torch

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
    counts = torch.bincount(experts, minlength=n_experts)
    starts = torch.cumsum(counts, 0) - counts                    # exclusive
    rank = torch.arange(n, device=experts.device) - starts[sorted_e]
    keep_sorted = rank < capacity
    dest_sorted = torch.where(keep_sorted, sorted_e * capacity + rank,
                              torch.zeros_like(rank))
    inv = torch.empty_like(order)
    inv[order] = torch.arange(n, device=experts.device)          # undo the sort
    return dest_sorted[inv], keep_sorted[inv], order
