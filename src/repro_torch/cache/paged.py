"""Device-side page index plumbing: gather and scatter over page pools.

Counterpart of ``repro.cache.paged`` on torch tensors.  A paged ring leaf
stores its sequence axis as ``(num_pages, page_size)`` physical pages:
``pool (num_pages, *mid, page_size, feat)`` per layer (``*mid`` is e.g. the
KV-head axis), with the layer stack in front in the serving caches.  A
slot's logical ring of ``max_len = P * T`` positions is the concatenation
of the ``P`` pages its ``(B, P)`` page-table row points at; page 0 (the
NULL page) is never written and stays zero, so gathering through an
unmapped entry reads the dense ring's empty-slot zeros.

The gathered view is exactly the dense ``(B, *mid, max_len, feat)`` ring,
which is what makes the paged engine's tokens those of the dense one.
Writes that must not land (dead rows, positions past the table, unmapped
or shared pages, the junk tail of a short prompt) carry the out-of-bounds
sentinel ``num_pages`` and are dropped, as the reference's
``mode="drop"`` scatters drop them.  Unlike the reference, the writers
update the pool in place.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def gather_pages(pool: torch.Tensor, pages: torch.Tensor) -> torch.Tensor:
    """Per-slot rings: pool ``(NP, *mid, T, F)`` gathered by ``pages (B,
    P)`` -> ``(B, *mid, P*T, F)``, the dense ring layout the decode
    attention reads."""
    g = pool[pages.long()]                  # (B, P, *mid, T, F)
    nm = g.ndim - 4                         # number of *mid axes
    g = g.permute((0,) + tuple(range(2, 2 + nm)) + (1, 2 + nm, 3 + nm))
    sh = g.shape
    return g.reshape(sh[:-3] + (sh[-3] * sh[-2], sh[-1]))


def write_coords(pos: torch.Tensor, live: Optional[torch.Tensor], pages: torch.Tensor,
                 page_size: int, num_pages: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-slot ``(physical page, in-page offset)`` of a decode write.

    ``pos (B,)`` positions, ``pages (B, P)`` the table.  Rows that must not
    write (``live=False``, a position past the table, or an entry mapped to
    the NULL page) get page ``num_pages``, out of bounds, so the writer
    drops them; the NULL page is never written.

    ``pos`` may also be ``(B, W)``: the speculative verify writes ``W``
    consecutive entries a slot in one scatter.  The coordinates are then
    ``(B, W)`` under the same drop rules entry by entry, ``live`` masking
    whole slots.  A write past the slot's mapped pages is dropped, never
    undone: rejected draft positions stay masked (``<= pos``) until later
    writes overwrite them.
    """
    pos = pos.to(torch.int64)
    P = pages.shape[1]
    S = P * page_size
    vec = pos.ndim == 1
    posw = pos[:, None] if vec else pos                               # (B, W)
    wpos = posw if live is None else torch.where(live[:, None], posw, torch.full_like(posw, S))
    pidx = torch.clamp(torch.div(wpos, page_size, rounding_mode="floor"), 0, P - 1)
    phys = torch.gather(pages.long(), 1, pidx)
    drop = (wpos >= S) | (phys == 0)
    phys = torch.where(drop, torch.full_like(phys, num_pages), phys)
    off = wpos % page_size
    return (phys[:, 0], off[:, 0]) if vec else (phys, off)


def write_pages(pool: torch.Tensor, phys: torch.Tensor, off: torch.Tensor,
                new: torch.Tensor) -> None:
    """``pool[phys[i], ..., off[i], :] = new[i]`` in place for every entry
    ``i`` (one a slot, ``(B,)``, or ``(B, W)``) whose ``phys`` is a page of
    the pool; entries at the sentinel are dropped.  ``pool (NP, *mid, T,
    F)``, ``new (*phys.shape, *mid, F)``.  No host sync: a dropped entry
    writes the NULL page's own zeros back to it (no live entry ever targets
    page 0, so their duplicate indices all write the same zeros)."""
    keep = phys < pool.shape[0]
    at = torch.where(keep, phys, torch.zeros_like(phys))
    view = pool.movedim(-2, 1)              # (NP, T, *mid, F): the indexed axes lead
    old = view[at, off]                     # (*phys.shape, *mid, F)
    mask = keep.reshape(keep.shape + (1,) * (old.ndim - keep.ndim))
    view[at, off] = torch.where(mask, new.to(pool.dtype), old)


def scatter_prefill(pool: torch.Tensor, pf: torch.Tensor, wp_flat: torch.Tensor) -> torch.Tensor:
    """Scatter an admission's prefill cache into the page pool, in place.

    ``pool (X, NP, *mid, T, F)``; ``pf (X, B, *mid, Sp, F)`` with the
    prefill width ``Sp = n_pp * T``; ``wp_flat (B * n_pp,)`` maps slot
    ``b``'s prompt page ``j`` (flattened ``b * n_pp + j``) to its physical
    page, or to ``NP`` (dropped) for pages that must not be written: slots
    not being admitted, the junk tail past a short prompt, and prefix-shared
    pages (read-only, already holding the same bits).  Returns ``pool``.
    """
    X, B = pf.shape[0], pf.shape[1]
    T, F = pool.shape[-2], pool.shape[-1]
    mid = tuple(pf.shape[2:-2])
    n_pp = pf.shape[-2] // T
    nm = len(mid)
    x = pf.reshape((X, B) + mid + (n_pp, T, F))
    x = x.permute((0, 1, 2 + nm) + tuple(range(2, 2 + nm)) + (3 + nm, 4 + nm))
    x = x.reshape((X, B * n_pp) + mid + (T, F))
    wp = wp_flat.to(device=pool.device, dtype=torch.int64)
    keep = wp < pool.shape[1]
    pool[:, wp[keep]] = x[:, keep].to(pool.dtype)
    return pool
