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

On a serving mesh a pool may lie on the ``data`` rows
(``dist.sharding.Rows``, a contiguous block of pages a row) while the
allocator's page ids stay the reference's, so a slot's table may map a
page that another row owns.  A row's decode then routes through
:class:`RowRoute`: each new entry is written into its page's owner, and
each mapped page of the row's slots is read from its owner (the NULL page
is the zeros it holds, read nowhere); ``cross_row_bytes`` counts the bytes
that cross rows, 0 when every page of a row's slots is its own.
:func:`scatter_prefill` sends each prompt page to its owner.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.dist import sharding as shd

# bytes the decode's page traffic moved between data rows (RowRoute): a
# plain int, read and reset by the serving engine around each step
cross_row_bytes = 0


def gather_pages(pool: torch.Tensor, pages: torch.Tensor) -> torch.Tensor:
    """Per-slot rings: pool ``(NP, *mid, T, F)`` gathered by ``pages (B,
    P)`` -> ``(B, *mid, P*T, F)``, the dense ring layout the decode
    attention reads."""
    return _ring_view(pool[pages.long()])


def _ring_view(g: torch.Tensor) -> torch.Tensor:
    """Gathered pages ``(B, P, *mid, T, F)`` as rings ``(B, *mid, P*T, F)``."""
    nm = g.ndim - 4                         # number of *mid axes
    g = g.permute((0,) + tuple(range(2, 2 + nm)) + (1, 2 + nm, 3 + nm))
    sh = g.shape
    return g.reshape(sh[:-3] + (sh[-3] * sh[-2], sh[-1]))


class RowRoute:
    """One data row's paged write and gather over a pool placed on the rows
    (a ``dist.sharding.Rows`` along the page axis): ``phys``/``off`` (the
    row's :func:`write_coords`, ``(B_r,)`` or ``(B_r, W)``) and ``pages
    (B_r, P)`` (its slots' table rows, global page ids) are copied to the
    host once and split by the row owning each page.  Entries at the
    sentinel and NULL pages route nowhere.  Shared by every leaf of a
    layer's cache (they have one page axis)."""

    def __init__(self, pool, row: int, phys: torch.Tensor, off: torch.Tensor,
                 pages: torch.Tensor):
        self.row, self.dev, self.table = row, pages.device, tuple(pages.shape)
        self.n_lead = phys.ndim
        ph = phys.reshape(-1).cpu().numpy()
        of = off.reshape(-1).cpu().numpy()
        pg = pages.reshape(-1).cpu().numpy()
        self.writes, self.reads = [], []
        for o, blk in enumerate(pool.blocks):
            lo, hi = pool.starts[o], pool.starts[o + 1]
            w = np.nonzero((ph >= lo) & (ph < hi))[0]
            g = np.nonzero((pg >= lo) & (pg < hi) & (pg != 0))[0]
            dev = blk.device
            if w.size:
                self.writes.append((o, torch.from_numpy(w).to(self.dev),
                                    torch.from_numpy(ph[w] - lo).to(dev),
                                    torch.from_numpy(of[w]).to(dev)))
            if g.size:
                self.reads.append((o, torch.from_numpy(g).to(self.dev),
                                   torch.from_numpy(pg[g] - lo).to(dev)))

    def write(self, pool, new: torch.Tensor) -> None:
        """:func:`write_pages` of ``new (*phys.shape, *mid, F)`` into the
        owners' blocks, in place."""
        global cross_row_bytes
        flat = new.reshape((-1,) + tuple(new.shape[self.n_lead:]))
        for o, sel, at, off in self.writes:
            blk = pool.row(o)
            val = flat.index_select(0, sel).to(blk.device).to(blk.dtype)
            blk.movedim(-2, 1)[at, off] = val
            if o != self.row:
                cross_row_bytes += val.numel() * val.element_size()

    def gather(self, pool) -> torch.Tensor:
        """:func:`gather_pages` of the row's table from the owners' blocks:
        ``(B_r, *mid, P*T, F)`` on the row's device."""
        global cross_row_bytes
        page = tuple(pool.row(0).shape[1:])                 # (*mid, T, F)
        out = torch.zeros((self.table[0] * self.table[1],) + page, dtype=pool.dtype,
                          device=self.dev)
        for o, sel, at in self.reads:
            got = pool.row(o).index_select(0, at)
            if o != self.row:
                cross_row_bytes += got.numel() * got.element_size()
            out[sel] = got.to(self.dev)
        return _ring_view(out.reshape(self.table + page))


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
    pages (read-only, already holding the same bits).  A pool on the data
    rows takes each page into its owner's block.  Returns ``pool``.
    """
    X, B = pf.shape[0], pf.shape[1]
    T, F = pool.shape[-2], pool.shape[-1]
    mid = tuple(pf.shape[2:-2])
    n_pp = pf.shape[-2] // T
    nm = len(mid)
    x = pf.reshape((X, B) + mid + (n_pp, T, F))
    x = x.permute((0, 1, 2 + nm) + tuple(range(2, 2 + nm)) + (3 + nm, 4 + nm))
    x = x.reshape((X, B * n_pp) + mid + (T, F))
    wp = wp_flat.to(device=x.device, dtype=torch.int64)
    if isinstance(pool, shd.Rows):                 # each page to the row that owns it
        for o, blk in enumerate(pool.blocks):
            keep = (wp >= pool.starts[o]) & (wp < pool.starts[o + 1])
            blk[:, (wp[keep] - pool.starts[o]).to(blk.device)] = \
                x[:, keep].to(blk.device).to(blk.dtype)
        return pool
    wp = wp.to(pool.device)
    keep = wp < pool.shape[1]
    pool[:, wp[keep]] = x[:, keep].to(pool.dtype)
    return pool
