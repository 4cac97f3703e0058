"""PagePool — the host-side page manager the serving scheduler talks to.

A copy of ``repro.cache.pool``.

Coordinates the :class:`~repro_torch.cache.allocator.PageAllocator` (who owns
which physical page) with the :class:`~repro_torch.cache.radix.RadixIndex` (which
pages cache which token prefixes) under one lifecycle:

* **admission** — ``match_prefix`` finds the request's longest cached
  full-page prompt prefix; ``acquire`` maps those pages copy-free
  (refcount bump; a radix-*resident* refcount-0 page is revived);
  ``alloc`` hands out fresh pages for the rest, evicting cold resident
  pages LRU-leaf-first under pressure; ``index_prompt`` then publishes the
  request's full prompt pages so later arrivals can share them;
* **decode** — the scheduler lazily ``alloc``-s one page whenever a slot's
  position crosses a page boundary;
* **release** — each page drops one reference; at refcount 0 an *indexed*
  page stays resident (reclaimable cache — the radix keeps serving it to
  future admissions until evicted), anything else returns to the free
  list.

``available`` counts free + resident pages: residency is closed under
descendants (a slot sharing page *j* of a prefix always also shares pages
``< j``, so a refcount-0 node can never have a referenced child), which
makes the whole resident set drainable by leaf-first eviction — the
scheduler's reservation accounting relies on that exactness.
"""
from __future__ import annotations

from typing import Iterable, List, Sequence, Set

from repro_torch.cache.allocator import (NULL_PAGE, PageAllocator, PagesExhausted)
from repro_torch.cache.radix import RadixIndex


class PagePool:
    def __init__(self, num_pages: int, page_size: int,
                 prefix_sharing: bool = True, pad_to: int = 1):
        """``pad_to``: round ``num_pages`` up to the next multiple (the mesh
        engine's auto-sized pool pads to the ``data`` axis, along which the
        reference shards the physical-page axis; extra pages just enlarge
        the free list)."""
        if pad_to > 1:
            num_pages += (-num_pages) % pad_to
        self.page_size = page_size
        self.allocator = PageAllocator(num_pages, reserved=(NULL_PAGE,))
        self.radix = RadixIndex(page_size) if prefix_sharing else None
        self._resident: Set[int] = set()    # refcount-0 pages kept for reuse
        self.evictions = 0

    # -- queries -------------------------------------------------------------
    @property
    def num_pages(self) -> int:
        return self.allocator.num_pages

    @property
    def capacity(self) -> int:
        return self.allocator.num_allocatable

    @property
    def available(self) -> int:
        """Pages an admission could obtain: free now or evictable."""
        return self.allocator.free_count + len(self._resident)

    @property
    def in_use(self) -> int:
        """Pages holding live data (referenced or radix-resident) — the
        resident-KV-bytes metric is ``in_use * bytes_per_page``."""
        return self.allocator.in_use

    def is_resident(self, page: int) -> bool:
        return page in self._resident

    # -- admission -----------------------------------------------------------
    def match_prefix(self, tokens: Sequence[int]) -> List[int]:
        """Longest cached full-page prompt prefix (may be empty)."""
        if self.radix is None:
            return []
        return self.radix.match(tokens)

    def acquire(self, pages: Iterable[int]) -> None:
        """Map matched pages into a slot: one reference each.  Resident
        pages leave the reclaimable set (they are live again)."""
        for p in pages:
            if p in self._resident:
                self._resident.discard(p)
                self.allocator.revive(p)
            else:
                self.allocator.retain(p)

    def alloc(self, n: int = 1) -> List[int]:
        """n fresh referenced pages, evicting cold resident pages LRU
        leaf-first when the free list runs dry."""
        out = []
        for _ in range(n):
            if self.allocator.free_count == 0:
                victim = None
                if self.radix is not None:
                    victim = self.radix.evict_lru(self._resident.__contains__)
                if victim is None:
                    raise PagesExhausted(
                        f"no free or reclaimable page "
                        f"({self.in_use}/{self.capacity} in use)")
                self._resident.discard(victim)
                self.allocator.free(victim)
                self.evictions += 1
            out.append(self.allocator.alloc())
        return out

    def index_prompt(self, tokens: Sequence[int],
                     pages: Sequence[int]) -> Set[int]:
        """Publish a request's full prompt pages for future sharing.
        Returns the subset actually indexed (paths already cached keep
        their first page)."""
        if self.radix is None:
            return set()
        return self.radix.insert(tokens, pages)

    # -- release -------------------------------------------------------------
    def release(self, pages: Iterable[int]) -> None:
        """Drop one reference per page; last release frees (or, for
        indexed pages, parks resident for reuse)."""
        for p in pages:
            if self.allocator.release(p) == 0:
                if self.radix is not None and p in self.radix:
                    self._resident.add(p)
                else:
                    self.allocator.free(p)
