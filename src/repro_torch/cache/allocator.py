"""Fixed-size page allocator: free list + per-page refcounts.

A copy of ``repro.cache.allocator`` (pure Python; the port imports nothing
of the reference).

Pure host-side bookkeeping over integer page ids ``[0, num_pages)``.  The
physical pages live on device as the leading axis of the paged cache pools
(``models/serving.init_paged_caches``); this class only decides who owns which
id.  Page ids in ``reserved`` (by default :data:`NULL_PAGE` = 0) are never
handed out: unmapped page-table entries point at the NULL page, which is
never written, so gathering through an unmapped entry reads exact zeros —
the empty-slot convention of the dense ring, preserved per page.

States of a page id:

* **free** — on the free list, refcount 0; ``alloc`` hands it out;
* **referenced** — refcount >= 1 (one count per slot mapping it; prefix
  sharing bumps it via ``retain``);
* **unreferenced** — refcount 0 but *not* on the free list: the owner
  (PagePool) decides whether to ``free`` it or keep it resident in the
  radix index for reuse (``revive`` takes it back to refcount 1).

Every transition is guarded: freeing a page twice, freeing a referenced
page, releasing below zero, or retaining a non-referenced page raises —
``tests/test_torch_cache.py`` drives these paths with randomized
interleavings, against the reference's classes.
"""
from __future__ import annotations

from collections import deque
from typing import Iterable, List

NULL_PAGE = 0


class PageError(RuntimeError):
    """Base class for page-accounting violations."""


class DoubleFree(PageError):
    """A page was freed while free, or released below refcount 0."""


class PagesExhausted(PageError):
    """No free (or reclaimable) page satisfies an allocation."""


class PageAllocator:
    def __init__(self, num_pages: int, reserved: Iterable[int] = (NULL_PAGE,)):
        if num_pages < 2:
            raise ValueError("need at least one allocatable page beyond the "
                             f"reserved NULL page (num_pages={num_pages})")
        self.num_pages = num_pages
        self._reserved = frozenset(reserved)
        for p in self._reserved:
            if not 0 <= p < num_pages:
                raise ValueError(f"reserved page {p} out of range")
        self.refcount: List[int] = [0] * num_pages
        self._free = deque(p for p in range(num_pages)
                           if p not in self._reserved)
        self._free_set = set(self._free)

    # -- queries -------------------------------------------------------------
    @property
    def num_allocatable(self) -> int:
        return self.num_pages - len(self._reserved)

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        """Pages holding data: referenced or unreferenced-but-not-freed."""
        return self.num_allocatable - len(self._free)

    def is_free(self, page: int) -> bool:
        return page in self._free_set

    def _check(self, page: int) -> None:
        if not 0 <= page < self.num_pages or page in self._reserved:
            raise PageError(f"page {page} is not an allocatable id")

    # -- transitions ---------------------------------------------------------
    def alloc(self) -> int:
        """Pop a free page; it comes back referenced (refcount 1)."""
        if not self._free:
            raise PagesExhausted(
                f"all {self.num_allocatable} pages are in use")
        page = self._free.popleft()
        self._free_set.discard(page)
        self.refcount[page] = 1
        return page

    def retain(self, page: int) -> None:
        """Add a sharer to a referenced page (prefix-sharing refcount bump)."""
        self._check(page)
        if self.refcount[page] < 1:
            raise PageError(f"retain of non-referenced page {page}")
        self.refcount[page] += 1

    def revive(self, page: int) -> None:
        """Re-reference an unreferenced (radix-resident) page: 0 -> 1."""
        self._check(page)
        if self.refcount[page] != 0 or page in self._free_set:
            raise PageError(f"revive of page {page} in state "
                            f"refcount={self.refcount[page]} "
                            f"free={page in self._free_set}")
        self.refcount[page] = 1

    def release(self, page: int) -> int:
        """Drop one reference; returns the remaining count.  At zero the
        caller decides: ``free`` it, or keep it resident for reuse."""
        self._check(page)
        if self.refcount[page] < 1:
            raise DoubleFree(f"release of page {page} with refcount "
                             f"{self.refcount[page]}")
        self.refcount[page] -= 1
        return self.refcount[page]

    def free(self, page: int) -> None:
        """Return an unreferenced page to the free list."""
        self._check(page)
        if self.refcount[page] != 0:
            raise PageError(f"free of page {page} with refcount "
                            f"{self.refcount[page]}")
        if page in self._free_set:
            raise DoubleFree(f"page {page} freed twice")
        self._free.append(page)
        self._free_set.add(page)
