"""Paged KV cache: fixed-size page allocator, radix prefix index, and the
device-side page gather/scatter helpers.

Counterpart of ``repro.cache``.  The dense ``(max_slots, max_len)`` slot
pool budgets cache memory for the worst-case request and stores identical
system-prompt prefixes once per slot.  This package splits every slot ring
into fixed-size pages:

* :class:`PageAllocator`: free list and per-page refcounts over one
  physical page pool (page 0 is the NULL page: never allocated, never
  written, always zero; unmapped page-table entries point at it);
* :class:`RadixIndex`: a radix tree over token sequences at page
  granularity, so admission can map a request's cached prompt pages
  copy-free (a refcount bump, no prefill for the cached prefix);
* :class:`PagePool`: the host-side coordinator the scheduler talks to:
  longest-prefix match, acquire, alloc and release, and LRU reclaim of
  refcount-0 radix-resident pages under allocation pressure;
* :mod:`repro_torch.cache.paged`: the gather/scatter index plumbing on
  torch tensors (``models/attention.py`` threads it through ``gqa_decode``
  and ``mla_decode``).

Allocator, radix index and pool are pure host Python, copies of the
reference's; ``tests/test_torch_cache.py`` runs them against the
reference's classes on the same randomized operation sequences.
"""
from repro_torch.cache.allocator import (DoubleFree, NULL_PAGE, PageAllocator, PageError,
                                         PagesExhausted)
from repro_torch.cache.paged import gather_pages, scatter_prefill, write_coords, write_pages
from repro_torch.cache.pool import PagePool
from repro_torch.cache.radix import RadixIndex

__all__ = [
    "DoubleFree", "NULL_PAGE", "PageAllocator", "PageError", "PagesExhausted", "PagePool",
    "RadixIndex", "gather_pages", "scatter_prefill", "write_coords", "write_pages",
]
