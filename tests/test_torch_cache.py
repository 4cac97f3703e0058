"""The port's paged-cache bookkeeping and page plumbing against the JAX
reference's (``repro_torch.cache`` against ``repro.cache``).

* ``PageAllocator``, ``RadixIndex`` and ``PagePool`` run the same randomized
  operation sequences as the reference's classes, step by step, with the
  same results: return values, raised error types, refcounts, free lists,
  resident sets and eviction counts (the sequences of the reference's own
  ``tests/test_paged_cache.py``, driven here on both at once).
* ``gather_pages``, ``write_coords``, ``write_pages`` and
  ``scatter_prefill`` on torch tensors equal the reference's jnp helpers
  exactly on seeded inputs, drop sentinels included (the port writes in
  place where the reference returns a new pool).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import cache as jcache
from repro_torch import cache as tcache
from repro_torch.cache import paged
from torch_port_helpers import one_torch_thread  # noqa: F401  (autouse)


def _both(fn_j, fn_t):
    """Run the same operation on the reference and on the port: both return
    the same value, or both raise the same error type."""
    out = []
    for fn in (fn_j, fn_t):
        try:
            out.append(("ok", fn()))
        except Exception as e:                  # noqa: BLE001 - compared by type name
            out.append(("raise", type(e).__name__))
    assert out[0] == out[1], out
    return out[1]


def test_error_types_mirror_the_reference():
    for name in ("PageError", "DoubleFree", "PagesExhausted"):
        assert issubclass(getattr(tcache, name), RuntimeError)
    assert issubclass(tcache.DoubleFree, tcache.PageError)
    assert issubclass(tcache.PagesExhausted, tcache.PageError)
    assert tcache.NULL_PAGE == jcache.NULL_PAGE == 0
    for cls in (jcache.PageAllocator, tcache.PageAllocator):
        with pytest.raises(ValueError):
            cls(1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_randomized_sequence_matches_reference(seed):
    """Random alloc / retain / release / free / revive on any page id (so
    the guards fire too), on both allocators at once."""
    rng = np.random.default_rng(seed)
    ja, ta = jcache.PageAllocator(9), tcache.PageAllocator(9)
    for _ in range(1500):
        op = int(rng.integers(0, 5))
        p = int(rng.integers(0, 10))
        name = ("alloc", "retain", "release", "free", "revive")[op]
        if name == "alloc":
            _both(ja.alloc, ta.alloc)
        else:
            _both(lambda: getattr(ja, name)(p), lambda: getattr(ta, name)(p))
        assert ja.refcount == ta.refcount
        assert (ja.free_count, ja.in_use) == (ta.free_count, ta.in_use)
        assert list(ja._free) == list(ta._free)


@pytest.mark.parametrize("page_size", [1, 2, 3])
def test_radix_randomized_sequence_matches_reference(page_size):
    """Random inserts, matches and LRU evictions over a tiny alphabet (so
    prefixes collide all the time), on both indexes at once."""
    rng = np.random.default_rng(page_size)
    ji, ti = jcache.RadixIndex(page_size), tcache.RadixIndex(page_size)
    next_page = 1
    for _ in range(600):
        toks = rng.integers(0, 3, int(rng.integers(0, 10))).tolist()
        r = rng.random()
        if r < 0.45:
            n = len(toks) // page_size - int(rng.integers(0, 2))
            pages = list(range(next_page, next_page + max(n, 0)))
            if rng.random() < 0.1 and next_page > 1:
                pages = [1] + pages[1:]          # an already-indexed page: raises
            _both(lambda: ji.insert(toks, pages), lambda: ti.insert(toks, pages))
            next_page += len(pages)
        elif r < 0.85:
            _both(lambda: ji.match(toks), lambda: ti.match(toks))
        else:
            keep = int(rng.integers(0, next_page + 1))
            _both(lambda: ji.evict_lru(lambda p: p != keep),
                  lambda: ti.evict_lru(lambda p: p != keep))
        assert len(ji) == len(ti)
        assert all((p in ji) == (p in ti) for p in range(next_page + 1))


@pytest.mark.parametrize("sharing", [True, False])
def test_pool_randomized_lifecycle_matches_reference(sharing):
    """Admissions (match, acquire, alloc with eviction, index), lazy decode
    allocations and releases of whole slots, as the scheduler drives them,
    on both pools at once."""
    rng = np.random.default_rng(7 + sharing)
    T = 2
    jp, tp = (cls(12, page_size=T, prefix_sharing=sharing)
              for cls in (jcache.PagePool, tcache.PagePool))
    slots_j, slots_t = [], []                   # page rows held by live "slots"
    prompts = [rng.integers(0, 3, int(rng.integers(1, 9))).tolist() for _ in range(6)]
    for _ in range(800):
        r = rng.random()
        if r < 0.4:                             # admit a prompt
            toks = prompts[int(rng.integers(0, len(prompts)))]
            mj = _both(lambda: jp.match_prefix(toks), lambda: tp.match_prefix(toks))
            if mj[0] != "ok":
                continue
            matched = mj[1]
            _both(lambda: jp.acquire(matched), lambda: tp.acquire(matched))
            n = -(-len(toks) // T) - len(matched)
            got = _both(lambda: jp.alloc(n), lambda: tp.alloc(n))
            if got[0] != "ok":
                _both(lambda: jp.release(matched), lambda: tp.release(matched))
                continue
            row = list(matched) + got[1]
            _both(lambda: jp.index_prompt(toks, row[:len(toks) // T]),
                  lambda: tp.index_prompt(toks, row[:len(toks) // T]))
            slots_j.append(list(row))
            slots_t.append(list(row))
        elif r < 0.6 and slots_j:               # a lazy decode page
            i = int(rng.integers(0, len(slots_j)))
            got = _both(lambda: jp.alloc(1), lambda: tp.alloc(1))
            if got[0] == "ok":
                slots_j[i] += got[1]
                slots_t[i] += got[1]
        elif slots_j:                           # a slot finishes
            i = int(rng.integers(0, len(slots_j)))
            rj, rt = slots_j.pop(i), slots_t.pop(i)
            _both(lambda: jp.release(rj), lambda: tp.release(rt))
        assert (jp.available, jp.in_use, jp.capacity, jp.evictions) == \
            (tp.available, tp.in_use, tp.capacity, tp.evictions)
        assert jp._resident == tp._resident
        assert jp.allocator.refcount == tp.allocator.refcount


# ---------------------------------------------------------------------------
# Device helpers: the same arrays as the reference's, drop sentinels included
# ---------------------------------------------------------------------------

def _pages(rng, B, P, NP):
    pages = rng.integers(0, NP, (B, P)).astype(np.int32)
    pages[rng.random((B, P)) < 0.25] = 0        # unmapped entries -> the NULL page
    return pages


@pytest.mark.parametrize("mid", [(), (2,), (2, 3)])
def test_gather_pages_equals_reference(mid):
    rng = np.random.default_rng(len(mid))
    NP, T, F, B, P = 7, 4, 5, 3, 4
    pool = rng.standard_normal((NP,) + mid + (T, F)).astype(np.float32)
    pool[0] = 0.0
    pages = _pages(rng, B, P, NP)
    want = np.asarray(jcache.gather_pages(jnp.asarray(pool), jnp.asarray(pages)))
    got = paged.gather_pages(torch.from_numpy(pool), torch.from_numpy(pages)).numpy()
    assert got.shape == want.shape == (B,) + mid + (P * T, F)
    assert got.tobytes() == want.tobytes()


def test_write_coords_equals_reference():
    rng = np.random.default_rng(3)
    NP, T, B, P = 9, 4, 8, 3
    for _ in range(20):
        pages = _pages(rng, B, P, NP)
        pos = rng.integers(0, P * T + 3, B).astype(np.int32)   # some past the table
        for live in (None, rng.random(B) < 0.7):
            jl = None if live is None else jnp.asarray(live)
            tl = None if live is None else torch.from_numpy(live)
            jphys, joff = jcache.write_coords(jnp.asarray(pos), jl, jnp.asarray(pages), T, NP)
            tphys, toff = paged.write_coords(torch.from_numpy(pos), tl,
                                             torch.from_numpy(pages), T, NP)
            np.testing.assert_array_equal(tphys.numpy(), np.asarray(jphys))
            np.testing.assert_array_equal(toff.numpy(), np.asarray(joff))


@pytest.mark.parametrize("mid", [(), (2,)])
def test_write_pages_equals_the_references_drop_scatter(mid):
    """The decode write through ``write_coords``: live rows land, dead rows,
    rows past the table and rows on the NULL page drop, and page 0 stays
    zero, as the reference's ``.at[phys, :, off].set(mode="drop")``."""
    rng = np.random.default_rng(4)
    NP, T, F, B, P = 9, 4, 3, 6, 3
    for _ in range(10):
        pool = rng.standard_normal((NP,) + mid + (T, F)).astype(np.float32)
        pool[0] = 0.0
        # distinct writable pages per row, as the scheduler maps them
        pages = np.zeros((B, P), np.int32)
        perm = rng.permutation(np.arange(1, NP))
        for b in range(B):
            pages[b, rng.integers(0, P)] = perm[b % len(perm)]
        pos = rng.integers(0, P * T + 2, B).astype(np.int32)
        live = rng.random(B) < 0.8
        new = rng.standard_normal((B,) + mid + (F,)).astype(np.float32)
        jphys, joff = jcache.write_coords(jnp.asarray(pos), jnp.asarray(live),
                                          jnp.asarray(pages), T, NP)
        jpool = jnp.asarray(pool)
        if mid:
            want = jpool.at[jphys, :, joff].set(jnp.asarray(new), mode="drop")
        else:
            want = jpool.at[jphys, joff].set(jnp.asarray(new), mode="drop")
        tpool = torch.from_numpy(pool.copy())
        tphys, toff = paged.write_coords(torch.from_numpy(pos), torch.from_numpy(live),
                                         torch.from_numpy(pages), T, NP)
        paged.write_pages(tpool, tphys, toff, torch.from_numpy(new))
        assert tpool.numpy().tobytes() == np.asarray(want).tobytes()
        assert not tpool[0].any()


@pytest.mark.parametrize("mid", [(), (2,)])
def test_scatter_prefill_equals_reference(mid):
    rng = np.random.default_rng(5)
    X, B, T, F, NP, n_pp = 2, 3, 2, 3, 8, 3
    pool = rng.standard_normal((X, NP) + mid + (T, F)).astype(np.float32)
    pool[:, 0] = 0.0
    pf = rng.standard_normal((X, B) + mid + (n_pp * T, F)).astype(np.float32)
    wp = np.full(B * n_pp, NP, np.int32)        # the sentinel: dropped
    owned = rng.permutation(np.arange(1, NP))
    for j, page in zip(rng.choice(B * n_pp, 5, replace=False), owned):
        wp[j] = page
    want = np.asarray(jcache.scatter_prefill(jnp.asarray(pool), jnp.asarray(pf),
                                             jnp.asarray(wp)))
    tpool = torch.from_numpy(pool.copy())
    out = paged.scatter_prefill(tpool, torch.from_numpy(pf), torch.from_numpy(wp))
    assert out is tpool
    assert out.numpy().tobytes() == want.tobytes()
