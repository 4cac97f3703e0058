"""Radix prefix index over token sequences at page granularity.

A copy of ``repro.cache.radix`` (pure Python).

Each node caches exactly one **full** page of ``page_size`` tokens; a
node's logical key is the concatenation of the per-node token tuples on its
root path, so walking the tree IS longest-prefix matching in units of whole
pages.  Only full pages are indexable: a partially-filled prompt tail (and
every decode-produced token) depends on content that keeps changing, so it
never enters the index — matching therefore can never return more than
``len(tokens) // page_size`` pages, and every matched page's content is
immutable prompt KV.

Insertion keeps the **first** page ever indexed for a given token path
(first-writer-wins): a duplicate prompt admitted without sharing produces a
bit-identical page, so re-pointing the node would only churn; the caller
learns which of its pages were newly indexed from the return value and
frees the rest normally at release.

Eviction is leaf-first LRU: only nodes with no children may be removed
(an interior node's token path is a dependency of every descendant), and
the owner passes an ``evictable`` predicate so only refcount-0 resident
pages are reclaimed.  Matching bumps the LRU clock of every node on the
matched path, so hot shared prefixes survive pressure.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple


class _Node:
    __slots__ = ("key", "page", "children", "siblings", "last_use")

    def __init__(self, key: Tuple[int, ...], page: int,
                 siblings: Dict[Tuple[int, ...], "_Node"], clock: int):
        self.key = key                  # this node's page_size-token tuple
        self.page = page                # physical page caching those tokens
        self.children: Dict[Tuple[int, ...], _Node] = {}
        self.siblings = siblings        # the dict this node lives in
        self.last_use = clock


class RadixIndex:
    def __init__(self, page_size: int):
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.page_size = page_size
        self._children: Dict[Tuple[int, ...], _Node] = {}   # root level
        self._by_page: Dict[int, _Node] = {}
        self._clock = 0

    def __len__(self) -> int:
        return len(self._by_page)

    def __contains__(self, page: int) -> bool:
        return page in self._by_page

    def _keys(self, tokens: Sequence[int]) -> List[Tuple[int, ...]]:
        T = self.page_size
        return [tuple(int(t) for t in tokens[i * T:(i + 1) * T])
                for i in range(len(tokens) // T)]

    def match(self, tokens: Sequence[int]) -> List[int]:
        """Pages caching the longest full-page prefix of ``tokens``.

        Returns ``[p_0, .., p_{m-1}]`` where page ``p_j`` holds tokens
        ``[j*T, (j+1)*T)``; every node on the path gets its LRU clock
        bumped.  ``m <= len(tokens) // page_size`` by construction.
        """
        self._clock += 1
        out: List[int] = []
        level = self._children
        for key in self._keys(tokens):
            node = level.get(key)
            if node is None:
                break
            node.last_use = self._clock
            out.append(node.page)
            level = node.children
        return out

    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> Set[int]:
        """Index ``pages[j]`` as the cache of tokens ``[j*T, (j+1)*T)``.

        Walks the existing path; where a node already exists its page is
        kept (first-writer-wins) and ``pages[j]`` is ignored; new nodes are
        chained below.  Returns the set of pages actually indexed — the
        caller keeps those resident at release and frees the rest.
        """
        keys = self._keys(tokens)
        if len(pages) > len(keys):
            raise ValueError(f"{len(pages)} pages for "
                             f"{len(keys)} full pages of tokens")
        self._clock += 1
        indexed: Set[int] = set()
        level = self._children
        for key, page in zip(keys, pages):
            node = level.get(key)
            if node is None:
                if page in self._by_page:
                    raise ValueError(f"page {page} is already indexed")
                node = _Node(key, int(page), level, self._clock)
                level[key] = node
                self._by_page[int(page)] = node
                indexed.add(int(page))
            else:
                node.last_use = self._clock
            level = node.children
        return indexed

    def remove(self, page: int) -> None:
        """Drop a leaf node by its page id (eviction)."""
        node = self._by_page.get(page)
        if node is None:
            raise KeyError(f"page {page} is not indexed")
        if node.children:
            raise ValueError(f"page {page} backs an interior node "
                             "(evict its descendants first)")
        del node.siblings[node.key]
        del self._by_page[page]

    def evict_lru(self, evictable: Callable[[int], bool]) -> Optional[int]:
        """Remove and return the least-recently-used evictable **leaf**
        page, or None if nothing qualifies.

        Leaf-first keeps every surviving node's full token path intact;
        repeated calls drain a cold branch bottom-up.
        """
        best: Optional[_Node] = None
        for node in self._by_page.values():
            if node.children or not evictable(node.page):
                continue
            if best is None or node.last_use < best.last_use:
                best = node
        if best is None:
            return None
        self.remove(best.page)
        return best.page
