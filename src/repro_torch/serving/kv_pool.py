"""Paged KV pool: page allocator + prefix-sharing radix tree (host side).

Own copy of ``repro.serving.kv_pool`` (numpy-only).

**PagePool** -- free-list allocator with refcounts and reservations.

  * Page 0 is a **sentinel**: never allocated.  Retired slots' block-table
    rows point at it, so masked writes of empty or frozen slots land on a
    page nobody reads.
  * ``refcount[p]`` counts holders: each slot using the page, plus 1 if the
    radix tree caches it.  ``decref`` to zero returns the page.
  * **Reservations**: a request is admitted only if the pool can cover its
    worst-case page need, but pages are allocated just ahead of the decode
    loops; ``available`` (free minus reserved) is what admission may spend.

**RadixCache** -- prefix tree over page-aligned prompt token chunks.  A node
is one *full* page (key: its ``page_size`` token ids); ``match`` walks the
longest cached prefix, ``insert`` caches a prompt's full pages (the tree
holds its own reference), ``evict`` frees least-recently-used tree-only
leaves.
"""
from __future__ import annotations

import heapq
from typing import Iterable, Optional, Sequence

import numpy as np

__all__ = ["PageAllocError", "PagePool", "RadixCache", "SENTINEL_PAGE"]

#: Physical page reserved as the write sink for empty/frozen slots.
SENTINEL_PAGE = 0


class PageAllocError(RuntimeError):
    """Page allocation failed: the pool is exhausted, or an armed fault
    injector fired ``pool/alloc_fail`` (a transient allocator fault).
    Callers unwind their partial holds and block admission, or quarantine
    the affected slot."""


class PagePool:
    """Fixed-size physical page allocator with refcounts and reservations."""

    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2 or page_size < 1:
            raise ValueError("pool needs the sentinel plus >= 1 real page")
        self.num_pages = num_pages
        self.page_size = page_size
        self.refcount = np.zeros((num_pages,), np.int64)
        # LIFO free list (pop from the end); sentinel page 0 excluded
        self._free = list(range(num_pages - 1, 0, -1))
        self.reserved = 0
        #: optional ``FaultInjector``: when armed, ``pool/alloc_fail`` makes
        #: ``alloc`` raise ``PageAllocError``
        self.fault_injector = None

    @property
    def available(self) -> int:
        """Pages admission may still promise (free minus already-reserved)."""
        return len(self._free) - self.reserved

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - 1 - len(self._free)

    def occupancy(self) -> dict:
        """Capacity snapshot keyed by the ``engine/pool/*`` gauge suffixes."""
        return {
            "pages_in_use": self.pages_in_use,
            "available": self.available,
            "reserved": self.reserved,
        }

    def pages_for(self, tokens: int) -> int:
        """Physical pages needed to back ``tokens`` KV entries."""
        return -(-tokens // self.page_size)

    def reserve(self, n: int) -> None:
        assert n >= 0 and self.available >= n, (
            f"reserve({n}) with only {self.available} available"
        )
        self.reserved += n

    def unreserve(self, n: int) -> None:
        assert 0 <= n <= self.reserved
        self.reserved -= n

    def alloc(self, n: int, *, reserved: bool = False) -> list[int]:
        """Pop ``n`` free pages (refcount 1 each).  ``reserved=True`` converts
        previously-reserved pages (the lazy top-up path); otherwise the pages
        must fit in ``available``, else ``PageAllocError`` (also raised when
        an armed fault injector fires ``pool/alloc_fail``)."""
        if n == 0:
            return []
        inj = self.fault_injector
        if inj is not None and inj.should_fire("pool/alloc_fail"):
            raise PageAllocError(f"injected allocator fault (alloc({n}))")
        if reserved:
            assert n <= self.reserved, "top-up exceeds this pool's reservation"
            assert n <= len(self._free), "reservation invariant violated"
            self.reserved -= n
        elif n > self.available:
            raise PageAllocError(
                f"pool exhausted: alloc({n}) with only {self.available} available"
            )
        pages = [self._free.pop() for _ in range(n)]
        self.refcount[pages] = 1
        return pages

    def incref(self, pages: Iterable[int]) -> None:
        for p in pages:
            assert p != SENTINEL_PAGE and self.refcount[p] > 0, (
                f"incref of unallocated page {p}"
            )
            self.refcount[p] += 1

    def decref(self, pages: Iterable[int]) -> list[int]:
        """Drop one reference per page; returns the pages that became free."""
        freed = []
        for p in pages:
            assert p != SENTINEL_PAGE and self.refcount[p] > 0, (
                f"decref of unallocated page {p}"
            )
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                self._free.append(p)
                freed.append(p)
        return freed


class _Node:
    __slots__ = ("chunk", "page", "parent", "children", "last_use")

    def __init__(self, chunk, page: int, parent: Optional["_Node"]):
        self.chunk = chunk  # tuple of page_size token ids (None at root)
        self.page = page
        self.parent = parent
        self.children: dict = {}
        self.last_use = 0


class RadixCache:
    """Prefix tree mapping page-aligned prompt chunks to cached pages."""

    def __init__(self, pool: PagePool):
        self.pool = pool
        self.root = _Node(None, SENTINEL_PAGE, None)
        self._tick = 0
        #: admissions whose prompt matched at least one cached page
        self.hits = 0

    def _chunks(self, tokens: Sequence[int]):
        ps = self.pool.page_size
        for j in range(len(tokens) // ps):
            yield tuple(int(t) for t in tokens[j * ps:(j + 1) * ps])

    def _touch(self, node: _Node) -> None:
        self._tick += 1
        node.last_use = self._tick

    def match(self, tokens: Sequence[int], record: bool = True) -> list[int]:
        """Pages of the longest cached full-page prefix of ``tokens``.  Takes
        no references: the caller increfs before anything can evict.
        ``record=False`` is a pure probe (no LRU touch)."""
        node, pages = self.root, []
        for chunk in self._chunks(tokens):
            child = node.children.get(chunk)
            if child is None:
                break
            if record:
                self._touch(child)
            pages.append(child.page)
            node = child
        if record and pages:
            self.hits += 1
        return pages

    def insert(self, tokens: Sequence[int], pages: Sequence[int]) -> None:
        """Cache the full-page prefix of ``tokens`` backed by ``pages``
        (``pages[j]`` holds tokens ``[j*ps, (j+1)*ps)``).  New nodes incref
        their page; chunks already cached keep the tree's page."""
        node = self.root
        for j, chunk in enumerate(self._chunks(tokens)):
            if j >= len(pages):
                break
            child = node.children.get(chunk)
            if child is None:
                child = _Node(chunk, pages[j], node)
                node.children[chunk] = child
                self.pool.incref([pages[j]])
            self._touch(child)
            node = child

    def export_nodes(self) -> list[tuple[int, tuple, int]]:
        """Flatten the tree for a warm-state snapshot: ``(parent_index,
        chunk, page)`` per node, parents before children (the root is index
        -1).  Page ids only mean something against this pool."""
        nodes: list[tuple[int, tuple, int]] = []
        stack = [(-1, child) for child in self.root.children.values()]
        while stack:
            parent_idx, node = stack.pop()
            idx = len(nodes)
            nodes.append((parent_idx, node.chunk, node.page))
            stack.extend((idx, c) for c in node.children.values())
        return nodes

    def load_nodes(
        self, nodes: Sequence[tuple[int, tuple, int]], pages: Sequence[int]
    ) -> int:
        """Rebuild exported nodes onto this pool: ``pages[i]`` is the freshly
        allocated page of ``nodes[i]``, whose one reference becomes the
        tree's.  Nodes already cached are skipped and their page freed;
        returns the nodes added."""
        by_idx: dict = {}
        added = 0
        for i, (parent_idx, chunk, _) in enumerate(nodes):
            parent = self.root if parent_idx < 0 else by_idx.get(parent_idx)
            if parent is None:
                self.pool.decref([pages[i]])
                continue  # its parent was a duplicate resolved to nothing
            chunk = tuple(chunk)
            child = parent.children.get(chunk)
            if child is None:
                child = _Node(chunk, pages[i], parent)
                parent.children[chunk] = child
                added += 1
            else:
                self.pool.decref([pages[i]])
            self._touch(child)
            by_idx[i] = child
        return added

    def evictable_pages(self) -> int:
        """Pages reclaimable by eviction (cached pages only the tree holds)."""
        count = 0
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            if self.pool.refcount[n.page] == 1:
                count += 1
            stack.extend(n.children.values())
        return count

    def evict(self, n: int) -> int:
        """Free up to ``n`` pages, LRU leaves first; returns pages freed.
        Parents exposed by an eviction join the heap as they become leaves."""
        heap: list[tuple[int, int, _Node]] = []
        tie = 0  # heap tiebreak: nodes are not orderable
        stack = list(self.root.children.values())
        while stack:
            node = stack.pop()
            if node.children:
                stack.extend(node.children.values())
            elif self.pool.refcount[node.page] == 1:
                heapq.heappush(heap, (node.last_use, tie, node))
                tie += 1
        freed = 0
        while freed < n and heap:
            _, _, victim = heapq.heappop(heap)
            del victim.parent.children[victim.chunk]
            freed += len(self.pool.decref([victim.page]))
            parent = victim.parent
            if parent is not self.root and not parent.children and (
                self.pool.refcount[parent.page] == 1
            ):
                heapq.heappush(heap, (parent.last_use, tie, parent))
                tie += 1
        return freed
