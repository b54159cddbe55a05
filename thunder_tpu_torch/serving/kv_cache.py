"""Block-allocated paged KV cache; the counterpart of
``thunder_tpu/serving/kv_cache.py``.

One shared pool of fixed-size pages per layer — K and V tensors of shape
``(kv_heads, num_pages, page_size, head_dim)`` on the engine's device — plus
a host-side LIFO free list, per-page reference counts and per-request block
tables. Requests at any mix of lengths share one allocation.

Page 0 is reserved as the scratch page: it is never allocated, idle decode
slots and first-token replay rows write their discarded K/V there, and
unused block-table entries point at it, so every table entry is a valid
pool index.

Pages are refcounted (the copy-on-write substrate): ``alloc`` hands out
pages at refcount 1, ``retain`` lets a second block table share a page, and
``free`` returns a page to the free list only when its last reference
drops. :meth:`fork` shares every full page of a context and copies only its
partial tail page. A page registered by the prefix cache
(:mod:`~thunder_tpu_torch.serving.prefix_cache`) parks at refcount 0 in the
*cached* set, its K/V kept, instead of returning to the free list; ``alloc``
reclaims parked pages oldest first through ``evict_cb`` before it raises
``OutOfPages``, so cached prefixes never starve live traffic.

Unlike the reference, whose compiled steps take the pools as donated
arguments and return new ones, the port's eager steps and :meth:`copy_page`
update the pools in place (``index_copy_``), which keeps one copy of the
cache on the device. What the reference's donation loses on a failing
dispatch, :meth:`consume_pools` simulates by dropping the tensors.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class PageGeometry:
    """Static pool geometry."""

    n_layers: int
    kv_heads: int
    head_dim: int
    page_size: int           # tokens per page
    num_pages: int           # pool pages per layer, INCLUDING the reserved page 0
    pages_per_request: int   # block-table width (max context / page_size)

    @property
    def max_context(self) -> int:
        return self.pages_per_request * self.page_size

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` of context."""
        return -(-n_tokens // self.page_size)


class OutOfPages(RuntimeError):
    """The page pool cannot satisfy an allocation; a scheduler-level signal."""


class PagedKVCache:
    """Device page pools + host free list + per-page refcounts.

    ``pools`` is a list (per layer) of ``{"k": tensor, "v": tensor}``."""

    def __init__(self, geometry: PageGeometry, dtype: torch.dtype,
                 device: str | torch.device):
        g = geometry
        if g.num_pages < 2:
            raise ValueError("num_pages must be >= 2 (page 0 is reserved)")
        self.geometry = g
        self.dtype = dtype
        shape = (g.kv_heads, g.num_pages, g.page_size, g.head_dim)
        self.pools = [{"k": torch.zeros(shape, dtype=dtype, device=device),
                       "v": torch.zeros(shape, dtype=dtype, device=device)}
                      for _ in range(g.n_layers)]
        # LIFO free list: recently freed pages are served first; the mirror
        # set keeps free()'s double-free check O(1) per page
        self._free: list[int] = list(range(g.num_pages - 1, 0, -1))
        self._free_set: set[int] = set(self._free)
        self._min_free = len(self._free)     # high-water tracking
        # per-page references (0 == free or parked), the prefix cache's
        # registrations, and the parked pages in eviction order
        self._rc: list[int] = [0] * g.num_pages
        self._registered: set[int] = set()
        self._cached: dict[int, None] = {}    # ordered: oldest parked first
        self.evict_cb = None        # page -> list[int]: the prefix cache's hook
        self.cow_copies = 0         # tail-page copies made by fork()
        self.pages_allocated = 0    # lifetime alloc count (page amplification)

    # -- allocation ---------------------------------------------------------
    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_total(self) -> int:
        """Allocatable pages (the reserved scratch page does not count)."""
        return self.geometry.num_pages - 1

    @property
    def cached_pages(self) -> int:
        """Pages parked by the prefix cache: refcount 0, K/V kept,
        reclaimable by :meth:`alloc` under pressure."""
        return len(self._cached)

    @property
    def peak_pages_used(self) -> int:
        return self.pages_total - self._min_free

    def utilization(self) -> float:
        return 1.0 - self.pages_free / self.pages_total

    def reset_peak(self) -> None:
        """Restart high-water tracking (benchmarks: exclude warm-up)."""
        self._min_free = len(self._free)

    def refcount(self, page: int) -> int:
        return self._rc[page]

    def can_alloc(self, n: int) -> bool:
        # parked pages count: alloc() reclaims them before back-pressuring
        return n <= len(self._free) + len(self._cached)

    def alloc(self, n: int) -> list[int]:
        """Pop ``n`` pages off the free list at refcount 1, reclaiming parked
        prefix-cache pages (oldest first, through ``evict_cb``) when the list
        runs short. Raises ``OutOfPages`` when free + parked pages cannot
        cover it — the scheduler turns that into back-pressure or
        preemption."""
        while n > len(self._free) and self._cached:
            victim = next(iter(self._cached))
            # the prefix cache drops the victim's trie node and its subtree;
            # without a registered cache the parked page reclaims alone
            pages = self.evict_cb(victim) if self.evict_cb is not None else [victim]
            for p in pages:
                self._reclaim(p)
        if n > len(self._free):
            raise OutOfPages(f"requested {n} KV pages with {len(self._free)} free "
                             f"(pool: {self.pages_total}, cached: {len(self._cached)})")
        pages = [self._free.pop() for _ in range(n)]
        self._free_set.difference_update(pages)
        for p in pages:
            self._rc[p] = 1
        self.pages_allocated += len(pages)
        self._min_free = min(self._min_free, len(self._free))
        return pages

    def retain(self, pages) -> None:
        """Add a reference to already allocated pages (a fork, a prefix hit).
        A parked page leaves the evictable set: it is live again."""
        for p in pages:
            if not (0 < p < self.geometry.num_pages):
                raise ValueError(f"retaining invalid page id {p}")
            if p in self._free_set:
                raise ValueError(f"retain of free page {p}")
            if self._rc[p] == 0:
                self._cached.pop(p, None)    # parked -> live
            self._rc[p] += 1

    def free(self, pages) -> None:
        """Drop one reference per page. A page whose last reference drops
        returns to the free list, or parks, K/V kept, when the prefix cache
        registered it."""
        for p, n in Counter(pages).items():
            if not (0 < p < self.geometry.num_pages):
                raise ValueError(f"freeing invalid page id {p}")
            if p in self._free_set or self._rc[p] < n:
                raise ValueError(f"double free of page {p} ({n} drops against "
                                 f"{self._rc[p]} held references)")
        for p in pages:
            self._rc[p] -= 1
            if self._rc[p] > 0:
                continue                     # another block table holds it
            if p in self._registered:
                self._cached[p] = None       # park for future prefix hits
            else:
                self._free.append(p)
                self._free_set.add(p)

    # -- copy-on-write forks ------------------------------------------------
    def fork(self, pages: list[int], length: int) -> list[int]:
        """Fork a block table covering ``length`` context tokens: full pages
        are shared (a refcount, no bytes moved) and only the partial tail
        page, which the fork goes on writing into, is copied onto a fresh
        page. A page-aligned context forks with no copy. Raises
        ``OutOfPages``, having undone its retains, when the tail copy cannot
        allocate."""
        ps = self.geometry.page_size
        if length < 1:
            raise ValueError(f"cannot fork an empty context ({length=})")
        n_ctx = -(-length // ps)
        if len(pages) < n_ctx:
            raise ValueError(f"fork needs {n_ctx} pages for {length} tokens, "
                             f"got {len(pages)}")
        tail_partial = (length % ps) != 0
        shared = pages[:n_ctx - 1] if tail_partial else pages[:n_ctx]
        self.retain(shared)
        forked = list(shared)
        if tail_partial:
            try:
                [tail] = self.alloc(1)
            except OutOfPages:
                self.free(shared)            # a fork is all or nothing
                raise
            self.copy_page(pages[n_ctx - 1], tail)
            self.cow_copies += 1
            forked.append(tail)
        return forked

    def copy_page(self, src: int, dst: int) -> None:
        """Copy one page's K/V across every layer, in place: one
        ``index_copy_`` per pool on the current stream, so it is ordered
        before the next step's writes. The destination index is filled on
        the device: no host-to-device copy, no host read, no sync."""
        if not self.pools_alive():
            raise RuntimeError("copy_page on consumed pools")
        dst_t = torch.full((1,), dst, dtype=torch.int64, device=self.pools[0]["k"].device)
        for kv in self.pools:
            for pool in kv.values():
                pool.index_copy_(1, dst_t, pool[:, src:src + 1])

    # -- prefix-cache registration ------------------------------------------
    def register_cached(self, page: int) -> None:
        """Mark a page as held by the prefix cache: when its refcount drops
        to zero it parks (K/V kept, evictable) instead of returning to the
        free list."""
        if not (0 < page < self.geometry.num_pages):
            raise ValueError(f"registering invalid page id {page}")
        if page in self._free_set:
            raise ValueError(f"registering free page {page}")
        self._registered.add(page)
        if self._rc[page] == 0:
            self._cached[page] = None

    def unregister_cached(self, page: int) -> None:
        """Drop a page's registration: a parked page returns to the free
        list at once; a live one stops parking when its last reference
        drops."""
        self._registered.discard(page)
        if page in self._cached:
            del self._cached[page]
            self._free.append(page)
            self._free_set.add(page)

    def _reclaim(self, page: int) -> None:
        """Eviction: un-register a parked page and return it to the free
        list (the trie entry is already gone)."""
        if self._rc[page] != 0 or page not in self._registered:
            raise ValueError(f"reclaiming page {page} that is live "
                             f"(rc={self._rc[page]}) or unregistered")
        self._registered.discard(page)
        self._cached.pop(page, None)
        self._free.append(page)
        self._free_set.add(page)

    # -- device state -------------------------------------------------------
    def pools_alive(self) -> bool:
        """False once a pool tensor was dropped (:meth:`consume_pools`): the
        cache's device state is lost and only a rebuild recovers."""
        return all(t is not None for kv in self.pools for t in kv.values())

    def consume_pools(self) -> None:
        """Drop every pool tensor — what the reference's donated buffers
        suffer when a dispatch fails mid-execution. Only the
        ``serving:engine`` fault domain calls this; recovery is a supervisor
        pool rebuild."""
        for kv in self.pools:
            for key in kv:
                kv[key] = None

    def assert_quiescent(self, block_tables=None) -> None:
        """Leak audit for an idle pool: no page holds a reference, every
        allocatable page is on the free list or parked (not both), the free
        list and its mirror set agree, and (when given) no block-table entry
        references anything but the scratch page."""
        live = [p for p in range(1, self.geometry.num_pages) if self._rc[p]]
        if live:
            raise AssertionError(
                f"KV page leak: {len(live)} pages still hold live references on an "
                f"idle pool (first ids: {live[:8]}, refcounts: "
                f"{[self._rc[p] for p in live[:8]]})")
        accounted = len(self._free) + len(self._cached)
        if accounted != self.pages_total:
            raise AssertionError(f"KV page leak: free ({len(self._free)}) + cached "
                                 f"({len(self._cached)}) != allocatable ({self.pages_total})")
        stray = sorted(set(self._free) & set(self._cached))
        if stray:
            raise AssertionError(f"pages on the free list AND in the cached set: {stray}")
        if len(self._free) != len(self._free_set) or set(self._free) != self._free_set:
            raise AssertionError(
                f"free-list/mirror-set divergence: list holds {len(self._free)} entries "
                f"({len(set(self._free))} unique), mirror holds {len(self._free_set)}")
        bad = sorted(p for p in self._free if not (0 < p < self.geometry.num_pages))
        if bad:
            raise AssertionError(f"free list holds invalid page ids {bad}")
        if block_tables is not None:
            nz = np.flatnonzero(np.asarray(block_tables))
            if nz.size:
                raise AssertionError(f"{nz.size} block-table entries still reference "
                                     f"non-scratch pages on an idle engine")
