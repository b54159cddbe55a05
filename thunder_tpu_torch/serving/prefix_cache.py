"""Cross-request prefix cache: a page-granularity token trie over the paged
KV pool; the counterpart of ``thunder_tpu/serving/prefix_cache.py``.

Completed requests donate their full prompt pages, keyed by token content;
admission probes the trie with a new prompt, and prefill starts at the
first uncached page. For a shared system prompt a warm cache cuts TTFT to
the tail's prefill.

One trie node per FULL page of prompt tokens, keyed by that page's
``page_size`` token ids under its parent, so a node's path spells the whole
prefix. Each node owns one pool page holding those positions' K/V; RoPE is
applied before K is written, so a cached page serves any request whose
prompt starts with the same tokens.

- **probe** walks the trie over the prompt's full pages (capped one page
  short of the prompt's end, so the tail always re-prefills and writes the
  rows the first decode step attends), retains the matched pages and
  returns the chain.
- **donate** registers a completed request's full prompt pages as nodes
  (the first donor wins). Registration parks a page in the allocator's
  cached set when its refcount drops: K/V kept, evictable.
- **eviction** is driven by the allocator: when the free list runs dry,
  ``PagedKVCache.alloc`` reclaims parked pages oldest first through
  :meth:`PrefixCache.evict`, which drops the node and its whole subtree (a
  live request on a descendant holds references on every ancestor, so an
  unreferenced page's subtree is unreferenced too).
"""

from __future__ import annotations

import hashlib

from thunder_tpu_torch.observe import registry as _observe
from thunder_tpu_torch.serving.kv_cache import PagedKVCache


def page_chunks(tokens, page_size: int) -> list[tuple]:
    """The per-page token-id tuples that key trie edges, capped at the last
    full page strictly before the final token: the tail always re-prefills,
    so it is never content-addressed. The trie walk and
    :func:`content_key` both derive from this."""
    ps = page_size
    n_full = (len(tokens) - 1) // ps
    return [tuple(int(t) for t in tokens[i * ps:(i + 1) * ps]) for i in range(n_full)]


def content_key(tokens, page_size: int | None = None) -> str:
    """Stable digest of a prompt prefix. With ``page_size`` it covers
    exactly the :func:`page_chunks` the trie would key (two prompts share a
    digest iff they would share a full trie chain); without it, the raw
    token ids."""
    if page_size is not None:
        flat = [t for chunk in page_chunks(tokens, page_size) for t in chunk]
    else:
        flat = [int(t) for t in tokens]
    payload = ",".join(str(t) for t in flat).encode()
    return hashlib.blake2b(payload, digest_size=8).hexdigest()


class _Node:
    __slots__ = ("page", "parent", "chunk", "children")

    def __init__(self, page: int, parent, chunk: tuple):
        self.page = page
        self.parent = parent          # _Node | None (root children)
        self.chunk = chunk            # the page's token ids (trie edge key)
        self.children: dict[tuple, _Node] = {}


class PrefixCache:
    """Token-content trie mapping prompt prefixes to cached KV pages."""

    def __init__(self, cache: PagedKVCache):
        self.cache = cache
        self.page_size = cache.geometry.page_size
        self._root: dict[tuple, _Node] = {}
        self._by_page: dict[int, _Node] = {}
        # admission accounting for the serving.prefix_hit_rate gauge
        self.hit_tokens = 0
        self.probed_tokens = 0
        cache.evict_cb = self.evict

    @property
    def registered_pages(self) -> int:
        """Pages the trie holds, live or parked."""
        return len(self._by_page)

    def hit_rate(self) -> float:
        """Cumulative prompt-token hit ratio over every probe so far."""
        return self.hit_tokens / self.probed_tokens if self.probed_tokens else 0.0

    # -- admission ----------------------------------------------------------
    def lookup(self, tokens) -> list[int]:
        """Longest cached page chain for ``tokens``, without retaining it;
        capped at the last full page before the final token."""
        chain: list[int] = []
        level = self._root
        for key in page_chunks(tokens, self.page_size):
            node = level.get(key)
            if node is None:
                break
            chain.append(node.page)
            level = node.children
        return chain

    def claim(self, pages: list[int]) -> None:
        """Retain a probed chain into a request's block table. Parked pages
        leave the evictable set while claimed and re-park at its newest end
        on release, so a hot prefix's recency refreshes through use."""
        self.cache.retain(pages)

    def probe(self, tokens, request_id=None, chain=None) -> list[int]:
        """Admission probe: look up (or take the sizing pass's ``chain``),
        claim, count, and emit ``serving_prefix_hit``. Returns the retained
        chain, possibly empty."""
        if chain is None:
            chain = self.lookup(tokens)
        self.probed_tokens += len(tokens)
        if chain:
            self.claim(chain)
            self.hit_tokens += len(chain) * self.page_size
            _observe.event("serving_prefix_hit", request=request_id, pages=len(chain),
                           tokens=len(chain) * self.page_size, prompt_tokens=len(tokens))
        _observe.set_gauge("serving.prefix_hit_rate", self.hit_rate())
        return chain

    # -- donation -----------------------------------------------------------
    def donate(self, tokens, pages: list[int]) -> int:
        """Register a completed request's full prompt pages as trie nodes;
        call before freeing them. A page whose prefix is cached already
        stays unregistered and frees normally. Returns the number of pages
        newly registered.

        Capped one page short like :meth:`lookup`: a completed request's
        final token never had its K/V row written (it was sampled, never fed
        back), so for a page-aligned ``tokens`` the last full page holds an
        unwritten row and must not be cached."""
        chunks = page_chunks(tokens, self.page_size)[:len(pages)]
        level, parent, added = self._root, None, 0
        for i, key in enumerate(chunks):
            node = level.get(key)
            if node is None:
                node = _Node(pages[i], parent, key)
                level[key] = node
                self._by_page[node.page] = node
                self.cache.register_cached(node.page)
                added += 1
            elif node.page != pages[i]:
                # the same content under another page: keep the incumbent and
                # stop, since a child under our page would be unreachable
                break
            level, parent = node.children, node
        return added

    def clear(self) -> None:
        """Drop the whole trie and un-register every page (parked pages
        return to the free list; live ones stop parking on release)."""
        for page in list(self._by_page):
            self.cache.unregister_cached(page)
        self._root.clear()
        self._by_page.clear()
        self.hit_tokens = 0
        self.probed_tokens = 0

    # -- eviction (the allocator's pressure callback) -----------------------
    def evict(self, page: int) -> list[int]:
        """Drop the node owning ``page`` and its subtree and return every
        page they owned for the allocator to reclaim."""
        node = self._by_page.get(page)
        if node is None:
            return [page]        # an unregistered parked page
        (node.parent.children if node.parent is not None else self._root).pop(node.chunk, None)
        dropped: list[int] = []
        stack = [node]
        while stack:
            n = stack.pop()
            self._by_page.pop(n.page, None)
            dropped.append(n.page)
            stack.extend(n.children.values())
        _observe.inc("serving.cache_evictions", len(dropped))
        _observe.event("serving_cache_evict", pages=dropped, trigger_page=page)
        return dropped
