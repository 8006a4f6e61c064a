"""Radix prefix index (the reference's `serve/prefix_cache.py`): maps
token prefixes to completed, immutable KV pages, so a request whose
prompt shares an N-token prefix with earlier traffic skips N tokens of
prefill and allocates only its suffix pages.

Structure
  The tree is page-granular: every node covers the tokens of exactly one
  physical page. Full nodes (page_size tokens) are keyed by their token
  tuple in the parent's `children` dict, so a full page is one hash
  probe. Partial *tail* nodes (< page_size tokens, the unaligned end of
  an inserted sequence) live in the parent's `tails` list; only full
  nodes have descendants, so every root-to-node path spells a
  page-aligned token prefix.

Sharing and COW
  A lookup may end inside a node: the longest common prefix of the rest
  of the prompt and a child's key is still shareable, because the
  borrowing sequence forks that page (copy-on-write, kv_cache.py) before
  its own suffix tokens are written into it. Whole-page matches are
  shared with no copy.

Refcounts and eviction
  Every node holds one reference on its page (PagedKVCache.ref), taken
  at insert and dropped at evict. Eviction is leaf-first and
  hit-rate-aware: among nodes whose page has refcount 1 (index-only, no
  running sequence uses it), cold leaves (fewest lookup hits) go first,
  least recently used within a hit count, so a hot system prompt
  outlives one-shot prompts that merely happen to be recent. A node
  whose page a sequence references is pinned, and so are its ancestors.
  The allocator calls `evict` when an allocation would otherwise fail,
  so cached prefixes are sacrificed before any running sequence is
  preempted.

Sharded pools
  Over a sharded PagedKVCache (a serving mesh's data axis) the index is
  shard-local: a chain's shard is the shard of its pages (one insert
  comes from one slot, so a chain never mixes shards), children are
  keyed by (shard, token tuple), and `lookup(..., shard=s)` matches only
  chains whose pages a shard-s slot can attach. The same prefix may be
  cached once a shard: that keeps every gather on its data rank.
  Eviction takes the same shard filter, so pressure in one shard never
  drains another's cached prefixes.
"""
from __future__ import annotations

import heapq

import numpy as np

# cap on distinct partial tails cached under one parent: tails are
# matched by linear scan, and a hot parent (a system prompt) could
# otherwise gather one tail per distinct first-suffix page
MAX_TAILS = 8


class _Node:
    __slots__ = ("key", "page", "n_tokens", "children", "tails", "parent",
                 "last_used", "shard", "hits")

    def __init__(self, key, page, n_tokens, parent, shard=0):
        self.key = key                  # tuple of tokens this page holds
        self.page = page                # physical page id
        self.n_tokens = n_tokens        # valid tokens in the page
        self.children = {}              # full nodes, (shard, key) -> _Node
        self.tails = []                 # partial-page nodes
        self.parent = parent
        self.shard = shard              # home shard of self.page
        self.last_used = 0
        self.hits = 0                   # lookup matches (eviction warmth)

    def is_leaf(self):
        return not self.children and not self.tails


def _lcp(key, toks) -> int:
    n = 0
    for a, b in zip(key, toks):
        if a != b:
            break
        n += 1
    return n


class RadixPrefixCache:
    """Token-prefix -> page-chain index over a PagedKVCache.

    `max_cached_pages` caps the pages the index may retain (default: all
    but one page per sequence slot), enforced best-effort LRU at insert
    time; pages a running sequence also references are pinned."""

    def __init__(self, kv, max_cached_pages: int | None = None):
        self.kv = kv
        self.page = kv.page_size
        self.root = _Node((), 0, 0, None)
        self.max_cached_pages = (
            int(max_cached_pages) if max_cached_pages is not None
            else max(kv.usable_pages - kv.max_seqs, 1))
        self._pages = 0           # retained pages (== node count)
        self._tick = 0
        self.hits = 0             # admissions served from the index
        self.lookups = 0          # lookup() calls (hit-rate denominator)
        self.tokens_saved = 0
        self.evictions = 0
        kv.prefix_index = self

    @property
    def hit_rate(self) -> float:
        """Fraction of lookups that ended in an attached prefix (the
        scheduler counts one hit per admission it serves from the
        index)."""
        return self.hits / max(self.lookups, 1)

    def _touch(self, node: _Node, *, hit: bool = False) -> None:
        self._tick += 1
        node.last_used = self._tick
        if hit:
            node.hits += 1

    # ---------------- lookup ----------------
    def lookup(self, tokens, *, max_tokens=None, shard=None, count=True):
        """Longest cached prefix of `tokens`, capped at max_tokens:
        (n_matched, [page_ids]) with the pages covering tokens
        [0, n_matched) in order; the last page is partially matched when
        n_matched is not page-aligned (the borrower forks it before
        writing). `shard` restricts the match to chains whose pages lie
        in that pool shard (the only pages a slot of that shard may
        attach); None matches any one shard's chain. Touches matched
        nodes and bumps their hit counts. `count=False` is the
        scheduler's reclaim-loop retry: the same admission, so the
        lookup counter and the nodes' warmth stay as the first round left
        them (the recency touch still happens)."""
        if count:
            self.lookups += 1
        toks = [int(t) for t in np.asarray(tokens).reshape(-1)]
        limit = len(toks) if max_tokens is None else min(max_tokens,
                                                        len(toks))
        shards = ((shard,) if shard is not None
                  else range(self.kv.n_shards))
        node, matched, pages = self.root, 0, []
        while limit - matched > 0:
            rem = limit - matched
            if rem >= self.page:
                chunk = tuple(toks[matched:matched + self.page])
                child = None
                for sh in shards:
                    child = node.children.get((sh, chunk))
                    if child is not None:
                        break
                if child is not None:
                    pages.append(child.page)
                    matched += self.page
                    self._touch(child, hit=count)
                    node = child
                    # a sequence attaches pages of one shard only
                    shards = (child.shard,)
                    continue
            # no whole-page step: take the best partial match among this
            # node's children (full or tail) and stop
            best, best_lcp = None, 0
            for cand in list(node.children.values()) + node.tails:
                if cand.shard not in shards:
                    continue
                lcp = min(_lcp(cand.key, toks[matched:]), rem,
                          cand.n_tokens)
                if lcp > best_lcp:
                    best, best_lcp = cand, lcp
            if best is not None:
                pages.append(best.page)
                matched += best_lcp
                self._touch(best, hit=count)
            break
        return matched, pages

    # ---------------- insert ----------------
    def insert(self, tokens, page_ids) -> None:
        """Index `tokens`, whose KV the caller's pages hold in order
        (page_ids[i] covers tokens [i*page, (i+1)*page)). Existing nodes
        are reused; new nodes take one reference per page so the pages
        outlive the inserting sequence."""
        toks = [int(t) for t in np.asarray(tokens).reshape(-1)]
        n = len(toks)
        nfull = n // self.page
        if n and len(page_ids) < self.kv.pages_for(n):
            raise ValueError(f"{n} tokens need {self.kv.pages_for(n)} "
                             f"pages, {len(page_ids)} given")
        # one insert comes from one slot: the chain has its first page's
        # shard
        shard = (self.kv.shard_of_page(int(page_ids[0])) if len(page_ids)
                 else 0)
        node = self.root
        for i in range(nfull):
            chunk = tuple(toks[i * self.page:(i + 1) * self.page])
            child = node.children.get((shard, chunk))
            if child is None:
                child = _Node(chunk, int(page_ids[i]), self.page, node,
                              shard)
                node.children[(shard, chunk)] = child
                self.kv.ref(child.page)
                self._pages += 1
            self._touch(child)
            node = child
        rem = n - nfull * self.page
        if not rem:
            self._enforce_cap()
            return
        key = tuple(toks[nfull * self.page:])
        for t in node.tails:
            if t.key == key and t.shard == shard:
                self._touch(t)
                self._enforce_cap()
                return
        tail = _Node(key, int(page_ids[nfull]), rem, node, shard)
        node.tails.append(tail)
        self.kv.ref(tail.page)
        self._pages += 1
        self._touch(tail)
        if len(node.tails) > MAX_TAILS:
            victim = min(node.tails,
                         key=lambda t: (self.kv.refcount(t.page) > 1,
                                        t.hits, t.last_used))
            if self.kv.refcount(victim.page) == 1:
                node.tails.remove(victim)
                self.kv.unref(victim.page)
                self._pages -= 1
                self.evictions += 1
        self._enforce_cap()

    def _enforce_cap(self) -> None:
        """Evict LRU index-only pages down to max_cached_pages (pinned
        pages can make it undershoot; it re-runs on every insert)."""
        excess = self._pages - self.max_cached_pages
        if excess > 0:
            self.evict(excess)

    # ---------------- eviction ----------------
    def _evictable(self, node: _Node) -> bool:
        return (node is not self.root and node.is_leaf()
                and self.kv.refcount(node.page) == 1)

    def evict(self, n_pages: int, shard: int | None = None) -> int:
        """Free up to n_pages index-only pages, coldest leaves first
        (fewest lookup hits, least recently used within a hit tier).
        One tree walk seeds a heap of evictable leaves; evicting a leaf
        pushes its parent when that exposed it. With `shard`, only that
        shard's chains are candidates (the allocator reclaims under one
        shard's pressure). Returns the pages freed."""

        def evictable(node):
            return (self._evictable(node)
                    and (shard is None or node.shard == shard))

        def key(node):
            return (node.hits, node.last_used)

        heap, stack = [], [self.root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            stack.extend(node.tails)
            if evictable(node):
                heapq.heappush(heap, (*key(node), id(node), node))
        freed = 0
        while freed < n_pages and heap:
            hits, tick, _, victim = heapq.heappop(heap)
            if (hits, tick) != key(victim) or not evictable(victim):
                continue              # stale entry (touched since seeded)
            parent = victim.parent
            if victim in parent.tails:
                parent.tails.remove(victim)
            else:
                del parent.children[(victim.shard, victim.key)]
            self.kv.unref(victim.page)
            self._pages -= 1
            self.evictions += 1
            freed += 1
            if evictable(parent):
                heapq.heappush(heap, (*key(parent), id(parent), parent))
        return freed

    def clear(self) -> int:
        """Drop every cached page that no sequence references; returns
        the pages the index held before."""
        n = self.cached_pages()
        while self.evict(self.kv.n_pages):
            pass
        return n

    # ---------------- maintenance / stats ----------------
    def _nodes(self):
        stack = [self.root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            stack.extend(node.tails)
            if node is not self.root:
                yield node

    def remap(self, fn) -> None:
        """Apply a page-id remapping (PagedKVCache.compact)."""
        for node in self._nodes():
            node.page = fn(node.page)

    def cached_pages(self) -> int:
        """Pages the index retains (a counter; `_count_nodes` walks the
        tree to cross-check it)."""
        return self._pages

    def _count_nodes(self) -> int:
        return sum(1 for _ in self._nodes())
