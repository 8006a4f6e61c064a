"""The port's radix prefix index (repro_torch/serve/prefix_cache.py) and
its page allocator (serve/kv_cache.py: share, ref, _reclaim, compact)
against the reference's, on the CPU with no device pool.

Seeded random sequences of operations (admit with a prefix lookup and
share, grow, insert at a prompt's first token and at finish, lookup,
evict, ensure, cow_for_write, release, compact)
run on both packages side by side; lookups, evictions, COW copies,
block tables, refcounts, free lists and the index's tree must be equal
after every step, and the allocator's conservation laws must hold. The
hypothesis-gated soup runs more seeds where hypothesis is installed;
fixed seeds run everywhere. The reference's radix unit tests
(tests/test_prefix_sharing.py) are mirrored on the port, and compact()
moves a binary-coded pool's every leaf as the reference moves its own.
There are no tolerances: everything compared is integer.
"""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # not installed: the property tests are gated out
    given = settings = st = None

from repro.configs import get_config as jax_get_config
from repro.serve import OutOfPages as JaxOutOfPages
from repro.serve import PagedKVCache as JaxKV
from repro.serve import RadixPrefixCache as JaxIndex
from repro.serve.scheduler import Scheduler as JaxScheduler
from repro_torch.configs import get_config
from repro_torch.serve import (OutOfPages, PagedKVCache, RadixPrefixCache,
                               Request, Scheduler)
from repro_torch.serve import prefix_cache
from torch_threads import one_torch_thread  # noqa: F401


def _tree(index):
    """The index as nested sorted tuples: (key, page, n_tokens, hits,
    children, tails) per node."""
    def node(n):
        kids = sorted((node(c) for c in n.children.values()), key=repr)
        tails = sorted((node(t) for t in n.tails), key=repr)
        return (n.key, n.page, n.n_tokens, n.hits, tuple(kids), tuple(tails))
    return node(index.root)


def _index_refs(index, n_pages):
    refs = np.zeros(n_pages, np.int64)
    stack = [index.root]
    while stack:
        n = stack.pop()
        stack.extend(n.children.values())
        stack.extend(n.tails)
        if n is not index.root:
            refs[n.page] += 1
    return refs


def _same(jkv, jidx, tkv, tidx):
    assert (tkv.block_tables == jkv.block_tables).all()
    assert (tkv._refcount == jkv._refcount).all()
    assert list(tkv._free) == list(jkv._free)
    assert [tkv.owned_pages(s) for s in range(tkv.max_seqs)] == \
        [jkv.owned_pages(s) for s in range(jkv.max_seqs)]
    assert (tkv.bt_version == jkv.bt_version).all()
    assert (tkv.cow_forks, tkv.pages_allocated, tkv.high_water) == \
        (jkv.cow_forks, jkv.pages_allocated, jkv.high_water)
    for a in ("hits", "lookups", "tokens_saved", "evictions"):
        assert getattr(tidx, a) == getattr(jidx, a), a
    assert tidx.cached_pages() == jidx.cached_pages()
    assert _tree(tidx) == _tree(jidx)


def _conserved(kv, index):
    """free + live == usable; refcount == block-table rows + index
    nodes; the null page never circulates; no duplicate free page."""
    assert kv.live_pages + kv.free_page_count == kv.usable_pages
    assert kv.refcount(0) == 0 and 0 not in kv._free
    assert len(kv._free) == len(set(kv._free))
    rows = np.zeros(kv.n_pages, np.int64)
    for s in range(kv.max_seqs):
        own = kv.owned_pages(s)
        assert len(own) == len(set(own))
        rows[own] += 1
        assert list(kv.block_tables[s, :len(own)]) == own
        assert not kv.block_tables[s, len(own):].any()
    assert (kv._refcount == rows + _index_refs(index, kv.n_pages)).all()
    assert index.cached_pages() == index._count_nodes()


def soup(seed, steps=None):
    """One seeded interleaving on both packages, compared every step."""
    rng = random.Random(seed)
    page = rng.choice([2, 4, 8])
    n_pages = rng.randint(5, 20)
    seqs = rng.randint(1, 4)
    cap = rng.choice([None, rng.randint(1, n_pages)])
    jkv = JaxKV(None, n_pages=n_pages, page_size=page, max_seqs=seqs,
                create_pool=False)
    tkv = PagedKVCache(None, n_pages=n_pages, page_size=page, max_seqs=seqs,
                       create_pool=False)
    jidx, tidx = JaxIndex(jkv, cap), RadixPrefixCache(tkv, cap)
    # a few base sequences: prompts cut from them share prefixes
    bases = [[rng.randrange(6) for _ in range(4 * page)] for _ in range(2)]
    toks = {}                       # slot -> tokens its pages hold

    def both(fn):
        """fn on each package; their results, or both raised OutOfPages."""
        out = []
        for kv, idx, oop in ((jkv, jidx, JaxOutOfPages),
                             (tkv, tidx, OutOfPages)):
            try:
                out.append(fn(kv, idx))
            except oop:
                out.append("OutOfPages")
        assert out[0] == out[1]
        return out[0]

    for _ in range(steps or rng.randint(30, 90)):
        op = rng.choice(("admit", "admit", "grow", "insert", "finish",
                         "lookup", "evict", "cow", "release", "compact"))
        active = tkv.active_slots()
        if op == "admit":
            base = rng.choice(bases)
            prompt = base[:rng.randint(1, len(base))] + \
                [rng.randrange(6) for _ in range(rng.randint(0, 3))]
            count = rng.random() < 0.8
            slot = both(lambda kv, idx: kv.alloc_slot())
            if slot is None:
                continue
            n, pages = both(lambda kv, idx: idx.lookup(
                prompt, max_tokens=len(prompt) - 1, count=count))
            both(lambda kv, idx: kv.share(slot, pages))
            if n:                   # the scheduler's count of a hit
                for idx in (jidx, tidx):
                    idx.hits += 1
                    idx.tokens_saved += n
            r = both(lambda kv, idx: (kv.ensure(slot, len(prompt)),
                                      kv.cow_for_write(slot, n, len(prompt))))
            if r == "OutOfPages":
                both(lambda kv, idx: kv.release(slot))
            else:
                toks[slot] = prompt
        elif op == "grow" and active:
            slot = rng.choice(active)
            more = toks.get(slot, []) + [rng.randrange(6)
                                         for _ in range(rng.randint(1, 6))]
            start = len(toks.get(slot, []))
            r = both(lambda kv, idx: (kv.ensure(slot, len(more)),
                                      kv.cow_for_write(slot, start,
                                                       len(more))))
            if r != "OutOfPages":
                toks[slot] = more
        elif op in ("insert", "finish") and [s for s in active
                                             if toks.get(s)]:
            # as the engine indexes: a prompt's full pages at its first
            # token, everything its pages hold when it finishes
            slot = rng.choice([s for s in active if toks.get(s)])
            n = len(toks[slot])
            if op == "insert":
                n -= n % page
            both(lambda kv, idx: idx.insert(
                np.asarray(toks[slot][:n]),
                kv.owned_pages(slot)[:kv.pages_for(n) if n else 0]))
            if op == "finish":
                both(lambda kv, idx: kv.release(slot))
                del toks[slot]
        elif op == "lookup":
            base = rng.choice(bases)
            q = base[:rng.randint(0, len(base))] + [rng.randrange(6)]
            cap = rng.choice([None, len(q) - 1])
            both(lambda kv, idx: idx.lookup(np.asarray(q), max_tokens=cap))
        elif op == "evict":
            n, shard = rng.randint(1, 4), rng.choice([None, 0])
            both(lambda kv, idx: idx.evict(n, shard=shard))
        elif op == "cow" and [s for s in active if toks.get(s)]:
            slot = rng.choice([s for s in active if toks.get(s)])
            end = rng.randint(1, len(toks[slot]))
            start = rng.randint(0, end - 1)
            both(lambda kv, idx: kv.cow_for_write(slot, start, end))
        elif op == "release" and active:
            slot = rng.choice(active)
            both(lambda kv, idx: kv.release(slot))
            toks.pop(slot, None)
        elif op == "compact":
            both(lambda kv, idx: kv.compact())
        _same(jkv, jidx, tkv, tidx)
        _conserved(tkv, tidx)
    for slot in tkv.active_slots():
        both(lambda kv, idx: kv.release(slot))
    both(lambda kv, idx: idx.clear())
    _same(jkv, jidx, tkv, tidx)
    assert tkv.free_page_count == tkv.usable_pages and tkv.live_pages == 0


@pytest.mark.parametrize("seed", range(12))
def test_index_and_allocator_match_reference_fixed_seeds(seed):
    soup(seed, steps=80)


if given is not None:
    @settings(deadline=None)
    @given(st.integers(0, 10**9))
    def test_index_and_allocator_match_reference(seed):
        soup(seed)


# ---------------------------------------------------------------------------
# the reference's radix unit tests (tests/test_prefix_sharing.py), on the port
# ---------------------------------------------------------------------------

def _bare_kv(n_pages=17, page=4, seqs=4):
    return PagedKVCache(None, n_pages=n_pages, page_size=page,
                        max_seqs=seqs, create_pool=False)


def test_radix_lookup_and_partial_match():
    kv = _bare_kv()
    idx = RadixPrefixCache(kv)
    s = kv.alloc_slot()
    toks = list(range(100, 111))            # 11 tokens, page 4
    kv.ensure(s, len(toks))                 # 3 pages
    pages = kv.owned_pages(s)
    idx.insert(np.asarray(toks), pages)
    assert idx.lookup(np.asarray(toks)) == (11, pages)
    # mid-page divergence: 1 full page + 2 tokens into the second
    assert idx.lookup(np.asarray(toks[:6] + [999, 998])) == (6, pages[:2])
    assert idx.lookup(np.asarray([7, 8, 9])) == (0, [])
    assert idx.lookup(np.asarray(toks), max_tokens=8) == (8, pages[:2])
    # a one-shard pool: every chain lives on shard 0
    assert idx.lookup(np.asarray(toks), shard=0) == (11, pages)
    assert idx.lookup(np.asarray(toks), shard=1) == (0, [])


def test_radix_eviction_is_leaf_first_lru_and_respects_refcounts():
    kv = _bare_kv()
    idx = RadixPrefixCache(kv)
    s = kv.alloc_slot()
    kv.ensure(s, 8)
    idx.insert(np.arange(8), kv.owned_pages(s))     # chain of 2 full nodes
    kv.release(s)                                   # index-only now
    s2 = kv.alloc_slot()
    kv.ensure(s2, 4)
    idx.insert(np.asarray([50, 51, 52, 53]), kv.owned_pages(s2))
    # s2 still holds its page: pinned, never evicted
    assert idx.evict(5) == 2 and idx.cached_pages() == 1
    kv.release(s2)
    s = kv.alloc_slot()
    kv.ensure(s, 8)
    idx.insert(np.arange(8), kv.owned_pages(s))
    kv.release(s)
    idx.lookup(np.arange(8))                        # chain is now MRU
    assert idx.evict(1) == 1
    assert idx.lookup(np.arange(8))[0] == 8
    assert idx.lookup(np.asarray([50, 51, 52, 53]))[0] == 0
    assert idx.evict(10) == 2 and idx.cached_pages() == 0
    assert kv.free_page_count == kv.usable_pages


def test_radix_eviction_is_hit_rate_aware_cold_first():
    kv = _bare_kv()
    idx = RadixPrefixCache(kv)
    chains = {}
    for name, toks in (("hot", [1, 2, 3, 4]), ("cold", [50, 51, 52, 53])):
        s = kv.alloc_slot()
        kv.ensure(s, 4)
        chains[name] = kv.owned_pages(s)
        idx.insert(np.asarray(toks), chains[name])
        kv.release(s)
    for _ in range(3):
        assert idx.lookup(np.asarray([1, 2, 3, 4]))[0] == 4
    # cold is now the most recent node: pure LRU would evict hot
    idx.insert(np.asarray([50, 51, 52, 53]), chains["cold"])
    assert idx.evict(1) == 1
    assert idx.lookup(np.asarray([1, 2, 3, 4]))[0] == 4
    assert idx.lookup(np.asarray([50, 51, 52, 53]))[0] == 0


def test_radix_hit_rate_and_count_false():
    kv = _bare_kv()
    idx = RadixPrefixCache(kv)
    s = kv.alloc_slot()
    kv.ensure(s, 8)
    idx.insert(np.arange(1, 9), kv.owned_pages(s))
    kv.release(s)
    assert idx.lookups == 0 and idx.hit_rate == 0.0
    assert idx.lookup(np.asarray([1, 2, 3, 4]))[0] == 4
    node = idx.root.children[(0, (1, 2, 3, 4))]      # (shard, tokens)
    assert idx.lookups == 1 and node.hits == 1
    tick = node.last_used
    # a reclaim-round retry: the same admission, counters frozen
    assert idx.lookup(np.asarray([1, 2, 3, 4]), count=False)[0] == 4
    assert idx.lookups == 1 and node.hits == 1 and node.last_used > tick
    idx.lookup(np.asarray([9, 9, 9, 9]))
    idx.hits += 1                  # the scheduler's count for the match
    assert idx.hit_rate == pytest.approx(0.5)


def test_tails_are_capped_per_parent():
    """At most MAX_TAILS partial tails under one parent: the coldest
    index-only one goes."""
    kv = _bare_kv(n_pages=40, page=4, seqs=1)
    idx = RadixPrefixCache(kv, max_cached_pages=39)
    for i in range(prefix_cache.MAX_TAILS + 2):
        s = kv.alloc_slot()
        kv.ensure(s, 6)
        idx.insert(np.asarray([1, 2, 3, 4, 10 + i, 0]), kv.owned_pages(s))
        kv.release(s)
    assert len(idx.root.children[(0, (1, 2, 3, 4))].tails) \
        == prefix_cache.MAX_TAILS
    assert idx.evictions == 2
    _conserved(kv, idx)


def test_reclaim_rounds_count_one_lookup_per_admission():
    """try_admit re-runs the match after each reclaim round; the
    admission is still one lookup, in both packages."""
    counts = []
    for kv_cls, idx_cls, sched_cls, req_cls in (
            (JaxKV, JaxIndex, JaxScheduler, Request),
            (PagedKVCache, RadixPrefixCache, Scheduler, Request)):
        kv = kv_cls(None, n_pages=5, page_size=4, max_seqs=2,
                    create_pool=False)
        idx = idx_cls(kv)
        sched = sched_cls(kv, prefix=idx)
        s = kv.alloc_slot()
        kv.ensure(s, 8)
        idx.insert(np.arange(1, 9), kv.owned_pages(s))
        kv.release(s)
        assert kv.free_page_count == 2
        # 11 unmatched tokens need 4 pages > 2 free: reclaim, re-match
        sched.submit(req_cls(prompt=np.arange(100, 111).astype(np.int32),
                             max_new_tokens=2))
        e = sched.try_admit()
        assert e is not None and e.shared_tokens == 0
        counts.append((idx.lookups, idx.evictions, kv.free_page_count))
    assert counts[0] == counts[1] == (1, 2, 4)


def test_admission_need_matches_reference():
    jkv = JaxKV(None, n_pages=9, page_size=4, max_seqs=2, create_pool=False)
    tkv = PagedKVCache(None, n_pages=9, page_size=4, max_seqs=2,
                       create_pool=False)
    js, ts = JaxScheduler(jkv), Scheduler(tkv)
    for L in range(1, 20):
        for shared in range(0, L):
            for resumed in (False, True):
                assert ts.admission_need(L, resumed=resumed,
                                         shared_tokens=shared) == \
                    js.admission_need(L, resumed=resumed,
                                      shared_tokens=shared)


# ---------------------------------------------------------------------------
# the allocator alone (tests/test_alloc_property.py, on the port)
# ---------------------------------------------------------------------------

def alloc_soup(seed):
    """Random alloc / ensure / share / cow / release / index ref-unref
    interleavings keep conservation, refcount == row + index
    references, and leave no written page shared."""
    rng = random.Random(seed)
    page = rng.choice([2, 4, 8])
    kv = PagedKVCache(None, n_pages=rng.randint(4, 20), page_size=page,
                      max_seqs=rng.randint(1, 4), create_pool=False)
    index_refs = {}
    for _ in range(rng.randint(20, 80)):
        op = rng.choice(("alloc", "ensure", "share", "cow", "release",
                         "index_ref", "index_unref"))
        active = kv.active_slots()
        if op == "alloc":
            kv.alloc_slot()
        elif op == "ensure" and active:
            try:
                kv.ensure(rng.choice(active),
                          rng.randint(1, kv.usable_pages * page + page))
            except OutOfPages:
                pass
        elif op == "share" and active:
            fresh = [s for s in active if not kv.owned_pages(s)]
            donors = [s for s in active if kv.owned_pages(s)]
            chains = ([kv.owned_pages(rng.choice(donors))] if donors else []) \
                + ([sorted(index_refs)] if index_refs else [])
            if fresh and chains:
                chain = rng.choice(chains)
                k = rng.randint(1, min(len(chain), kv.max_pages_per_seq))
                kv.share(rng.choice(fresh), chain[:k])
        elif op == "cow" and [s for s in active if kv.owned_pages(s)]:
            slot = rng.choice([s for s in active if kv.owned_pages(s)])
            n = len(kv.owned_pages(slot)) * page
            start = rng.randint(0, n - 1)
            end = rng.randint(start + 1, n)
            try:
                copies = kv.cow_for_write(slot, start, end)
            except OutOfPages:
                copies = None
            if copies is not None:
                owned = kv.owned_pages(slot)
                for i in range(start // page, (end - 1) // page + 1):
                    assert kv.refcount(owned[i]) == 1
                for src, dst in copies:
                    assert kv.refcount(src) >= 1 and dst in owned
        elif op == "release" and active:
            kv.release(rng.choice(active))
        elif op == "index_ref":
            live = [p for p in range(1, kv.n_pages)
                    if kv.refcount(p) > 0 and p not in index_refs]
            if live:
                pid = rng.choice(live)
                kv.ref(pid)
                index_refs[pid] = 1
        elif op == "index_unref" and index_refs:
            pid = rng.choice(sorted(index_refs))
            kv.unref(pid)
            del index_refs[pid]
        assert kv.live_pages + kv.free_page_count == kv.usable_pages
        rows = {}
        for s in range(kv.max_seqs):
            for pid in kv.owned_pages(s):
                rows[pid] = rows.get(pid, 0) + 1
        for pid in range(kv.n_pages):
            assert kv.refcount(pid) == rows.get(pid, 0) + \
                index_refs.get(pid, 0)
    for slot in kv.active_slots():
        kv.release(slot)
    for pid in list(index_refs):
        kv.unref(pid)
    assert kv.free_page_count == kv.usable_pages and kv.live_pages == 0


@pytest.mark.parametrize("seed", range(16))
def test_allocator_conservation_fixed_seeds(seed):
    alloc_soup(seed)


if given is not None:
    @settings(deadline=None)
    @given(st.integers(0, 10**9))
    def test_allocator_conservation_under_random_interleavings(seed):
        alloc_soup(seed)


def test_share_and_ref_refuse_dead_pages_and_late_attach():
    kv = _bare_kv()
    s = kv.alloc_slot()
    with pytest.raises(ValueError, match="not a live page"):
        kv.share(s, [3])
    with pytest.raises(ValueError, match="not a live page"):
        kv.ref(0)
    kv.ensure(s, 4)
    with pytest.raises(ValueError, match="must precede"):
        kv.share(s, kv.owned_pages(s))


# ---------------------------------------------------------------------------
# compact() moves the device pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_bits", [0, 4])
def test_compact_moves_every_page_leaf_as_the_reference(kv_bits):
    """Both packages compact the same allocator state; the port's pool
    (every leaf: fp pages, or codes, alphas and betas) moves as the
    reference's does, and the index follows its pages."""
    jcfg = jax_get_config("tiny-lm").replace(n_layers=2, dtype="float32")
    cfg = get_config("tiny-lm").replace(n_layers=2, dtype="float32")
    kw = dict(n_pages=9, page_size=4, max_seqs=2, max_pages_per_seq=4,
              dtype="float32", kv_bits=kv_bits)
    jkv, tkv = JaxKV(jcfg, **kw), PagedKVCache(cfg, device="cpu", **kw)
    rng = np.random.default_rng(kv_bits)
    pool = {}
    for name, leaf in jkv.pool["L0"].items():
        a = rng.integers(-2 ** 31, 2 ** 31, leaf.shape, dtype=np.int64) \
            if leaf.dtype == jnp.uint32 else rng.standard_normal(leaf.shape)
        pool[name] = a.astype(np.int32 if leaf.dtype == jnp.uint32
                              else np.float32)
        jkv.pool["L0"][name] = jnp.asarray(
            a.astype(np.uint32) if leaf.dtype == jnp.uint32
            else a.astype(np.float32))
        for layer, t in enumerate(tkv.pool):
            t[name] = torch.from_numpy(pool[name][layer].copy())
    jidx, tidx = JaxIndex(jkv), RadixPrefixCache(tkv)
    for kv, idx in ((jkv, jidx), (tkv, tidx)):
        s0, s1 = kv.alloc_slot(), kv.alloc_slot()
        kv.ensure(s0, 4)
        kv.ensure(s1, 12)
        idx.insert(np.asarray([1, 2, 3, 4]), kv.owned_pages(s0))
        kv.release(s0)                      # a hole below s1's pages
        kv.release(s1)
        kv.alloc_slot()
        kv.ensure(0, 6)
    jpool = jkv.compact()
    tpool = tkv.compact()
    _same(jkv, jidx, tkv, tidx)
    for name, leaf in jpool["L0"].items():
        want = np.asarray(leaf)
        if want.dtype == np.uint32:
            want = want.view(np.int32)
        for layer, t in enumerate(tpool):
            np.testing.assert_array_equal(t[name].numpy(), want[layer])
    # the remapped prefix still matches, and forks on write
    n, pages = tidx.lookup(np.asarray([1, 2, 3, 4, 9]))
    assert n == 4
    s = tkv.alloc_slot()
    tkv.share(s, pages)
    tkv.ensure(s, 6)
    assert len(tkv.cow_for_write(s, 2, 6)) == 1
