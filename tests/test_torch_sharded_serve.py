"""Mesh serving on the CPU (the reference's tests/test_sharded_serve.py).

Host part: the port's sharded allocator (serve/kv_cache.py n_shards),
shard-local prefix index and sharded state slabs against the
reference's PagedKVCache(n_shards=..., create_pool=False), radix index
and StateSlabPool, state for state after every operation: the
reference's per-shard cases, then seeded random sequences.

Engine part: spawned gloo ranks (dist/context.py:spawn, one torch thread
a rank) serve on meshes (2, 1), (1, 2), (2, 2) and (1, 4), each rank
loading its slice with load_packed(mesh=) (held leaf for leaf to
shard_params of the whole tree): tiny-lm w3 per-channel and g64 bf16,
tiny-lm with 4-bit KV pages, tiny-moe (experts on the model axis),
shared-prefix waves with chunked prefill, and on the data axis the zoo's
Mamba, hybrid and MLA smoke artifacts; FSDP-sharded tiny-lm w3
(load_packed(fsdp=True)) on (2, 1) and (2, 2), plainly and
speculatively, and tiny-moe, the zoo's quantized MLA and hybrid
artifacts, MLA's dense latents and a one-KV-head smoke Qwen3-MoE
(replicated pool, sequence-split dense k/v) FSDP-sharded too; the
smoke Qwen3-MoE (4 heads, 2 KV heads) on (1, 4) with
pools replicated over the model axis, fp and 4-bit, with prefix sharing
and chunked prefill; dense caches split along the sequence (minicpm3-4b's
latents, qwen3-4b's k/v) on (1, 2) and (1, 4). Greedy tokens must equal
the reference's single-device engine's (the committed fixture, or the
reference's engine run here), logits within 1e-4 x max|logit| of the
reference's (or of the port's single-device engine), every shard's
pages drained and each rank's page ids inside its block. Then the
refusals, and chip_smoke's phase 12 rehearsed."""
import atexit
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.serve.kv_cache import OutOfPages as JaxOutOfPages
from repro.serve.kv_cache import PagedKVCache as JaxPagedKVCache
from repro.serve.prefix_cache import RadixPrefixCache as JaxIndex
from repro.serve.state_slab import StateSlabPool as JaxSlabs
from repro_torch.ckpt.packed import load_packed
from repro_torch.configs import get_config, smoke_config
from repro_torch.dist.context import ServeMesh, spawn
from repro_torch.launch.mesh import make_serve_mesh
from repro_torch.serve import OutOfPages, PagedKVCache, ServeEngine
from repro_torch.serve.prefix_cache import RadixPrefixCache
from repro_torch.serve.state_slab import StateSlabPool
from torch_mesh import FIXTURE, REF, ZOO, fail_on_rank_1, serve_cases
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
TOL = REF["logits_rtol"]


def _kvs(n_pages=16, page_size=4, max_seqs=4, n_shards=2, **kw):
    """The port's and the reference's allocators, without pools."""
    args = dict(n_pages=n_pages, page_size=page_size, max_seqs=max_seqs,
                n_shards=n_shards, create_pool=False, **kw)
    return PagedKVCache(None, **args), JaxPagedKVCache(None, **args)


def _state(kv):
    return (kv._free_by_shard, kv._refcount.tolist(),
            kv.block_tables.tolist(), [kv.owned_pages(s)
                                       for s in range(kv.max_seqs)],
            kv.active_slots(), kv.bt_version.tolist(), kv.high_water,
            kv.cow_forks, kv.pages_allocated)


def _check_shard_invariants(kv):
    """The global invariants, their per-shard versions, and page
    locality (every owned page in its slot's shard)."""
    assert kv.live_pages + kv.free_page_count == kv.usable_pages
    for sh in range(kv.n_shards):
        assert kv.live_in_shard(sh) + kv.free_in_shard(sh) \
            == kv.usable_in_shard(sh)
        reserve = kv.null_page_of_shard(sh)
        assert kv.refcount(reserve) == 0 and reserve not in kv._free
    for s in range(kv.max_seqs):
        for pid in kv.owned_pages(s):
            assert kv.shard_of_page(pid) == kv.shard_of_slot(s)
            assert not kv.is_reserve_page(pid)


def both(mine, ref, op):
    """Apply `op` to both allocators (or indexes); returns and raised
    OutOfPages must agree, and so must the allocators' state."""
    out = []
    for obj, oop in ((mine, OutOfPages), (ref, JaxOutOfPages)):
        try:
            out.append(("ok", op(obj)))
        except oop:
            out.append(("oop", None))
    assert out[0] == out[1]
    return out[0][1]


# ---------------------------------------------------------------------------
# allocator: per-shard accounting, state for state against the reference
# ---------------------------------------------------------------------------

def test_shard_geometry_and_reserve_pages():
    kv, jkv = _kvs(n_pages=16, max_seqs=4, n_shards=2)
    for k in (kv, jkv):
        assert k.pages_per_shard == 8 and k.seqs_per_shard == 2
        assert k.usable_pages == 14 and k.usable_in_shard(0) == 7
        assert k.null_page_of_shard(0) == 0 and k.null_page_of_shard(1) == 8
        assert k.shard_of_slot(0) == 0 and k.shard_of_slot(3) == 1
        assert k.shard_of_page(7) == 0 and k.shard_of_page(8) == 1
    assert kv._free == jkv._free
    one, jone = _kvs(n_pages=9, max_seqs=3, n_shards=1)
    assert one.usable_pages == jone.usable_pages == 8
    assert kv.local_page(9) == 1 and kv.local_page(0) == 0


def test_alloc_stays_in_slot_shard():
    kv, jkv = _kvs()
    s0 = both(kv, jkv, lambda k: k.alloc_slot(shard=0))
    s1 = both(kv, jkv, lambda k: k.alloc_slot(shard=1))
    assert kv.shard_of_slot(s0) == 0 and kv.shard_of_slot(s1) == 1
    both(kv, jkv, lambda k: k.ensure(s0, 10))
    both(kv, jkv, lambda k: k.ensure(s1, 6))
    assert _state(kv) == _state(jkv)
    _check_shard_invariants(kv)
    assert kv.free_in_shard(0) == 4 and kv.free_in_shard(1) == 5


def test_out_of_pages_is_per_shard():
    kv, jkv = _kvs(n_pages=8, page_size=4, max_seqs=2, n_shards=2,
                   max_pages_per_seq=6)
    s0 = both(kv, jkv, lambda k: k.alloc_slot(shard=0))
    both(kv, jkv, lambda k: k.ensure(s0, 3 * 4))
    with pytest.raises(OutOfPages):    # shard 1 has 3 free, irrelevant
        kv.ensure(s0, 4 * 4)
    both(kv, jkv, lambda k: k.ensure(s0, 4 * 4))
    _check_shard_invariants(kv)        # a failed ensure allocated nothing
    s1 = both(kv, jkv, lambda k: k.alloc_slot(shard=1))
    both(kv, jkv, lambda k: k.ensure(s1, 3 * 4))
    assert _state(kv) == _state(jkv)
    _check_shard_invariants(kv)


def test_cow_fork_and_release_stay_in_shard():
    kv, jkv = _kvs()
    donor = both(kv, jkv, lambda k: k.alloc_slot(shard=1))
    both(kv, jkv, lambda k: k.ensure(donor, 8))
    fresh = both(kv, jkv, lambda k: k.alloc_slot(shard=1))
    both(kv, jkv, lambda k: k.share(fresh, k.owned_pages(donor)))
    copies = both(kv, jkv, lambda k: k.cow_for_write(fresh, 0, 8))
    assert copies and all(kv.shard_of_page(d) == 1 for _, d in copies)
    _check_shard_invariants(kv)
    both(kv, jkv, lambda k: k.release(donor))
    both(kv, jkv, lambda k: k.release(fresh))
    assert _state(kv) == _state(jkv)
    _check_shard_invariants(kv)
    assert kv.free_in_shard(1) == kv.usable_in_shard(1)


def test_share_rejects_cross_shard_pages():
    kv, jkv = _kvs()
    donor = both(kv, jkv, lambda k: k.alloc_slot(shard=0))
    both(kv, jkv, lambda k: k.ensure(donor, 4))
    borrower = both(kv, jkv, lambda k: k.alloc_slot(shard=1))
    with pytest.raises(ValueError, match="cross-shard"):
        kv.share(borrower, kv.owned_pages(donor))
    with pytest.raises(AssertionError, match="cross-shard"):
        jkv.share(borrower, jkv.owned_pages(donor))
    assert _state(kv) == _state(jkv)


def test_compact_remaps_within_shards():
    kv, jkv = _kvs(n_pages=16, page_size=4, max_seqs=4, n_shards=2)
    slots = [both(kv, jkv, lambda k, sh=sh: k.alloc_slot(shard=sh))
             for sh in (0, 1)]
    for s in slots:
        both(kv, jkv, lambda k, s=s: k.ensure(s, 12))
    both(kv, jkv, lambda k: k.release(slots[0]))
    s0b = both(kv, jkv, lambda k: k.alloc_slot(shard=0))
    both(kv, jkv, lambda k: k.ensure(s0b, 8))
    # shard 1's block of a pool: page p holds the value p (local ids)
    pool = [{"k_pages": torch.arange(8.0)[:, None, None, None]
             .expand(8, 4, 1, 2).clone()}]
    before = {p: kv.local_page(p) for p in kv.owned_pages(slots[1])}
    moved = kv.compact(pool, shard=1)
    jkv.compact()
    assert _state(kv) == _state(jkv)
    _check_shard_invariants(kv)
    for s in (s0b, slots[1]):
        lo = kv.null_page_of_shard(kv.shard_of_slot(s)) + 1
        got = kv.owned_pages(s)
        assert got == list(range(lo, lo + len(got)))
    # the local block moved with the remap: new page j holds old page's
    for new, old in zip(kv.owned_pages(slots[1]), before.values()):
        assert float(moved[0]["k_pages"][kv.local_page(new), 0, 0, 0]) \
            == old


def test_pick_shard_prefers_free_pages():
    kv, jkv = _kvs(n_pages=16, page_size=4, max_seqs=4, n_shards=2)
    assert both(kv, jkv, lambda k: k.pick_shard()) == 0
    s0 = both(kv, jkv, lambda k: k.alloc_slot(shard=0))
    both(kv, jkv, lambda k: k.ensure(s0, 16))
    assert both(kv, jkv, lambda k: k.pick_shard()) == 1
    both(kv, jkv, lambda k: k.alloc_slot(shard=1))
    both(kv, jkv, lambda k: k.alloc_slot(shard=1))
    assert both(kv, jkv, lambda k: k.pick_shard()) == 0


def test_reserve_page_guards_cover_every_shard():
    """share() and ref() reject each shard's reserve page, not just
    global page 0."""
    kv, _ = _kvs(n_pages=8, page_size=4, n_shards=2)
    reserve1 = kv.null_page_of_shard(1)
    assert reserve1 == kv.pages_per_shard != 0
    kv._refcount[reserve1] = 1
    with pytest.raises(ValueError, match="not a live page"):
        kv.ref(reserve1)
    s = kv.alloc_slot(shard=1)
    with pytest.raises(ValueError, match="not a live page"):
        kv.share(s, [reserve1])
    kv._refcount[reserve1] = 0


# ---------------------------------------------------------------------------
# prefix index: shard-local chains
# ---------------------------------------------------------------------------

def _indexed(**kw):
    kv, jkv = _kvs(**kw)
    return kv, jkv, RadixPrefixCache(kv), JaxIndex(jkv)


def test_prefix_index_is_shard_local():
    kv, jkv, idx, jidx = _indexed(n_pages=24, page_size=4, max_seqs=4,
                                  n_shards=2)
    toks = np.arange(8)
    s0 = both(kv, jkv, lambda k: k.alloc_slot(shard=0))
    both(kv, jkv, lambda k: k.ensure(s0, 8))
    idx.insert(toks, kv.owned_pages(s0))
    jidx.insert(toks, jkv.owned_pages(s0))
    both(kv, jkv, lambda k: k.release(s0))
    for shard in (0, 1, None):
        assert idx.lookup(toks, shard=shard) == jidx.lookup(toks,
                                                            shard=shard)
    assert idx.lookup(toks, shard=1) == (0, [])
    s1 = both(kv, jkv, lambda k: k.alloc_slot(shard=1))
    both(kv, jkv, lambda k: k.ensure(s1, 8))
    idx.insert(toks, kv.owned_pages(s1))
    jidx.insert(toks, jkv.owned_pages(s1))
    both(kv, jkv, lambda k: k.release(s1))
    n1, pages1 = idx.lookup(toks, shard=1)
    assert n1 == 8 and all(kv.shard_of_page(p) == 1 for p in pages1)
    assert idx.evict(8, shard=1) == jidx.evict(8, shard=1) == 2
    assert idx.lookup(toks, shard=0)[0] == 8
    assert idx.lookup(toks, shard=1) == (0, [])
    assert _state(kv) == _state(jkv)
    _check_shard_invariants(kv)


def test_reclaim_under_pressure_is_shard_local():
    kv, jkv, idx, jidx = _indexed(n_pages=12, page_size=4, max_seqs=4,
                                  n_shards=2)
    for sh in (0, 1):                  # 2 index-only pages a shard
        s = both(kv, jkv, lambda k, sh=sh: k.alloc_slot(shard=sh))
        both(kv, jkv, lambda k, s=s: k.ensure(s, 8))
        idx.insert(np.arange(8) + 100 * sh, kv.owned_pages(s))
        jidx.insert(np.arange(8) + 100 * sh, jkv.owned_pages(s))
        both(kv, jkv, lambda k, s=s: k.release(s))
    assert idx.cached_pages() == 4
    s = both(kv, jkv, lambda k: k.alloc_slot(shard=0))
    both(kv, jkv, lambda k: k.ensure(s, 5 * 4))   # all 5 of shard 0
    assert kv.free_in_shard(1) == 3                 # shard 1's cache kept
    assert idx.lookup(np.arange(8) + 100, shard=1)[0] == 8
    assert _state(kv) == _state(jkv)
    _check_shard_invariants(kv)


@pytest.mark.parametrize("seed", range(6))
def test_sharded_allocator_and_index_match_the_reference(seed):
    """Seeded random traffic over a 2- or 3-shard pool with a prefix
    index: admissions on pick_shard, growth, prefix attach + COW, finish
    with insert, release, truncation, shard-filtered lookups and
    evictions, compaction; every return value, exhaustion and state
    equal to the reference's after each operation."""
    rng = np.random.default_rng(seed)
    n_shards = 2 + seed % 2
    kv, jkv, idx, jidx = _indexed(n_pages=12 * n_shards, page_size=4,
                                  max_seqs=2 * n_shards, n_shards=n_shards,
                                  max_pages_per_seq=8)
    pair = ((kv, idx), (jkv, jidx))
    vocab = [rng.integers(0, 5, 6) for _ in range(3)]
    live: dict = {}
    for step in range(120):
        op = rng.choice(["admit", "grow", "finish", "truncate", "lookup",
                         "evict", "compact"], p=[.3, .25, .2, .08, .07, .05,
                                                 .05])
        if op == "admit":
            shard = both(kv, jkv, lambda k: k.pick_shard())
            if shard is None:
                continue
            toks = np.concatenate([vocab[rng.integers(3)],
                                   rng.integers(0, 5, rng.integers(1, 9))])
            n, pages = idx.lookup(toks, max_tokens=len(toks) - 1,
                                  shard=shard)
            assert (n, pages) == jidx.lookup(toks, max_tokens=len(toks) - 1,
                                             shard=shard)
            s = both(kv, jkv, lambda k: k.alloc_slot(shard=shard))
            both(kv, jkv, lambda k: k.share(s, pages))
            both(kv, jkv, lambda k: k.ensure(s, len(toks)))
            if len(kv.owned_pages(s)) >= kv.pages_for(len(toks)):
                both(kv, jkv, lambda k: k.cow_for_write(s, n, len(toks)))
            live[s] = toks
        elif op == "grow" and live:
            s = sorted(live)[rng.integers(len(live))]
            n = len(live[s]) + int(rng.integers(1, 6))
            both(kv, jkv, lambda k: k.ensure(s, n))
            if len(kv.owned_pages(s)) >= kv.pages_for(n):
                both(kv, jkv, lambda k: k.cow_for_write(s, n - 1, n))
                live[s] = np.concatenate([live[s], rng.integers(0, 5, n
                                          - len(live[s]))])
        elif op == "finish" and live:
            s = sorted(live)[rng.integers(len(live))]
            toks = live.pop(s)
            for k, ix in pair:
                held = min(len(toks), len(k.owned_pages(s)) * k.page_size)
                if held:
                    ix.insert(toks[:held], k.owned_pages(s))
                k.release(s)
        elif op == "truncate" and live:
            s = sorted(live)[rng.integers(len(live))]
            keep = int(rng.integers(1, max(2, len(live[s]))))
            if len(kv.owned_pages(s)) >= kv.pages_for(keep):
                both(kv, jkv, lambda k: k.truncate(s, keep))
                live[s] = live[s][:keep]
        elif op == "lookup":
            toks = vocab[rng.integers(3)]
            for shard in [None, *range(n_shards)]:
                assert idx.lookup(toks, shard=shard) == jidx.lookup(
                    toks, shard=shard)
        elif op == "evict":
            shard, n = int(rng.integers(n_shards)), int(rng.integers(1, 4))
            assert idx.evict(n, shard=shard) == jidx.evict(n, shard=shard)
        elif op == "compact":
            kv.compact()
            jkv.compact()
        assert _state(kv) == _state(jkv), (step, op)
        _check_shard_invariants(kv)


@pytest.mark.parametrize("seed", range(3))
def test_sharded_state_slabs_match_the_reference(seed):
    rng = np.random.default_rng(seed)
    cfg, n_shards = smoke_config("falcon-mamba-7b"), 2 + seed % 2
    from repro.configs import smoke_config as jax_smoke_config
    kw = dict(n_slabs=3 * n_shards, max_seqs=2 * n_shards,
              n_shards=n_shards)
    mine = StateSlabPool(cfg, **kw)
    ref = JaxSlabs(jax_smoke_config("falcon-mamba-7b"), **kw)
    for _ in range(60):
        slot = int(rng.integers(kw["max_seqs"]))
        op = rng.choice(["alloc", "release", "compact"], p=[.5, .4, .1])
        if op == "alloc" and mine.slab_of(slot) is None:
            both(mine, ref, lambda p: p.alloc(slot))
        elif op == "release":
            mine.release(slot)
            ref.release(slot)
        elif op == "compact":
            assert mine.compact() == ref.compact()
        assert mine._free_by_shard == ref._free_by_shard
        assert mine._refcount.tolist() == ref._refcount.tolist()
        assert mine._slab_of_slot.tolist() == ref._slab_of_slot.tolist()
        for sh in range(n_shards):
            assert mine.live_in_shard(sh) + mine.free_in_shard(sh) \
                == mine.usable_in_shard(sh)
            sid = mine.slab_of(slot)
            assert sid is None or mine.shard_of_slab(sid) \
                == mine.shard_of_slot(slot)


# ---------------------------------------------------------------------------
# engines on meshes of spawned gloo ranks
# ---------------------------------------------------------------------------

MESHES = [(2, 1), (1, 2), (2, 2)]
PREFIX_RUN = "w3_pc/share_chunk5"
ZOO_DATA_AXIS = ("mamba_fp", "mamba-mix_quant", "mla_fp")
ZOO_MODEL_AXIS = ("mla_fp", "mla_quant", "mamba_fp", "mamba-mix_fp",
                  "mamba-mix_quant")
FSDP_FAMILIES = ("w3_moe", "zoo/mla_quant", "zoo/mamba-mix_quant")


def _cases(mesh_shape):
    if mesh_shape == (1, 4):
        return {**rep_cases(), **dense_cases()}
    art, kv = REF["artifacts"], REF["kv_bits"]
    cases = {name: {"artifact": name, "kv_bits": 0, "page_size": 16,
                    "prompts": art[name]["prompts"],
                    "max_new": REF["max_new"]}
             for name in ("w3_pc", "w3_g64_bf16", "w3_moe")}
    cases["w3_pc_kv4"] = {"artifact": "w3_pc", "kv_bits": kv["bits"],
                          "page_size": kv["page_size"],
                          "prompts": kv["artifacts"]["w3_pc"]["prompts"],
                          "max_new": REF["max_new"]}
    run = REF["prefix"]["runs"][PREFIX_RUN]
    eng = run["engine"]
    cases["prefix"] = {"artifact": "w3_pc", "kv_bits": 0,
                       "page_size": eng["page_size"],
                       "prefix_sharing": True,
                       "prefill_chunk": eng["prefill_chunk"],
                       "waves": run["waves"], "max_new": run["max_new"]}
    # every family serves on the data axis; MLA and Mamba on a model
    # axis too
    for name in (ZOO_DATA_AXIS if mesh_shape[1] == 1 else ZOO_MODEL_AXIS):
        cases[f"zoo/{name}"] = _zoo_case(name)
    # self-speculation, k=2 with a w2 draft: refit at boot (greedy), or
    # the v4 draft block of a copy of w3_pc saved with one (typical)
    for rule, art, draft in (("greedy", "w3_pc", None),
                             ("typical", str(draft_artifact()), "block")):
        cases[f"spec_{rule}"] = {"artifact": art, "kv_bits": 0,
                                 "page_size": 16,
                                 "prompts": REF["artifacts"]["w3_pc"][
                                     "prompts"],
                                 "max_new": REF["max_new"], "speculate": 2,
                                 "accept_rule": rule, "draft": draft}
    if mesh_shape[0] == 2:
        # weights sharded over the data axis too: plainly, and speculating
        # with a refit and with the draft block cut as the leaves' scales
        base = {**cases["w3_pc"], "fsdp": True}
        cases["fsdp"] = base
        cases["fsdp_spec"] = {**base, "speculate": 2,
                              "accept_rule": "greedy"}
        cases["fsdp_spec_block"] = {**cases["fsdp_spec"],
                                    "artifact": str(draft_artifact()),
                                    "draft": "block"}
        # and every family: tiny-moe's experts, the zoo's quantized MLA
        # and hybrid (Mamba, attention, MoE) artifacts; MLA's dense
        # latent cache split along the sequence on (2, 2)
        for name in FSDP_FAMILIES:
            case = cases.get(name) or _zoo_case(name[4:])
            cases[f"fsdp/{name}"] = {**case, "fsdp": True}
        if mesh_shape[1] == 2:
            cases["fsdp/dense/mla"] = {**dense_cases()["dense/mla"],
                                       "fsdp": True}
            # one KV head, which the model axis does not divide: the
            # paged pool replicated, the dense k/v split along the
            # sequence
            _, cfg1, _, fp1 = rep_model(n_kv_heads=1)
            mqa = {"cfg": cfg1, "params": fp1, "kv_bits": 0,
                   "page_size": 8, "prompts": _prompts(14, cfg1.vocab_size),
                   "max_new": 6, "fsdp": True, "ref_model": (None, 1)}
            cases["fsdp/rep/mqa"] = mqa
            cases["fsdp/dense/mqa"] = {**mqa, "cache_kind": "dense"}
    if mesh_shape == (1, 2):
        cases.update(dense_cases())
    return cases


def _zoo_case(name):
    ent = ZOO["artifacts"][name]
    return {"artifact": f"zoo/{name}", "kv_bits": 0,
            "page_size": ZOO["page_size"], "prompts": ent["prompts"],
            "max_new": ZOO["max_new"]}


def _prompts(seed, vocab, lens=(5, 12, 19)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32).tolist()
            for n in lens]


def rep_model(head_dim=None, n_kv_heads=None):
    """(jcfg, cfg, reference params, port params) of the smoke Qwen3-MoE
    (4 heads, 2 KV heads), at `head_dim` (4-bit pages need 32) and
    `n_kv_heads` (1: one KV head, which no model axis divides)."""
    from torch_zoo import zoo
    st = zoo("qwen3-moe-235b-a22b")
    kw = {k: v for k, v in (("head_dim", head_dim),
                            ("n_kv_heads", n_kv_heads)) if v is not None}
    if not kw:
        return st["jcfg"], st["cfg"], st["jfp"], st["fp"]
    key = ("rep_model", head_dim, n_kv_heads)
    if key not in _ONE:
        import jax
        from repro.models import init_params as jax_init_params
        from repro_torch.ckpt import params_from_tree
        from torch_zoo import KEY
        jcfg = st["jcfg"].replace(**kw)
        jp = jax_init_params(jcfg, KEY)
        _ONE[key] = (jcfg, st["cfg"].replace(**kw), jp,
                     params_from_tree(jax.tree.map(np.asarray, jp),
                                      device="cpu"))
    return _ONE[key]


def rep_cases():
    """The smoke Qwen3-MoE, whose 2 KV heads a 4-way model axis does not
    divide: fp and 4-bit pages, and shared-prefix waves through 5-token
    chunks."""
    _, cfg, _, fp = rep_model()
    _, cfg32, _, fp32 = rep_model(32)
    prompts = _prompts(11, cfg.vocab_size)
    base = {"cfg": cfg, "params": fp, "kv_bits": 0, "page_size": 8,
            "prompts": prompts, "max_new": 6}
    rng = np.random.default_rng(12)
    prefix = rng.integers(0, cfg.vocab_size, 16).tolist()
    tail = lambda n: rng.integers(0, cfg.vocab_size, n).tolist()
    waves = [[prefix + tail(3), prefix + tail(5)],
             [prefix + tail(4), prefix + tail(2)]]
    return {"rep/fp": base,
            "rep/kv4": {**base, "cfg": cfg32, "params": fp32, "kv_bits": 4,
                        "ref_model": (32, None)},
            "rep/prefix": {**base, "prefix_sharing": True,
                           "prefill_chunk": 5, "waves": waves}}


def dense_cases():
    """Dense caches: minicpm3-4b's latents (the zoo's MLA artifact, split
    along the sequence on any model axis) and qwen3-4b's k/v (split along
    the sequence where the axis does not divide its 2 KV heads)."""
    from torch_zoo import zoo
    st = zoo("qwen3-4b")
    ent = ZOO["artifacts"]["mla_fp"]
    return {"dense/mla": {"artifact": "zoo/mla_fp", "cache_kind": "dense",
                          "kv_bits": 0, "page_size": ZOO["page_size"],
                          "prompts": ent["prompts"],
                          "max_new": ZOO["max_new"]},
            "dense/qwen3-4b": {"cfg": st["cfg"], "params": st["fp"],
                               "cache_kind": "dense", "kv_bits": 0,
                               "page_size": 8,
                               "prompts": _prompts(13, st["cfg"].vocab_size),
                               "max_new": 6}}


_ONE: dict = {}


def draft_artifact():
    """w3_pc saved by the port with a w2 draft block (once a process, in
    a temporary directory removed at exit)."""
    if "dir" not in _ONE:
        from repro_torch.ckpt.packed import save_packed
        params, spec, meta = load_packed(FIXTURE / "w3_pc", device="cpu")
        cfg = get_config(meta["arch"]).replace(
            dtype="float32", n_layers=len(params["layers"]))
        tmp = tempfile.mkdtemp(prefix="w3_pc_draft_")
        atexit.register(shutil.rmtree, tmp, True)
        _ONE["dir"] = save_packed(Path(tmp) / "w3_pc", params, cfg=cfg,
                                  spec=spec, meta=meta, draft_bits=2)
    return _ONE["dir"]


def single_device(case) -> dict:
    """The port's single-device paged engine on a case's artifact and
    prompts (batch 2, as the ranks): tokens, and every logits row a
    token was taken from, by (request, token index); once a case."""
    key = (case["artifact"], case.get("accept_rule"))
    if key not in _ONE:
        from repro_torch.ckpt.packed import load_draft_scales
        from repro_torch.quant.draft import make_draft_params
        from repro_torch.serve import Request
        from torch_mesh import _config, record_logits
        art = FIXTURE / case["artifact"]
        params, _, meta = load_packed(art, device="cpu")
        cfg = _config(case["artifact"], params, meta)
        kw = {}
        if case.get("speculate"):
            kw = dict(speculate=case["speculate"], draft_bits=2,
                      accept_rule=case["accept_rule"],
                      draft_params=make_draft_params(
                          params, 2, load_draft_scales(art, device="cpu")))
        eng = ServeEngine(cfg, params, batch_size=2, max_len=64,
                          dtype="float32", cache_kind="paged",
                          page_size=case["page_size"],
                          prefix_sharing=False, device="cpu", **kw)
        reqs = [Request(prompt=np.asarray(p, np.int32),
                        max_new_tokens=case["max_new"])
                for p in case["prompts"]]
        log = record_logits(eng, reqs)
        eng.run(reqs)
        _ONE[key] = {"tokens": [r.out for r in reqs],
                     "logits": {(i, t): row.numpy()
                                for i, t, row, ctx in log if not ctx},
                     "spec_counts": (eng.stats["draft_tokens"],
                                     eng.stats["accepted_tokens"])}
    return _ONE[key]


def reference_typical(case) -> dict:
    """The reference's speculative paged engine under typical acceptance
    (tau 0.3, both engines' default) on a case's artifact, v4 draft
    block and prompts (batch 2, as the ranks): tokens and (draft,
    accepted) counts; once a case."""
    key = ("reference", case["artifact"], case["accept_rule"])
    if key not in _ONE:
        from repro.ckpt.packed import load_draft_scales as jax_draft_block
        from repro.ckpt.packed import load_packed as jax_load_packed
        from repro.configs import get_config as jax_get_config
        from repro.quant.draft import make_draft_params as jax_draft
        from repro.serve import Request as JaxRequest
        from repro.serve import ServeEngine as JaxServeEngine
        art = FIXTURE / case["artifact"]
        jp, _, meta = jax_load_packed(art)
        n_layers = len(load_packed(art, device="cpu")[0]["layers"])
        jcfg = jax_get_config(meta["arch"]).replace(dtype="float32",
                                                    n_layers=n_layers)
        eng = JaxServeEngine(jcfg, jp, batch_size=2, max_len=64,
                             dtype="float32", cache_kind="paged",
                             page_size=case["page_size"],
                             prefix_sharing=False,
                             speculate=case["speculate"], draft_bits=2,
                             accept_rule=case["accept_rule"],
                             draft_params=jax_draft(jp, 2,
                                                    jax_draft_block(art)))
        reqs = [JaxRequest(prompt=np.asarray(p, np.int32),
                           max_new_tokens=case["max_new"])
                for p in case["prompts"]]
        eng.run(reqs)
        _ONE[key] = {"tokens": [list(map(int, r.out)) for r in reqs],
                     "spec_counts": (int(eng.stats["draft_tokens"]),
                                     int(eng.stats["accepted_tokens"]))}
    return _ONE[key]


def reference_tokens(name, case):
    """The reference's single-device engine on a new case (its params
    are the reference's own init, the port's copy of which the ranks
    cut): greedy tokens (of every wave); the zoo's committed dense run
    for its MLA artifact. Once a case."""
    if name == "dense/mla":
        return ZOO["artifacts"]["mla_fp"]["dense"]
    key = ("reference", name)
    if key not in _ONE:
        from repro.serve import Request as JaxRequest
        from repro.serve import ServeEngine as JaxServeEngine
        from torch_zoo import zoo
        if "ref_model" in case or name.startswith("rep/"):
            jcfg, _, jp, _ = rep_model(*case.get("ref_model", ()))
        else:
            st = zoo("qwen3-4b")
            jcfg, jp = st["jcfg"], st["jfp"]
        eng = JaxServeEngine(
            jcfg, jp, batch_size=2, max_len=64, dtype="float32",
            cache_kind=case.get("cache_kind", "paged"),
            page_size=case["page_size"], kv_bits=case["kv_bits"],
            prefix_sharing=case.get("prefix_sharing", False),
            prefill_chunk=case.get("prefill_chunk"))
        out = []
        for wave in case.get("waves") or [case["prompts"]]:
            reqs = [JaxRequest(prompt=np.asarray(p, np.int32),
                               max_new_tokens=case["max_new"])
                    for p in wave]
            eng.run(reqs)
            out.append([list(map(int, r.out)) for r in reqs])
        _ONE[key] = out if case.get("waves") else out[0]
    return _ONE[key]


def port_single(name, case) -> dict:
    """The port's single-device engine on a new case: tokens and every
    logits row a token was taken from; once a case."""
    key = ("port", name)
    if key not in _ONE:
        from repro_torch.serve import Request
        from torch_mesh import _config, record_logits
        if "params" in case:
            cfg, params = case["cfg"], case["params"]
        else:
            params, _, meta = load_packed(FIXTURE / case["artifact"],
                                          device="cpu")
            cfg = _config(case["artifact"], params, meta)
        eng = ServeEngine(cfg, params, batch_size=2, max_len=64,
                          dtype="float32",
                          cache_kind=case.get("cache_kind", "paged"),
                          page_size=case["page_size"],
                          kv_bits=case["kv_bits"], prefix_sharing=False,
                          device="cpu")
        reqs = [Request(prompt=np.asarray(p, np.int32),
                        max_new_tokens=case["max_new"])
                for p in case["prompts"]]
        log = record_logits(eng, reqs)
        eng.run(reqs)
        _ONE[key] = {"tokens": [r.out for r in reqs],
                     "logits": {(i, t): row.numpy()
                                for i, t, row, ctx in log if not ctx}}
    return _ONE[key]


def _logits_close(got, want_rows) -> int:
    """Every logits row of a rank within TOL x max|logit| of the single
    device's; -> the rows compared."""
    for i, t, row in got["logits"]:
        ref = want_rows[(i, t)]
        np.testing.assert_allclose(row, ref, rtol=0,
                                   atol=TOL * np.abs(ref).max())
    return len(got["logits"])


_RUNS: dict = {}


def mesh_run(mesh_shape):
    """Every case of one mesh, served in one spawn (once a process):
    [rank results]."""
    if mesh_shape not in _RUNS:
        D, M = mesh_shape
        mesh = make_serve_mesh(D, M, ",".join(["cpu"] * (D * M)))
        assert mesh.backend == "gloo"
        _RUNS[mesh_shape] = spawn(serve_cases, mesh, (_cases(mesh_shape),),
                                  threads=1, timeout_s=300)
    return _RUNS[mesh_shape]


def _want(case):
    if case == "w3_pc_kv4":
        return REF["kv_bits"]["artifacts"]["w3_pc"]
    if case == "prefix":
        return {"tokens": REF["prefix"]["runs"][PREFIX_RUN]["tokens"]}
    if case.startswith("zoo/"):
        return {"tokens": ZOO["artifacts"][case[4:]]["paged"]}
    return REF["artifacts"][case]


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("case", ["w3_pc", "w3_g64_bf16", "w3_moe",
                                  "w3_pc_kv4", "prefix"])
def test_mesh_serves_the_reference_tokens_and_logits(mesh_shape, case):
    ranks = mesh_run(mesh_shape)
    want = _want(case)
    rows = 0
    for r in ranks:
        got = r[case]
        assert got["tokens"] == want["tokens"], (mesh_shape, r)
        assert got["same_as_shard_params"]
        assert got["drained"] and got["pages_in_own_block"]
        assert got["n_shards"] == mesh_shape[0]
        assert got["rows"] == 2 // mesh_shape[0]
        for i, t, row in (got["logits"] if case != "prefix" else ()):
            ref = np.asarray(want["prefill_logits"][i] if t == 0
                             else want["decode_logits"][i][t - 1])
            np.testing.assert_allclose(row, ref, rtol=0,
                                       atol=TOL * np.abs(ref).max())
            rows += 1
        if case == "prefix":
            assert got["prefix_hits"] > 0
    if case != "prefix":
        # every token's logits row, on the ranks of its data shard (all M
        # of them)
        n_tok = sum(len(t) for t in want["tokens"])
        assert rows == n_tok * mesh_shape[1]


@pytest.mark.parametrize("case", ["zoo/mamba_fp", "zoo/mamba-mix_quant",
                                  "zoo/mla_fp"])
def test_data_axis_serves_every_family(case):
    for r in mesh_run((2, 1)):
        got = r[case]
        assert got["tokens"] == _want(case)["tokens"]
        assert got["same_as_shard_params"] and got["drained"]
        assert got["pages_in_own_block"]


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2)])
@pytest.mark.parametrize("name", ZOO_MODEL_AXIS)
def test_model_axis_serves_mla_and_mamba(mesh_shape, name):
    """MLA (latent pages replicated over the model axis, heads split)
    and Mamba (d_inner split: in_proj by halves, x_proj by rows, the
    state rows by channels), alone and with attention and MoE (jamba's
    smoke pattern), give the reference's paged tokens; logits within
    1e-4 x max|logit| of the port's single-device engine's."""
    case = f"zoo/{name}"
    ranks = mesh_run(mesh_shape)
    one = single_device(_cases(mesh_shape)[case])
    assert one["tokens"] == _want(case)["tokens"]
    M, rows = mesh_shape[1], 0
    for r in ranks:
        got = r[case]
        assert got["tokens"] == _want(case)["tokens"], (mesh_shape, name)
        assert got["same_as_shard_params"] and got["drained"]
        assert got["pages_in_own_block"] and got["slabs_drained"]
        assert got["n_shards"] == mesh_shape[0]
        for i, t, row in got["logits"]:
            ref = one["logits"][(i, t)]
            np.testing.assert_allclose(row, ref, rtol=0,
                                       atol=TOL * np.abs(ref).max())
            rows += 1
        c = got["collectives"]
        assert c.get("all_reduce", 0) > 0
        cfg = smoke_config(ZOO["artifacts"][name]["arch"])
        if cfg.mamba is not None:
            # the state rows hold this rank's d_inner channels
            di = cfg.d_inner // M
            assert got["state_shapes"] and all(
                di in s[1:] for s in got["state_shapes"])
            # the slab pool counts this rank's share of the state
            whole = StateSlabPool(cfg, n_slabs=4, max_seqs=2,
                                  dtype="float32")
            assert got["slab_bytes"] * M == whole.bytes_per_slab()
    assert rows == sum(len(t) for t in one["tokens"]) * M


@pytest.mark.parametrize("mesh_shape", MESHES)
@pytest.mark.parametrize("rule", ["greedy", "typical"])
def test_mesh_speculates_as_one_device(mesh_shape, rule):
    """speculate=2 with a w2 self-draft on every mesh: greedy gives the
    reference's plain greedy tokens (its draft refit at boot, a row-split
    leaf refit on its gathered rows); typical (the draft block cut by
    load_draft_scales(mesh=)) gives the reference's typical engine's
    tokens and draft and accepted counts on the same artifact, block
    and prompts (a lossy rule: they may differ from greedy), as the
    port's single-device typical engine does. Every rank reports the
    same draft, accepted and tick counts."""
    case = _cases(mesh_shape)[f"spec_{rule}"]
    if rule == "greedy":
        want = REF["artifacts"]["w3_pc"]["tokens"]
    else:
        ref = reference_typical(case)
        one = single_device(case)
        assert one["tokens"] == ref["tokens"]
        assert one["spec_counts"] == ref["spec_counts"]
        want = ref["tokens"]
    counts = set()
    for r in mesh_run(mesh_shape):
        got = r[f"spec_{rule}"]
        assert got["tokens"] == want, (mesh_shape, rule, r["rank"])
        assert got["drained"] and got["pages_in_own_block"]
        assert got["same_as_shard_params"]
        # the draft's scales are the single device's, cut (fp32 rounding
        # of a refit on a column slice aside)
        assert got["draft_scales_err"] <= 1e-5
        counts.add(tuple(got["spec_counts"]))
    assert len(counts) == 1
    drafted, accepted, _ = counts.pop()
    assert drafted > 0
    if rule == "typical":
        assert (drafted, accepted) == ref["spec_counts"]


@pytest.mark.parametrize("mesh_shape", MESHES)
def test_mesh_collectives_and_pool_blocks(mesh_shape):
    """Model ranks all-reduce after wo and wd (2 a layer a step) and
    gather the split vocabulary; data ranks exchange tokens only; each
    rank's pool is its block of pages."""
    D, M = mesh_shape
    for r in mesh_run(mesh_shape):
        got = r["w3_pc"]
        c = got["collectives"]
        assert (c.get("all_reduce", 0) > 0) == (M > 1)
        assert (c.get("all_gather", 0) > 0) == (M > 1)
        assert (c.get("all_gather_host", 0) > 0) == (D > 1)
        n_pages = 2 * 4 + D                 # 2 seqs x 4 pages + reserves
        assert set(got["pool_pages"]) == {-(-n_pages // D)}


@pytest.mark.parametrize("mesh_shape", [(2, 1), (2, 2)])
@pytest.mark.parametrize("case", ["fsdp", "fsdp_spec", "fsdp_spec_block"])
def test_fsdp_mesh_serves_the_reference_tokens_and_logits(mesh_shape, case):
    """The reference's acceptance path (tests/test_sharded_serve.py:
    load_packed(mesh=, fsdp=True), then sharded serving) on the port:
    every rank holds its data-axis block of each leaf the rule cuts (as
    shard_params(fsdp=True) cuts it), about 1/D of its slice's bytes;
    the layers gather their weights over the data group; plain and
    speculative greedy (a refit on the gathered rows, or the v4 block
    cut as the leaves' scales) give the reference's tokens, plain
    logits within 1e-4 x max|logit| of the reference's."""
    want = REF["artifacts"]["w3_pc"]
    D, M = mesh_shape
    counts, rows = set(), 0
    for r in mesh_run(mesh_shape):
        got = r[case]
        assert got["tokens"] == want["tokens"], (mesh_shape, case)
        assert got["same_as_shard_params"]
        assert got["drained"] and got["pages_in_own_block"]
        assert got["collectives"].get("all_gather_data", 0) > 0
        # the norms replicate; every matrix is cut in D
        assert got["param_bytes"] < 0.55 * got["slice_bytes"]
        if case == "fsdp":
            for i, t, row in got["logits"]:
                ref = np.asarray(want["prefill_logits"][i] if t == 0
                                 else want["decode_logits"][i][t - 1])
                np.testing.assert_allclose(row, ref, rtol=0,
                                           atol=TOL * np.abs(ref).max())
                rows += 1
        else:
            assert got["draft_scales_err"] <= 1e-5
            counts.add(tuple(got["spec_counts"]))
    if case == "fsdp":
        assert rows == sum(len(t) for t in want["tokens"]) * M
    else:
        assert len(counts) == 1 and counts.pop()[0] > 0


@pytest.mark.parametrize("mesh_shape,case", [
    (shape, f"fsdp/{n}") for shape in ((2, 1), (2, 2))
    for n in FSDP_FAMILIES] + [((2, 2), f"fsdp/{n}") for n in (
        "dense/mla", "rep/mqa", "dense/mqa")])
def test_fsdp_serves_every_family(mesh_shape, case):
    """FSDP beyond tiny-lm: tiny-moe (its expert stacks' codes cut on
    their packed K), minicpm3's MLA (the latent expansion wkv_b made
    whole after the gather), jamba's hybrid pattern (Mamba's in_proj by
    halves and its channel leaves, attention, MoE) and, on (2, 2), the
    caches the model axis does not split by heads: MLA's dense latents
    and one KV head's dense k/v split along the sequence, and one KV
    head's paged pool replicated (the smoke Qwen3-MoE with n_kv_heads
    1). Every rank holds its data-axis block of each leaf the rule
    cuts; the reference's tokens, logits within 1e-4 x max|logit| of
    the reference's (tiny-moe) or of the port's single device."""
    M = mesh_shape[1]
    name = case[5:]
    spec = _cases(mesh_shape)[case]
    if "params" in spec or name == "dense/mla":
        want = reference_tokens(name, spec)
        one = port_single(name, spec)["logits"]
    elif name == "w3_moe":
        ref = REF["artifacts"][name]
        want = ref["tokens"]
        one = {(i, t): np.asarray(ref["prefill_logits"][i] if t == 0
                                  else ref["decode_logits"][i][t - 1])
               for i, toks in enumerate(want) for t in range(len(toks))}
    else:
        want = _want(name)["tokens"]
        one = single_device(spec)["logits"]
    rows = 0
    for r in mesh_run(mesh_shape):
        got = r[case]
        assert got["tokens"] == want, (mesh_shape, case)
        assert got["same_as_shard_params"] and got["drained"]
        assert got["collectives"].get("all_gather_data", 0) > 0
        # the matrices are cut in D; the norms, routers and expand
        # leaves' scales (a large share of these tiny models) are whole
        assert got["param_bytes"] < 0.75 * got["slice_bytes"]
        if name == "rep/mqa":          # every rank's pool: the one head
            assert all(c["k_pages"][2] == 1 for c in got["cache_shapes"])
        if name.startswith("dense/"):  # the rank's block of positions
            assert {c["c_kv"][1] if "c_kv" in c else c["k"][2]
                    for c in got["cache_shapes"]} == {64 // M}
        rows += _logits_close(got, one)
    assert rows == sum(len(t) for t in want) * M


@pytest.mark.parametrize("case", ["rep/fp", "rep/kv4", "rep/prefix"])
def test_replicated_pools_serve_the_reference_tokens(case):
    """The smoke Qwen3-MoE on (1, 4): a rank's one query head lies in one
    of the 2 KV heads' groups, so it keeps wk, wv and the pool whole (the
    rule replicates a pool the axis does not divide) and reads its
    group's head, fp or binary-coded, through decode, extend (prefix
    hits, 5-token chunks) and prefill: the reference's tokens, logits
    within 1e-4 x max|logit| of the port's single device."""
    spec = _cases((1, 4))[case]
    want = reference_tokens(case, spec)
    one = None if spec.get("waves") else port_single(case, spec)
    if one is not None:
        assert one["tokens"] == want
    pool = "k_codes" if spec["kv_bits"] else "k_pages"
    rows = 0
    for r in mesh_run((1, 4)):
        got = r[case]
        assert got["tokens"] == want, case
        assert got["drained"] and got["pages_in_own_block"]
        assert got["same_as_shard_params"]
        assert all(c[pool][2] == 2 for c in got["cache_shapes"])
        if one is not None:
            rows += _logits_close(got, one["logits"])
        else:
            assert got["prefix_hits"] > 0
    if one is not None:
        assert rows == sum(len(t) for t in want) * 4


@pytest.mark.parametrize("mesh_shape", [(1, 2), (1, 4)])
@pytest.mark.parametrize("case", ["dense/mla", "dense/qwen3-4b"])
def test_dense_caches_split_the_sequence(mesh_shape, case):
    """Dense caches on a model axis: MLA's latents, and qwen3-4b's k/v
    where the axis does not divide its 2 KV heads (on (1, 4)), hold the
    rank's 64 / M positions; decode gathers every head's query, attends
    over the rank's positions and merges the heads' partial softmax
    states over the model group. The reference's dense tokens, logits
    within 1e-4 x max|logit| of the port's single device."""
    spec = _cases(mesh_shape)[case]
    want = reference_tokens(case, spec)
    one = port_single(case, spec)
    assert one["tokens"] == want
    M = mesh_shape[1]
    split = case == "dense/mla" or M == 4
    rows = 0
    for r in mesh_run(mesh_shape):
        got = r[case]
        assert got["tokens"] == want, (mesh_shape, case)
        assert got["drained"] and got["same_as_shard_params"]
        lens = {c["c_kv"][1] if "c_kv" in c else c["k"][2]
                for c in got["cache_shapes"]}
        assert lens == {64 // M if split else 64}
        rows += _logits_close(got, one["logits"])
        if split:
            assert got["collectives"].get("all_gather", 0) > 0
    assert rows == sum(len(t) for t in want) * M


def test_refusals():
    """Odd batches, query heads that straddle two GQA groups, unsliced
    params, speculation on an MLA or Mamba pattern (as on one device), a
    d_inner the model axis does not divide, and mixed devices raise,
    naming what remains."""
    two = ServeMesh(2, 1, ["cpu", "cpu"], rank=0)
    tp2 = ServeMesh(1, 2, ["cpu", "cpu"], rank=0)
    params, _, _ = load_packed(FIXTURE / "w3_pc", device="cpu")
    cfg = get_config("tiny-lm").replace(dtype="float32", n_layers=2)
    with pytest.raises(ValueError, match="batch_size=3"):
        ServeEngine(cfg, params, batch_size=3, cache_kind="paged",
                    mesh=two)
    for arch in ("minicpm3-4b", "falcon-mamba-7b"):
        with pytest.raises(NotImplementedError,
                           match="attention-only.*MLA drafts"):
            ServeEngine(smoke_config(arch), {}, cache_kind="paged",
                        speculate=2, mesh=tp2)
    with pytest.raises(ValueError,
                       match="3 of n_heads=6.*straddle.*n_kv_heads=3"):
        # tiny-lm-wide: 6 query heads over 3 KV heads, 3 a rank of 2
        ServeEngine(get_config("tiny-lm-wide"), {}, cache_kind="paged",
                    mesh=tp2)
    with pytest.raises(ValueError, match="bound mesh"):
        load_packed(FIXTURE / "w3_pc", mesh=make_serve_mesh(1, 2, "cpu,cpu"))
    with pytest.raises(ValueError, match="output columns"):
        ServeEngine(cfg, params, cache_kind="paged", mesh=tp2)
    with pytest.raises(ValueError, match="does not divide d_inner=128"):
        ServeEngine(smoke_config("falcon-mamba-7b"), {}, cache_kind="paged",
                    mesh=ServeMesh(1, 3, ["cpu"] * 3, rank=0))
    with pytest.raises(ValueError, match="3 of n_heads=6.*n_kv_heads=3"):
        ServeEngine(get_config("tiny-lm-wide"), {}, cache_kind="dense",
                    mesh=tp2)
    with pytest.raises(ValueError, match="CPU ranks or CUDA ranks"):
        ServeMesh(1, 2, ["cpu", "cuda:0"])


def test_make_serve_mesh_names_its_devices():
    """A mesh never shares a card or falls to the CPU unless the caller
    names the devices; too few cards raise."""
    assert make_serve_mesh(2, 2, "cpu,cpu,cpu,cpu").backend == "gloo"
    assert make_serve_mesh(1, 2, ["cuda:0", "cuda:0"]).backend == "gloo"
    assert make_serve_mesh(1, 2, ["cuda:0", "cuda:1"]).backend == "nccl"
    if torch.cuda.device_count() < 64:
        with pytest.raises(ValueError, match="needs 64 devices"):
            make_serve_mesh(8, 8)
    with pytest.raises(ValueError, match="needs 4 devices, 2 named"):
        make_serve_mesh(2, 2, "cpu,cpu")


def test_a_failing_rank_fails_the_call():
    """A rank that raises fails the call with its traceback; the rank
    left waiting in a collective is stopped."""
    mesh = make_serve_mesh(2, 1, "cpu,cpu")
    with pytest.raises(RuntimeError,
                       match=r"rank 1 failed(.|\n)*rank 1 refuses"):
        spawn(fail_on_rank_1, mesh, threads=1, timeout_s=120)


def test_chip_smoke_mesh_phase_rehearses_on_cpu(monkeypatch):
    """chip_smoke's phase 12 end to end on the CPU at tiny size (tiny-lm
    on its three meshes, speculatively on (2, 1) and (1, 2), and
    FSDP-sharded on (2, 1), plainly and speculatively; tiny-moe on (1,
    2), the smoke configs of minicpm3-4b, falcon-mamba-7b and jamba on
    (1, 2); the smoke Qwen3-MoE at head_dim 32 on (1, 4), its pools
    replicated, fp and 4-bit; minicpm3-4b's smoke config through the
    dense engine on (1, 2)): every check but the kernel launches (none
    on the CPU) holds."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    monkeypatch.setitem(sys.modules, "chip_smoke", cs)
    monkeypatch.syspath_prepend(str(ROOT))
    monkeypatch.setattr(cs, "DEV", "cpu")
    unmet = []
    monkeypatch.setattr(cs, "require",
                        lambda ok, what: ok or unmet.append(what))
    lines = []
    monkeypatch.setattr(cs, "emit", lines.append)
    # tiny-lm's per-channel scales of its expand leaves, which stay
    # whole, weigh ~9 % of its 2 MB (llama2-7b's: ~0.3 %)
    monkeypatch.setattr(cs, "FSDP_MIN_CUT_SHARE", 0.9)
    zoo = [smoke_config(a).replace(dtype="float32")
           for a, _ in cs.MESH_ZOO]
    rep = (smoke_config("qwen3-moe-235b-a22b").replace(dtype="float32",
                                                       head_dim=32), (1, 4))
    counts = cs.phase_mesh(0, cs.synthetic_llama(0, "tiny-lm"), None,
                           max_new=4, moe_arch="tiny-moe", moe_layers=2,
                           zoo=zoo, rep=rep, dense=zoo[:1])
    assert counts["bcq_plain"] == 0
    paths = [ln for ln in lines if ln["check"] == "mesh_path"]
    assert [p["path"] for p in paths] == [
        "llama_1x2", "llama_2x1", "llama_2x2", "llama_spec_2x1",
        "llama_spec_1x2", "llama_fsdp_spec_2x1", "llama_fsdp_2x1",
        "moe_1x2", "minicpm3_1x2", "falcon_1x2", "jamba_1x2",
        "moe_rep_1x4", "moe_rep_kv4_1x4", "minicpm3_dense_1x2"]
    # the two-rank meshes side by side, the larger ones alone; the 4-bit
    # replicated pool's whole run held to the single device forced onto
    # rank 0's writes
    spawn_line = next(ln for ln in lines if ln["check"] == "mesh_path_spawn")
    assert [len(st) for st in spawn_line["stages"]] == [11, 1, 1, 1]
    forced = [ln for ln in lines if ln["check"] == "mesh_path_forced_pool"]
    assert len(forced) == 1 and forced[0]["final_pool_equal"]
    assert forced[0]["writes"] == forced[0]["writes_forced"] > 0
    assert forced[0]["max_dx_rel"] <= cs.TOL_LOGITS
    assert 0 < forced[0]["logit_rows_compared"]
    assert forced[0]["max_dlogit_rel"] <= cs.TOL_LOGITS
    for p in paths:
        fsdp = p["path"].startswith("llama_fsdp")
        assert all(r["fsdp"] == fsdp for r in p["ranks"])
        assert p["max_dlogit_rel_gated"] <= cs.TOL_LOGITS
        if fsdp:
            for r in p["ranks"]:
                one = r["single_device_weight_bytes"]
                cut = r["single_device_fsdp_cut_bytes"]
                assert 2 * r["param_bytes"] == 2 * one - cut
                assert r["replicated_weight_bytes"] == one
                g = r["fsdp_gathers"]
                assert g["layer_gather_ms"] > 0
                if p["speculation"] is None:
                    assert g["activation_side_ms"] > 0
                    assert g["tables_gathered_ms"] > 0
                    assert g["designs_max_dlogit_rel"] <= cs.TOL_LOGITS
    for p in paths:
        assert p["tokens_equal"] and p["max_dlogit_rel"] <= cs.TOL_LOGITS
        assert p["backend"] == "gloo"
        for r in p["ranks"]:
            assert r["drained"] and r["pages_in_own_block"]
            assert r["param_bytes"] > 0 and r["pool_bytes"] > 0
            assert r["logit_rows_compared"] > 0
        assert all((r["all_reduce_ms"] is not None)
                   == (p["mesh"]["model"] > 1) for r in p["ranks"])
        spec_path = "_spec" in p["path"]
        assert (p["speculation"] is not None) == spec_path
        if spec_path:
            assert p["speculation"]["draft_tokens"] > 0
    # no kernel launches on the CPU: the launch-count and shape checks
    assert unmet and all("launch" in u for u in unmet), [
        u for u in unmet if "launch" not in u]
