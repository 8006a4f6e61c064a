"""The serving steps' CUDA graphs (repro_torch/serve/compile_cache.py)
against the eager steps they capture, on the card. Every test here needs
a CUDA device: it skips with that reason without one (graphs exist on
CUDA only) and fails instead under REQUIRE_CUDA=1. The file imports no
JAX, so it runs where the card is:

    REQUIRE_CUDA=1 PYTHONPATH=src python -m pytest --noconftest -m cuda \\
        tests/test_torch_graphs_cuda.py

(--noconftest because tests/conftest.py configures JAX.)

Two identical prefilled pools on the committed fixture artifacts (tiny-lm
w3 with fp and 4-bit KV pages, tiny-moe w3, and the zoo's quantized
minicpm3 (MLA) and jamba (Mamba, MoE and attention) smoke artifacts,
falcon-mamba's fp one),
with one dead row routed to the null page: one advanced by the eager
step functions, the other by the borrowed wrappers, whose first call
warms up and captures and later calls replay. Tolerance: the replay runs
the eager step's kernels in the same order on the same inputs, so its
logits must be within 1e-6 x max|logit| (expected equal) and the pools,
Mamba state rows included, byte-equal after every step (the warm-up
must not step a sequence twice); the launch counts of each step must
equal the eager step's.
"""
import gc
import json
import os
import weakref
from pathlib import Path

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

FIXTURE = Path(__file__).resolve().parent / "data" / "torch_port"
ZOO = FIXTURE / "zoo"
TOL = 1e-6


@pytest.fixture
def cuda():
    """The CUDA device, or a skip (a failure under REQUIRE_CUDA=1)."""
    if torch.cuda.is_available():
        torch.backends.cuda.matmul.allow_tf32 = False
        return torch.device("cuda")
    if os.environ.get("REQUIRE_CUDA") == "1":
        pytest.fail("REQUIRE_CUDA=1 but no CUDA device is available")
    pytest.skip("needs a CUDA device: CUDA graphs exist on CUDA only")


def _model(name, dev):
    """(cfg, params on dev) of a fixture or zoo artifact."""
    import dataclasses
    from repro_torch.ckpt import load_packed
    from repro_torch.configs import get_config, smoke_config
    if name.startswith("zoo/"):
        ent = json.loads((ZOO / "zoo.json").read_text())["artifacts"][
            name[4:]]
        cfg = smoke_config(ent["arch"]).replace(dtype="float32")
        cfg = cfg.replace(quant=dataclasses.replace(cfg.quant,
                                                    bits=ent["bits"]))
        params, _, _ = load_packed(FIXTURE / name, device=dev)
        return cfg, params
    params, _, meta = load_packed(FIXTURE / name, device=dev)
    return get_config(meta["arch"]).replace(
        dtype="float32", n_layers=len(params["layers"])), params


def _prompts(cfg, n=2, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, L).astype(np.int32)
            for L in (11, 19)[:n]]


def _paged(cfg, params, prompts, dev, kv_bits=0, page=8, pps=4):
    """A page pool with each prompt prefilled into pages of its own and
    one more row that holds nothing: (pool, block tables, positions,
    live mask), the last three as (B,...) int32 host arrays."""
    from repro_torch.models import (init_paged_cache, prefill,
                                    scatter_prefill_cache)
    B = len(prompts) + 1
    pool = init_paged_cache(cfg, B * pps + 1, page, B, kv_bits=kv_bits,
                            device=dev)
    bt = np.zeros((B, pps), np.int32)
    for b, p in enumerate(prompts):
        ids = list(range(1 + b * pps, 1 + (b + 1) * pps))
        bt[b] = ids
        _, row = prefill(cfg, params, torch.tensor(p[None], device=dev),
                         len(p))
        scatter_prefill_cache(cfg, pool, row, b, ids[:-(-len(p) // page)],
                              len(p))
    pos = np.array([len(p) for p in prompts] + [0], np.int32)
    live = np.array([1] * len(prompts) + [0], np.int32)
    return pool, bt, pos, live


def _dense(cfg, params, prompts, dev, max_len=48):
    from repro_torch.models import init_cache, prefill
    B = len(prompts) + 1
    cache = init_cache(cfg, B, max_len, "float32", device=dev)
    for b, p in enumerate(prompts):
        _, row = prefill(cfg, params, torch.tensor(p[None], device=dev),
                         max_len)
        for layer, one in zip(cache, row):
            for name, leaf in layer.items():
                leaf[b] = one[name][0].to(leaf.dtype)
    pos = np.array([len(p) for p in prompts] + [0], np.int32)
    return cache, pos


def _clone(pool):
    return [{k: v.clone() for k, v in layer.items()} for layer in pool]


def _assert_pools_equal(a, b):
    for i, (la, lb) in enumerate(zip(a, b)):
        for k in la:
            assert torch.equal(la[k], lb[k]), (i, k)


def _counted(fn):
    from repro_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, launch_counts()


def _close(got, want):
    err = float((got.float() - want.float()).abs().max())
    assert err <= TOL * float(want.float().abs().max()), err


# Mamba paged on falcon-mamba's smoke artifact (fp weights) and on the
# jamba smoke's hybrid, whose attention layer runs the fp kernel at
# head_dim 16
CASES = [("w3_pc", 0, "paged"), ("w3_pc", 4, "paged"), ("w3_pc", 0, "dense"),
         ("w3_moe", 0, "paged"), ("zoo/mla_quant", 0, "paged"),
         ("zoo/mamba_fp", 0, "paged"), ("zoo/mamba-mix_quant", 0, "paged")]


@pytest.mark.parametrize("name,kv_bits,kind", CASES)
def test_decode_graph_replays_the_eager_step(cuda, name, kv_bits, kind):
    from repro_torch.models import decode_step, decode_step_paged
    from repro_torch.serve import compile_cache
    cfg, params = _model(name, cuda)
    prompts = _prompts(cfg)
    rng = np.random.default_rng(1)
    compile_cache.clear()
    if kind == "paged":
        eager, bt, pos, live = _paged(cfg, params, prompts, cuda, kv_bits)
        null = torch.zeros(len(pos), dtype=torch.int32, device=cuda)
        bt_dev = torch.tensor(bt, device=cuda)
        bt_live = torch.tensor(np.where(live[:, None] > 0, bt, 0),
                               device=cuda)
        step = compile_cache.get("decode_paged", cfg)
    else:
        eager, pos = _dense(cfg, params, prompts, cuda)
        step = compile_cache.get("decode_dense", cfg)
    graphed = _clone(eager)
    for i in range(3):
        toks = rng.integers(0, cfg.vocab_size, (len(pos), 1)).astype(np.int32)
        p_i = pos + i
        t_dev, p_dev = torch.tensor(toks, device=cuda), torch.tensor(
            p_i, device=cuda)
        if kind == "paged":
            (want, _), n_eager = _counted(lambda: decode_step_paged(
                cfg, params, eager, t_dev, p_dev, bt_live))
            (got, _), n_graph = _counted(lambda: step(
                params, graphed, toks, p_i, bt_dev, live, null))
        else:
            (want, _), n_eager = _counted(lambda: decode_step(
                cfg, params, eager, t_dev, p_dev))
            (got, _), n_graph = _counted(lambda: step(params, graphed, toks,
                                                      p_i))
        assert n_graph == n_eager, (i, n_graph, n_eager)
        _close(got, want)
        _assert_pools_equal(graphed, eager)
    assert compile_cache.graph_stats()["captured"] == 1
    assert compile_cache.graph_stats()["replays"] == 3
    if kind == "paged" and cfg.mla is None \
            and any(s.kind == "attn" for s in cfg.pattern):
        kernel = "paged_attention_quant" if kv_bits else "paged_attention"
        assert n_graph[kernel] > 0
    assert n_graph["bcq_plain"] == 0
    if not name.endswith("_fp"):
        assert n_graph["bcq_gemv"] > 0


@pytest.mark.parametrize("k", [1, 4])
def test_speculative_graphs_replay_the_eager_tick(cuda, k):
    """draft_propose (one graph a depth k) and verify_paged through their
    wrappers against the eager functions, two ticks from one pool with a
    row clamped to one draft token."""
    from repro_torch.models import draft_propose_paged, verify_paged
    from repro_torch.quant import make_draft_params
    from repro_torch.serve import compile_cache
    cfg, params = _model("w3_pc", cuda)
    draft = make_draft_params(params, 2)
    eager, bt, pos, live = _paged(cfg, params, _prompts(cfg), cuda)
    graphed = _clone(eager)
    compile_cache.clear()
    propose = compile_cache.get("draft_propose", cfg)
    verify = compile_cache.get("verify_paged", cfg)
    null = torch.zeros(len(pos), dtype=torch.int32, device=cuda)
    bt_dev = torch.tensor(bt, device=cuda)
    bt_live = torch.tensor(np.where(live[:, None] > 0, bt, 0), device=cuda)
    ints = lambda a: torch.tensor(np.asarray(a, np.int32), device=cuda)
    cur = np.array([3, 7, 0], np.int32)
    for tick in range(2):
        ke = np.where(live > 0, k, 0).astype(np.int32)
        ke[1] = min(k, 1)
        sp = np.where(live > 0, pos, 0).astype(np.int32)
        nv = np.where(live > 0, ke + 1, 0).astype(np.int32)
        (d_e, _), n_e1 = _counted(lambda: draft_propose_paged(
            cfg, draft, eager, ints(cur), ints(pos), bt_dev, ints(ke), null,
            k))
        (d_g, _), n_g1 = _counted(lambda: propose(
            draft, graphed, cur, pos, bt_dev, ke, null, k))
        assert n_g1 == n_e1
        assert torch.equal(d_g, d_e)
        _assert_pools_equal(graphed, eager)
        t_e = torch.cat([ints(cur)[:, None], d_e], dim=1)
        t_g = torch.cat([ints(cur)[:, None], d_g], dim=1)
        (l_e, _), n_e2 = _counted(lambda: verify_paged(
            cfg, params, eager, t_e, ints(sp), bt_live, ints(nv)))
        (l_g, _), n_g2 = _counted(lambda: verify(
            params, graphed, t_g, sp, bt_dev, nv, live, null))
        assert n_g2 == n_e2
        _close(l_g, l_e)
        _assert_pools_equal(graphed, eager)
        cur = torch.argmax(l_e[:, 0], dim=-1).to(torch.int32).cpu().numpy()
        pos = pos + live
    gs = compile_cache.graph_stats()
    assert gs["captured"] == 2 and gs["replays"] == 4 and gs["live"] == 2
    assert n_g1["bcq_gemv"] > 0 and n_g1["paged_attention"] > 0
    if k > 1:
        assert n_g2["bcq_matmul"] > 0       # verify at 3 x (k+1) rows


@pytest.mark.parametrize("kv_bits", [0, 4])
def test_decode_steps_copy_nothing_to_the_host(cuda, kv_bits):
    """One eager decode_step_paged and one replay of its graph run under
    set_sync_debug_mode("error"): no device-to-host copy, no sync (the
    4-bit pool's quantize-on-write included)."""
    from repro_torch.models import decode_step_paged
    from repro_torch.serve import compile_cache
    cfg, params = _model("w3_pc", cuda)
    pool, bt, pos, live = _paged(cfg, params, _prompts(cfg), cuda, kv_bits)
    null = torch.zeros(len(pos), dtype=torch.int32, device=cuda)
    bt_dev = torch.tensor(bt, device=cuda)
    toks = np.zeros((len(pos), 1), np.int32)
    t_dev, p_dev = torch.tensor(toks, device=cuda), torch.tensor(pos,
                                                                 device=cuda)
    step = compile_cache.get("decode_paged", cfg)
    decode_step_paged(cfg, params, pool, t_dev, p_dev, bt_dev)
    step(params, pool, toks, pos, bt_dev, live, null)      # capture
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        decode_step_paged(cfg, params, pool, t_dev, p_dev, bt_dev)
        step(params, pool, toks, pos, bt_dev, live, null)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.parametrize("k", [0, 1, 4])
def test_engine_on_graphs_gives_the_fixture_tokens(cuda, k):
    """The paged engine on the card (graphs for decode, propose and
    verify) gives the tokens the reference recorded, plainly and
    speculatively (greedy speculation is token-identical)."""
    from repro_torch.serve import Request, ServeEngine, compile_cache
    ref = json.loads((FIXTURE / "reference.json").read_text())
    art = ref["artifacts"]["w3_pc"]
    cfg, params = _model("w3_pc", cuda)
    eng = ServeEngine(cfg, params, batch_size=2, max_len=64,
                      dtype="float32", cache_kind="paged", page_size=16,
                      prefix_sharing=False, speculate=k)
    reqs = [Request(prompt=np.asarray(p, np.int32),
                    max_new_tokens=ref["max_new"]) for p in art["prompts"]]
    before = compile_cache.graph_stats()["replays"]
    eng.run(reqs)
    assert [r.out for r in reqs] == art["tokens"]
    assert compile_cache.graph_stats()["replays"] - before \
        == eng.stats["ticks"] * (2 if k else 1)


def test_dropped_engine_frees_its_pool_and_graphs(cuda):
    """The cache holds neither params nor pool: dropping the engine frees
    its pool and its graphs, and clear() leaves no graph."""
    from repro_torch.serve import Request, ServeEngine, compile_cache
    cfg, params = _model("w3_pc", cuda)
    compile_cache.clear()
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    eng = ServeEngine(cfg, params, batch_size=2, max_len=64,
                      dtype="float32", cache_kind="paged", page_size=16,
                      prefix_sharing=False, n_pages=1 << 15)
    pool_bytes = eng.kv.pool_bytes()
    assert pool_bytes >= 256 << 20
    eng.run([Request(prompt=np.arange(9, dtype=np.int32), max_new_tokens=4)])
    assert compile_cache.graph_stats()["live"] == 1
    leaf = weakref.ref(eng.cache[0]["k_pages"])
    del eng
    gc.collect()
    assert leaf() is None
    assert compile_cache.graph_stats()["live"] == 0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    assert torch.cuda.memory_allocated() - base < 64 << 20
    eng = ServeEngine(cfg, params, batch_size=2, max_len=64,
                      dtype="float32", cache_kind="paged", page_size=16,
                      prefix_sharing=False)
    eng.run([Request(prompt=np.arange(9, dtype=np.int32), max_new_tokens=4)])
    assert compile_cache.graph_stats()["live"] == 1
    compile_cache.clear()
    assert compile_cache.graph_stats()["live"] == 0



def test_capture_holds_off_collecting_a_dead_engine(cuda, monkeypatch):
    """An engine dropped in a reference cycle keeps its graphs until the
    cyclic collector runs, which it may do from any allocation, the
    next engine's capture included; destroying a graph mid-capture
    invalidates that capture. The capture holds the collector off: the
    engine becomes garbage during the next engine's capture, the
    collection that an allocation would then trigger does not run (it
    runs only where collection is enabled), the capture succeeds, and
    the dead engine goes at the next collection."""
    from repro_torch.serve import Request, ServeEngine, compile_cache
    cfg, params = _model("w3_pc", cuda)

    def run():
        eng = ServeEngine(cfg, params, batch_size=2, max_len=64,
                          dtype="float32", cache_kind="paged",
                          page_size=16, prefix_sharing=False)
        reqs = [Request(prompt=np.arange(9, dtype=np.int32),
                        max_new_tokens=4)]
        eng.run(reqs)
        return eng, reqs[0].out

    compile_cache.clear()
    dead, want = run()
    dead.cycle = dead
    held = [dead]                   # the one reference outside the cycle
    leaf = weakref.ref(dead.cache[0]["k_pages"])
    step = dead._decode
    del dead
    fn, collected = step._fn, []

    def collecting(*args):
        if torch.cuda.is_current_stream_capturing():
            held.clear()
            if gc.isenabled():
                collected.append(gc.collect())
        return fn(*args)
    monkeypatch.setattr(step, "_fn", collecting)
    before = compile_cache.graph_stats()["captured"]
    _, out = run()
    assert compile_cache.graph_stats()["captured"] == before + 1
    assert collected == [] and out == want
    assert leaf() is not None and gc.isenabled()
    gc.collect()
    assert leaf() is None
