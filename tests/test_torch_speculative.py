"""Self-speculative decoding in the port (serve/engine.py:
_spec_decode_tick, models/model.py: draft_propose_paged and
verify_paged), the reference's tests/test_speculative.py on the port,
plus the port held against the reference.

The invariant everywhere: with greedy acceptance, speculative decode is
token-identical to the port's dense engine for ANY draft. The verify
pass overwrites every speculatively written K/V slot with the target's
own before reading it (models/attention.py scatters before it gathers,
causally masked), so a rejected draft leaves nothing behind that the
next tick can observe. Two draft regimes bracket the space:

  perfect      the draft IS the target: every proposal accepted,
               ticks shrink by ~(k+1)x, the rollback path never fires
  adversarial  differently seeded params: ~0 acceptance, every tick
               speculates k tokens and rolls them back (the page-
               boundary truncate path fires constantly)

Against the reference, on the committed fixture artifact w3_pc saved
with the reference's draft block (so both drafts hold the same scales):
its speculative engine's tokens, draft_tokens and accepted_tokens, its
EngineStats (but the compile-cache and slab fields, which the port
does not have, and the timings), and at the model level its
draft_propose_paged and verify_paged on one pool with a full, a
clamped (k_eff < k) and a dead (k_eff = 0) row: tokens equal, logits
within 1e-4 x max|logit|, pages within 1e-5 (page 0 aside: dead rows
write it, several into one slot at once, whatever is there being
garbage by design).

The reference's test_speculative_trace_amortization has no counterpart:
it counts jit traces, and the port runs eagerly, with nothing to trace.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.packed import load_draft_scales as jax_load_draft_scales
from repro.ckpt.packed import load_packed as jax_load_packed
from repro.ckpt.packed import save_packed as jax_save_packed
from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.models import model as jmodel
from repro.quant import draft as jdraft
from repro.serve import Request as JaxRequest
from repro.serve import compile_cache as jax_compile_cache
from repro.serve import ServeEngine as JaxServeEngine
from repro_torch.ckpt import load_draft_scales, load_packed, params_from_tree
from repro_torch.configs import get_config
from repro_torch.models import model as tmodel
from repro_torch.quant import (QuantizedTensor, draft_extra_bytes,
                               make_draft_params)
from repro_torch.serve import EngineStats, Request, ServeEngine, compile_cache
from test_torch_ckpt import FIXTURE, _flat_port
from test_torch_extend import _check_pools
from test_torch_model import close_logits, port_cfg
from test_torch_serve import check_drained
from torch_threads import one_torch_thread  # noqa: F401

KEY = jax.random.PRNGKey(0)
BATCH, MAX_LEN = 3, 48
REF = json.loads((FIXTURE / "reference.json").read_text())


def _jcfg():
    return jax_get_config("tiny-lm").replace(
        dtype="float32", n_layers=2, d_model=64, d_ff=128, remat="none")


_state = {}


def _setup():
    if _state:
        return _state
    jcfg = _jcfg()
    _state["cfg"] = port_cfg(jcfg)
    _state["params"] = params_from_tree(jax_init_params(jcfg, KEY),
                                        device="cpu")
    # adversarial draft: a differently seeded model proposes tokens the
    # target essentially never agrees with, so every tick rolls back
    _state["adversarial"] = params_from_tree(
        jax_init_params(jcfg, jax.random.PRNGKey(1)), device="cpu")
    _state["dense"] = ServeEngine(_state["cfg"], _state["params"],
                                  batch_size=BATCH, max_len=MAX_LEN,
                                  dtype="float32", device="cpu")
    _state["spec"] = {}
    return _state


def _spec_engine(k, draft, page_size=8):
    state = _setup()
    key = (k, draft, page_size)
    if key not in state["spec"]:
        dp = state["params"] if draft == "perfect" else state["adversarial"]
        state["spec"][key] = ServeEngine(
            state["cfg"], state["params"], batch_size=BATCH,
            max_len=MAX_LEN, dtype="float32", cache_kind="paged",
            page_size=page_size, speculate=k, draft_params=dp, device="cpu")
    return state["spec"][key]


def _reqs(n=3, seed=0, max_new=12):
    rng = np.random.default_rng(seed)
    cfg = _setup()["cfg"]
    return [(rng.integers(1, cfg.vocab_size,
                          int(rng.integers(4, 14))).astype(np.int32),
             max_new) for _ in range(n)]


def _serve(eng, reqs, request=Request):
    rs = [request(prompt=p.copy(), max_new_tokens=n) for p, n in reqs]
    eng.run(rs)
    return [list(map(int, r.out)) for r in rs]


def _check_pool(kv):
    assert kv.live_pages + kv.free_page_count == kv.usable_pages
    for s in range(kv.max_seqs):
        assert not kv.owned_pages(s)


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("draft", ["perfect", "adversarial"])
def test_speculative_matches_dense_oracle(k, draft):
    state = _setup()
    eng = _spec_engine(k, draft)
    reqs = _reqs(seed=10 * k)
    want = _serve(state["dense"], reqs)
    d0, a0 = eng.stats["draft_tokens"], eng.stats["accepted_tokens"]
    got = _serve(eng, reqs)
    assert got == want, (k, draft)
    _check_pool(eng.kv)
    drafted = eng.stats["draft_tokens"] - d0
    accepted = eng.stats["accepted_tokens"] - a0
    assert drafted > 0
    rate = accepted / drafted
    if draft == "perfect":
        assert rate == 1.0          # the draft IS the target
    else:
        assert rate < 0.5           # the rollback path exercised hard


def test_perfect_draft_cuts_ticks():
    """k=4 with a perfect draft finishes in far fewer target ticks than
    plain decode: every accepted tick emits k+1 tokens."""
    state = _setup()
    reqs = _reqs(n=2, seed=3, max_new=16)
    plain = ServeEngine(state["cfg"], state["params"], batch_size=BATCH,
                        max_len=MAX_LEN, dtype="float32", cache_kind="paged",
                        page_size=8, device="cpu")
    want = _serve(plain, reqs)
    eng = _spec_engine(4, "perfect")
    t0 = eng.stats["ticks"]
    assert _serve(eng, reqs) == want
    assert (eng.stats["ticks"] - t0) * 2 <= plain.stats["ticks"]


def test_page_boundary_rollbacks_stay_exact():
    """Tiny pages and a draft that is never accepted: every tick writes
    draft K/V across a page boundary, allocates the pages for it, then
    truncates them back. Outputs match the oracle and the pool
    balances."""
    state = _setup()
    eng = _spec_engine(4, "adversarial", page_size=4)
    reqs = [((np.arange(L) * 3 + L).astype(np.int32)
             % state["cfg"].vocab_size, 10) for L in (3, 4, 5, 8, 9)]
    want = _serve(state["dense"], reqs)
    alloc0 = eng.kv.pages_allocated
    assert _serve(eng, reqs) == want
    _check_pool(eng.kv)
    kept_pages = sum(eng.kv.pages_for(len(p) + n) for p, n in reqs)
    assert eng.kv.pages_allocated - alloc0 > kept_pages


def test_shared_prefix_with_speculation():
    """Attached shared pages fork copy-on-write before draft K/V lands
    in them, and rollbacks never truncate below the accepted position,
    so the radix index stays consistent across requests."""
    state = _setup()
    eng = _spec_engine(2, "adversarial")
    base = (np.arange(12) * 5 + 1).astype(np.int32) % state["cfg"].vocab_size
    reqs = [(np.concatenate([base, np.asarray([7 + i], np.int32)]), 8)
            for i in range(4)]
    want = _serve(state["dense"], reqs)
    eng._prefix.clear()
    h0 = eng.stats.get("prefix_hits", 0)
    assert _serve(eng, reqs) == want
    assert eng.stats["prefix_hits"] > h0
    _check_pool(eng.kv)


def test_typical_acceptance_perfect_draft_exact_lossy_otherwise():
    """accept_rule='typical': a perfect draft proposes the target's own
    argmax, which always clears the threshold, so it stays exact; an
    adversarial draft may keep sub-argmax tokens (allowed to diverge)
    but emits full-length outputs and keeps the pool balanced."""
    state = _setup()
    reqs = _reqs(n=2, seed=42, max_new=10)
    want = _serve(state["dense"], reqs)
    kw = dict(batch_size=BATCH, max_len=MAX_LEN, dtype="float32",
              cache_kind="paged", page_size=8, speculate=2,
              accept_rule="typical", device="cpu")
    exact = ServeEngine(state["cfg"], state["params"],
                        draft_params=state["params"], **kw)
    assert _serve(exact, reqs) == want
    assert exact.stats["accepted_tokens"] == exact.stats["draft_tokens"]
    lossy = ServeEngine(state["cfg"], state["params"],
                        draft_params=state["adversarial"], **kw)
    outs = _serve(lossy, reqs)
    assert [len(o) for o in outs] == [n for _, n in reqs]
    _check_pool(lossy.kv)


def _fixture_model(name):
    params, _, meta = load_packed(FIXTURE / name, device="cpu")
    cfg = get_config(meta["arch"]).replace(dtype="float32",
                                           n_layers=len(params["layers"]))
    return cfg, params


def _qt_leaves(tree):
    return [v for v in _flat_port(tree).values()
            if isinstance(v, QuantizedTensor)]


def test_quantized_self_draft_is_free_and_exact():
    """The trained fixture artifact serves as its own draft (leading
    code planes + re-fit scales): token-identical to the plain paged
    engine, and the draft tree adds exactly its scale bytes."""
    cfg, params = _fixture_model("w3_pc")
    art = REF["artifacts"]["w3_pc"]
    kw = dict(batch_size=BATCH, max_len=64, dtype="float32",
              cache_kind="paged", page_size=8, device="cpu")
    reqs = [(np.asarray(p, np.int32), REF["max_new"]) for p in art["prompts"]]
    want = _serve(ServeEngine(cfg, params, **kw), reqs)
    assert want == art["tokens"]
    eng = ServeEngine(cfg, params, speculate=2, draft_bits=2, **kw)
    assert _serve(eng, reqs) == want
    check_drained(eng.kv)
    extra = draft_extra_bytes(eng.params, eng.draft_params)
    leaves = _qt_leaves(eng.draft_params)
    assert extra == sum(t.numel() * t.element_size()
                        for q in leaves for t in (q.alphas, q.betas))
    assert leaves and all(q.bits == 2 and q.stored_bits == 3 for q in leaves)
    assert eng.draft_build_s > 0


def test_engine_stats_speculation_fields():
    """stats_snapshot() fills the speculation counters and the derived
    acceptance rate; a non-speculative engine reports zeros."""
    state = _setup()
    eng = _spec_engine(2, "perfect")
    _serve(eng, _reqs(n=2, seed=9, max_new=6))
    st = eng.stats_snapshot()
    assert isinstance(st, EngineStats)
    assert st.speculate_k == 2 and st.draft_bits == 2
    assert st.draft_tokens > 0
    assert st.accepted_tokens == eng.stats["accepted_tokens"]
    assert st.acceptance_rate == st.accepted_tokens / st.draft_tokens
    assert st.as_dict()["decode_tok_s"] == st.decode_tok_s > 0
    plain = state["dense"].stats_snapshot()
    assert plain.speculate_k == 0 and plain.draft_tokens == 0
    assert plain.acceptance_rate == 0.0 and plain.kv_pool_bytes == 0


def test_speculation_refusals():
    state = _setup()
    cfg, p = state["cfg"], state["params"]
    with pytest.raises(ValueError, match="cache_kind='paged'"):
        ServeEngine(cfg, p, speculate=2, device="cpu")
    with pytest.raises(ValueError, match="accept_rule"):
        ServeEngine(cfg, p, cache_kind="paged", speculate=2,
                    draft_params=p, accept_rule="nucleus", device="cpu")
    with pytest.raises(ValueError, match="GPTQT-quantized"):
        ServeEngine(cfg, p, cache_kind="paged", speculate=2, device="cpu")


def test_moe_self_draft_equals_plain_engine():
    cfg, params = _fixture_model("w3_moe")
    prompts = REF["artifacts"]["w3_moe"]["prompts"]
    reqs = [(np.asarray(p, np.int32), REF["max_new"]) for p in prompts]
    kw = dict(batch_size=BATCH, max_len=64, dtype="float32",
              cache_kind="paged", page_size=8, device="cpu")
    want = _serve(ServeEngine(cfg, params, **kw), reqs)
    eng = ServeEngine(cfg, params, speculate=2, draft_bits=2, **kw)
    assert _serve(eng, reqs) == want
    assert eng.stats["draft_tokens"] > 0
    check_drained(eng.kv)


def test_kv_bits_speculation_finishes_and_drains():
    """4-bit KV pages under speculation: rollbacks truncate binary-coded
    pages too. Only full lengths and drained pages are held: tokens are
    not, as quantize-on-write near-ties make 4-bit runs chaotic."""
    cfg, params = _fixture_model("w3_pc")
    prompts = REF["artifacts"]["w3_pc"]["prompts"]
    eng = ServeEngine(cfg, params, batch_size=BATCH, max_len=64,
                      dtype="float32", cache_kind="paged", page_size=8,
                      kv_bits=4, speculate=2, device="cpu")
    outs = _serve(eng, [(np.asarray(p, np.int32), 6) for p in prompts])
    assert [len(o) for o in outs] == [6] * len(prompts)
    assert eng.stats["draft_tokens"] > 0
    check_drained(eng.kv)


# ---------------------------------------------------------------------------
# against the reference, on the fixture artifact with its draft block
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """w3_pc saved by the reference with a w2 draft block; both packages'
    params and draft trees from it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        jp, spec, meta = jax_load_packed(FIXTURE / "w3_pc")
        d = jax_save_packed(tmp_path_factory.mktemp("spec") / "w3_pc", jp,
                            spec=spec, meta=meta, draft_bits=2)
        jp, _, _ = jax_load_packed(d)
        jdp = jdraft.make_draft_params(jp, 2, jax_load_draft_scales(d))
        params, _, _ = load_packed(d, device="cpu")
        dp = make_draft_params(params, 2, load_draft_scales(d, device="cpu"))
        yield {"dir": d, "jp": jp, "jdp": jdp, "params": params, "dp": dp,
               "jcfg": jax_get_config("tiny-lm").replace(
                   dtype="float32", n_layers=2, remat="none")}
    finally:
        torch.set_num_threads(threads)


# fields the port's EngineStats reads as 0 by construction, and timings
NOT_COMPARED = {"slab_usable_slabs", "slab_high_water", "slabs_allocated",
                "slab_bytes_per_slab", "prefill_s", "decode_s", "ttft_avg_s",
                "tpot_avg_s", "ttft_samples_s", "tpot_samples_s"}


def test_speculative_engine_matches_reference(artifact):
    """Tokens, draft and accepted counts, and every EngineStats counter
    the port has, equal the reference's speculative engine's (k=2,
    prefix sharing on, the fixture's prompts twice, so the second wave
    hits the index)."""
    jcfg = artifact["jcfg"]
    cfg = port_cfg(jcfg)
    prompts = [np.asarray(p, np.int32)
               for p in REF["artifacts"]["w3_pc"]["prompts"]]
    reqs = [(p, REF["max_new"]) for p in prompts]
    kw = dict(batch_size=BATCH, max_len=64, dtype="float32",
              cache_kind="paged", page_size=8, speculate=2)
    # both process-wide step caches from empty, so their counters (the
    # compile_cache_* fields) count these two engines alone
    jax_compile_cache.clear()
    compile_cache.clear()
    jeng = JaxServeEngine(jcfg, artifact["jp"],
                          draft_params=artifact["jdp"], **kw)
    teng = ServeEngine(cfg, artifact["params"], draft_params=artifact["dp"],
                       device="cpu", **kw)
    for wave in (reqs, reqs[::-1]):
        want = _serve(jeng, wave, JaxRequest)
        assert _serve(teng, wave) == want
    for key in ("draft_tokens", "accepted_tokens", "ticks", "tokens"):
        assert teng.stats[key] == jeng.stats[key], key
    assert 0 < teng.stats["accepted_tokens"] < teng.stats["draft_tokens"]
    want = jeng.stats_snapshot().as_dict()
    got = teng.stats_snapshot().as_dict()
    assert got.keys() == want.keys()
    assert got["prefix_hits"] > 0
    for key in sorted(set(want) - NOT_COMPARED - {"decode_tok_s",
                                                  "us_per_token"}):
        assert got[key] == want[key], key


def test_typical_engine_matches_reference(artifact):
    """accept_rule='typical' (tau 0.3): tokens and draft and accepted
    counts equal the reference's typical engine's on the same draft
    block and prompts (k=2, no prefix index)."""
    jcfg = artifact["jcfg"]
    reqs = [(np.asarray(p, np.int32), REF["max_new"])
            for p in REF["artifacts"]["w3_pc"]["prompts"]]
    kw = dict(batch_size=BATCH, max_len=64, dtype="float32",
              cache_kind="paged", page_size=8, speculate=2,
              accept_rule="typical", prefix_sharing=False)
    jeng = JaxServeEngine(jcfg, artifact["jp"],
                          draft_params=artifact["jdp"], **kw)
    teng = ServeEngine(port_cfg(jcfg), artifact["params"],
                       draft_params=artifact["dp"], device="cpu", **kw)
    assert _serve(teng, reqs) == _serve(jeng, reqs, JaxRequest)
    for key in ("draft_tokens", "accepted_tokens", "ticks", "tokens"):
        assert teng.stats[key] == jeng.stats[key], key
    assert teng.stats["draft_tokens"] > 0


def test_propose_and_verify_match_reference(artifact):
    """draft_propose_paged then verify_paged on one pool in both
    packages: a row proposing k tokens across a page boundary, one
    clamped to 1 and a dead one (k_eff 0, null page). Draft tokens equal
    where a row is live, the verify logits within 1e-4 x max|logit| at
    its valid positions, and every page but the null page within 1e-5
    after each call. Besides, in the port, the clamped row's slots past
    its valid positions and the dead row's pages keep their bytes."""
    jcfg = artifact["jcfg"]
    cfg = port_cfg(jcfg)
    page, n_pages, k = 4, 13, 3
    rng = np.random.default_rng(17)
    jpool = jmodel.init_paged_cache(jcfg, n_pages, page, 3, "float32")
    for name in ("k_pages", "v_pages"):
        jpool["L0"][name] = jnp.asarray(
            rng.standard_normal(jpool["L0"][name].shape).astype(np.float32))
    tpool = [{name: torch.from_numpy(np.array(jpool["L0"][name][g]))
              for name in ("k_pages", "v_pages")} for g in range(2)]
    # the clamped row (base 7, k_eff 1) writes positions 7 and 8 (page 4
    # slot 3, page 6 slot 0): page 6's slots 1-3 stay; the dead row's
    # pages 7-9 stay whole
    kept = [(layer, n, layer[n][6, 1:].clone(), layer[n][7:10].clone())
            for layer in tpool for n in ("k_pages", "v_pages")]
    bt = np.array([[3, 1, 5], [2, 4, 6], [7, 8, 9]], np.int32)
    cur = rng.integers(0, cfg.vocab_size, 3).astype(np.int32)
    base = np.array([5, 7, 2], np.int32)
    k_eff = np.array([k, 1, 0], np.int32)
    null = np.zeros(3, np.int32)
    live = k_eff > 0

    jtoks, jpool = jax.jit(
        lambda p, c, *a: jmodel.draft_propose_paged(jcfg, p, c, *a, k))(
        artifact["jdp"], jpool, *(jnp.asarray(a) for a in
                                  (cur, base, bt, k_eff, null)))
    ttoks, tpool = tmodel.draft_propose_paged(
        cfg, artifact["dp"], tpool, *(torch.from_numpy(a) for a in
                                      (cur, base, bt, k_eff, null)), k)
    assert tuple(ttoks.shape) == (3, k) and ttoks.dtype == torch.int32
    step = np.arange(k)[None] < k_eff[:, None]
    np.testing.assert_array_equal(ttoks.numpy()[step],
                                  np.asarray(jtoks)[step])
    _check_pools([{n: t[1:] for n, t in layer.items()} for layer in tpool],
                 {"L0": {n: v[:, 1:] for n, v in jpool["L0"].items()}}, 0)

    tokens = np.concatenate([cur[:, None], ttoks.numpy()], axis=1)
    args = (tokens, np.where(live, base, 0),
            np.where(live[:, None], bt, null[:, None]),
            np.where(live, k_eff + 1, 0).astype(np.int32))
    jlog, jpool = jax.jit(
        lambda p, c, *a: jmodel.verify_paged(jcfg, p, c, *a))(
        artifact["jp"], jpool, *(jnp.asarray(a) for a in args))
    tlog, tpool = tmodel.verify_paged(cfg, artifact["params"], tpool,
                                      *(torch.from_numpy(a) for a in args))
    assert tuple(tlog.shape) == (3, k + 1, cfg.vocab_size)
    valid = np.arange(k + 1)[None] < args[3][:, None]
    close_logits(tlog[torch.from_numpy(valid)], np.asarray(jlog)[valid])
    _check_pools([{n: t[1:] for n, t in layer.items()} for layer in tpool],
                 {"L0": {n: v[:, 1:] for n, v in jpool["L0"].items()}}, 0)
    for layer, n, tail, dead in kept:
        assert torch.equal(layer[n][6, 1:], tail), n
        assert torch.equal(layer[n][7:10], dead), n


# ---------------------------------------------------------------------------
# chip_smoke.py phase 8, its control flow rehearsed on the CPU
# ---------------------------------------------------------------------------

def test_chip_smoke_speculative_phase_rehearses_on_cpu(monkeypatch):
    """Phase 8 end to end with the plain versions on the CPU at tiny size
    (tiny-lm cut to 2 layers, 8 new tokens a request, profiles over one
    call): every check holds but the launch counts (no kernel launches
    off the card)."""
    from test_torch_serve import _chip_smoke
    cs = _chip_smoke(monkeypatch)
    unmet, rows = [], []
    monkeypatch.setattr(cs, "require",
                        lambda ok, what: ok or unmet.append(what))
    monkeypatch.setattr(cs, "emit", rows.append)
    cfg, params = cs.synthetic_llama(0, "tiny-lm")
    model = (cfg.replace(n_layers=2),
             {**params, "layers": params["layers"][:2]})
    counts, by_engine = cs.phase_speculative(0, model, max_new=8,
                                             profile_steps=1)
    # bcq_gemv and paged_attention in A, B and C, bcq_matmul in A and C
    assert all("launch" in u for u in unmet) and len(unmet) == 8, unmet
    assert sorted(by_engine) == ["A", "B", "C"]
    assert by_engine["C"]["acceptance_rate"] == 1.0
    assert by_engine["C"]["decode_ticks"] == by_engine["C"]["ideal_ticks"]
    assert by_engine["B"]["speculate"] == 1
    for tag, row in by_engine.items():
        assert row["decode_tokens"] == 4 * 7 and row["draft_tokens"] > 0
        assert row["draft_codes_share_target_storage"]
        assert row["draft_extra_bytes"] == row["draft_scale_bytes"]
    assert by_engine["C"]["draft_scale_bytes"] == 0
    assert by_engine["A"]["draft_scale_bytes"] > 0
    tokens = [r for r in rows if r["check"] == "speculative_path_tokens"]
    assert len(tokens) == 12 and all(r["equal_to_plain"] for r in tokens)
    prof, = [r for r in rows if r["check"] == "speculative_profile"]
    assert set(prof) >= {"propose", "verify", "tick_wall_ms", "decode_step"}
    assert [r["check"] for r in rows].count("speculative_propose_sync") == 1
