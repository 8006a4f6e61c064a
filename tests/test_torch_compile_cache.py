"""The port's process-wide step cache (repro_torch/serve/compile_cache.py)
against the reference's (src/repro/serve/compile_cache.py), on the CPU,
where every kind runs eagerly (the CUDA graphs are held to the eager
steps on the card by tests/test_torch_graphs_cuda.py):

- wrappers are keyed by (kind, config, mesh) and borrowed: a second
  identical engine takes the same wrapper objects, adds no entry, runs no
  new shape signature (`_cache_size()` flat) and gives the first engine's
  tokens (the reference's tests/test_sharded_serve.py:205-240);
- accounting: after `clear()` in both packages, the same dense, paged and
  speculative engines and one perplexity leave equal `stats()` dicts;
- the MoE layer's per-expert counts, now made without `torch.bincount`
  (whose host read of the maximum a CUDA graph cannot hold), equal
  bincount's exactly, with capacity overflow.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.ckpt.packed import load_packed as jax_load_packed
from repro.configs import get_config as jax_get_config
from repro.data import corpus as jcorpus
from repro.data.evaluate import perplexity as jax_perplexity
from repro.serve import Request as JaxRequest
from repro.serve import ServeEngine as JaxServeEngine
from repro.serve import compile_cache as jax_cc
from repro_torch.ckpt import load_packed
from repro_torch.configs import get_config
from repro_torch.data import eval_batches, token_stream
from repro_torch.data.evaluate import perplexity
from repro_torch.models.moe import capacity, expert_counts
from repro_torch.serve import Request, ServeEngine, compile_cache
from test_torch_serve import FIXTURE, _tiny
from torch_threads import one_torch_thread  # noqa: F401


def test_compile_cache_keys_by_config_and_mesh():
    cfg_a = _tiny()["cfg"]
    cfg_b = cfg_a.replace(d_ff=256)
    fa = compile_cache.get("decode_paged", cfg_a)
    assert compile_cache.get("decode_paged", cfg_a) is fa
    assert compile_cache.get("decode_paged", cfg_b) is not fa
    assert compile_cache.get("extend_paged", cfg_a) is not fa
    assert compile_cache.mesh_fingerprint(None) is None
    # a mesh keys wrappers of its own (the same mesh, the same wrapper);
    # a model axis runs them eagerly (no graph holds the model group's
    # collectives), a data-only mesh graphs them as one device does
    from repro_torch.launch.mesh import make_serve_mesh
    mesh = make_serve_mesh(1, 2, "cpu,cpu")
    fm = compile_cache.get("decode_paged", cfg_a, mesh=mesh)
    assert fm is not fa and not fm._graphed and fa._graphed
    assert compile_cache.get("decode_paged", cfg_a,
                             mesh=make_serve_mesh(1, 2, "cpu,cpu")) is fm
    fd = compile_cache.get("decode_paged", cfg_a,
                           mesh=make_serve_mesh(2, 1, "cpu,cpu"))
    assert fd is not fa and fd is not fm and fd._graphed
    assert compile_cache.mesh_fingerprint(mesh) == (
        ("data", "model"), (1, 2), ("cpu", "cpu"))
    with pytest.raises(KeyError):
        compile_cache.get("no_such_kind", cfg_a)


def test_engines_share_compiled_steps():
    """Two engines with the same config borrow the same wrappers; the
    second one's construction adds no entry and its run no shape
    signature, and its tokens equal the first's."""
    m = _tiny()
    cfg, p = m["cfg"], m["p"]
    mk = lambda: [Request(prompt=(np.arange(12) * 3 + i).astype(np.int32)
                          % cfg.vocab_size, max_new_tokens=6)
                  for i in range(3)]
    kw = dict(batch_size=2, max_len=64, dtype="float32",
              cache_kind="paged", page_size=8, device="cpu")
    eng1 = ServeEngine(cfg, p, **kw)
    r1 = mk()
    eng1.run(r1)
    entries = compile_cache.stats()["entries"]
    names = ("_decode", "_prefill", "_extend", "_copy", "_scatter",
             "_bt_update")
    sizes = {n: getattr(eng1, n)._cache_size() for n in names}
    assert sizes["_decode"] >= 1 and sizes["_prefill"] >= 1
    eng2 = ServeEngine(cfg, p, **kw)
    assert compile_cache.stats()["entries"] == entries
    for n in names:
        assert getattr(eng2, n) is getattr(eng1, n)
    r2 = mk()
    eng2.run(r2)
    assert [r.out for r in r2] == [r.out for r in r1]
    for n, before in sizes.items():
        assert getattr(eng2, n)._cache_size() == before, \
            f"{n} ran a new shape signature for an identical engine"
    # the reference's engine gives the same tokens
    jeng = JaxServeEngine(m["jcfg"], m["jp"], batch_size=2, max_len=64,
                          dtype="float32", cache_kind="paged", page_size=8)
    jr = [JaxRequest(prompt=r.prompt, max_new_tokens=6) for r in mk()]
    jeng.run(jr)
    assert [r.out for r in jr] == [r.out for r in r1]


def test_accounting_matches_reference():
    """clear() in both packages, then the same dense, paged and
    speculative engines (on the fixture's tiny-lm w3) and one perplexity
    of each package: equal stats() after every step, and the EngineStats
    fields hold them."""
    params, _, meta = load_packed(FIXTURE / "w3_pc", device="cpu")
    jp, _, _ = jax_load_packed(FIXTURE / "w3_pc")
    cfg = get_config(meta["arch"]).replace(dtype="float32",
                                           n_layers=len(params["layers"]))
    jcfg = jax_get_config(meta["arch"]).replace(
        dtype="float32", n_layers=len(params["layers"]), remat="none")
    jax_cc.clear()
    compile_cache.clear()
    assert compile_cache.stats() == jax_cc.stats() == {
        "entries": 0, "hits": 0, "misses": 0}
    base = dict(batch_size=2, max_len=64, dtype="float32")
    engines = []
    for kw in ({"cache_kind": "dense"}, {"cache_kind": "paged"},
               {"cache_kind": "paged", "speculate": 2},
               {"cache_kind": "dense"}):
        JaxServeEngine(jcfg, jp, **base, **kw)
        engines.append(ServeEngine(cfg, params, device="cpu", **base, **kw))
        assert compile_cache.stats() == jax_cc.stats(), kw
    toks = token_stream("wiki", 4000)
    windows = list(eval_batches(toks, 2, 32))[:2]
    jwin = list(jcorpus.eval_batches(jcorpus.token_stream("wiki", 4000), 2,
                                     32))[:2]
    for _ in range(2):
        perplexity(cfg, params, windows, device="cpu")
        jax_perplexity(jcfg, jp, jwin)
        assert compile_cache.stats() == jax_cc.stats()
    want = jax_cc.stats()
    # 10 kinds; every engine after the first borrows what it can
    assert want == {"entries": 10, "hits": 10, "misses": 10}
    snap = engines[-1].stats_snapshot()
    assert (snap.compile_cache_entries, snap.compile_cache_hits,
            snap.compile_cache_misses) == (10, 10, 10)
    compile_cache.clear()
    assert engines[0].stats_snapshot().compile_cache_entries == 0


@pytest.mark.parametrize("T,K,E,skew", [(1, 1, 4, 0.0), (4, 2, 8, 0.0),
                                        (16, 2, 8, 0.9), (64, 8, 128, 0.8),
                                        (33, 4, 16, 1.0)])
def test_moe_expert_counts_equal_bincount(T, K, E, skew):
    """The per-expert routing counts (scatter_add on the device) equal
    torch.bincount's exactly, and so do the filled slots at the decode and
    prefill capacities, overflow included (a skewed routing sends most
    choices to a few experts)."""
    rng = np.random.default_rng(T * 131 + E)
    hot = rng.random((T, K)) < skew
    topi = np.where(hot, rng.integers(0, 2, (T, K)),
                    rng.integers(0, E, (T, K)))
    topi = torch.from_numpy(topi)
    got = expert_counts(topi, E)
    want = torch.bincount(topi.reshape(-1), minlength=E)
    assert got.dtype == want.dtype and torch.equal(got, want)
    cfg = get_config("tiny-moe")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, n_experts=E,
                                              top_k=K))
    overflow = False
    for cf in (1.0, 1.25, 2.0):
        C = capacity(cfg, T, cf)
        assert torch.equal(got.clamp(max=C), want.clamp(max=C))
        overflow |= bool((want > C).any())
    if skew >= 0.8:
        assert overflow
