"""The port's serving stack across the model zoo, mirroring
tests/test_model_zoo_serve.py: one paged stack covers attention (K/V
pages per head), MLA (latent pages), Mamba-mix (state slabs beside the
pages) and MoE (batched-expert BCQ), and the paged engine is greedy
token-identical to the dense engine on the same params.

Matrix: {attention, MLA, Mamba-mix, MoE} x {fp, packed by the
reference's quantizer} x {dense, paged}, on the smoke configs, fp32.
Both of the port's engines must give the reference engine's tokens,
recorded with the reference's own params (seeded init_params, and its
GPTQT quantization of them, saved as packed artifacts) by
tests/data/torch_port/make_fixture.py --zoo into
tests/data/torch_port/zoo/; every greedy path there clears GAP_FACTOR x
the logits tolerance (no near-tie). Plus gemma2's and falcon-mamba's
smoke configs, MLA preemption and prefix attach, whole-model logits of
the sandwich-norm, hybrid and pure-Mamba paths against the reference
(1e-4 x max|logit|), and the refusals.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as jmodel
from repro_torch.ckpt import load_packed
from repro_torch.configs import smoke_config
from repro_torch.models import model as tmodel
from repro_torch.serve import Request, ServeEngine
from torch_threads import one_torch_thread  # noqa: F401
from torch_zoo import zoo

ZOO = Path(__file__).resolve().parent / "data" / "torch_port" / "zoo"
DOC = json.loads((ZOO / "zoo.json").read_text())
MATRIX = ["attention", "mla", "mamba-mix", "moe"]
TOL = 1e-4

_params: dict = {}


def artifact(name):
    """(port cfg, params on the CPU) of a zoo artifact."""
    if name not in _params:
        ent = DOC["artifacts"][name]
        cfg = smoke_config(ent["arch"]).replace(dtype="float32")
        if ent["bits"] is not None:
            import dataclasses
            cfg = cfg.replace(quant=dataclasses.replace(cfg.quant,
                                                        bits=ent["bits"]))
        params, _, meta = load_packed(ZOO / name, device="cpu")
        assert meta["arch"] == ent["arch"] + "-smoke"
        _params[name] = (cfg, params)
    return _params[name]


def serve(cfg, params, prompts, max_new, **kw):
    reqs = [Request(prompt=np.asarray(p, np.int32), max_new_tokens=max_new)
            for p in prompts]
    eng = ServeEngine(cfg, params, batch_size=2, max_len=64, dtype="float32",
                      device="cpu", **kw)
    eng.run(reqs)
    return [r.out for r in reqs], eng


@pytest.mark.parametrize("quant", ["fp", "quant"])
@pytest.mark.parametrize("arch", MATRIX)
def test_paged_matches_dense_and_reference(arch, quant):
    name = f"{arch}_{quant}"
    ent = DOC["artifacts"][name]
    cfg, params = artifact(name)
    assert ent["dense"] == ent["paged"]            # the reference's own
    dense, _ = serve(cfg, params, ent["prompts"], DOC["max_new"])
    paged, eng = serve(cfg, params, ent["prompts"], DOC["max_new"],
                       cache_kind="paged", page_size=DOC["page_size"])
    assert dense == paged == ent["dense"]
    assert eng.stats["tokens"] > 0
    kv = eng.kv
    assert kv.live_pages + kv.free_page_count == kv.usable_pages
    if cfg.mamba is not None:
        sl = eng.slab
        assert sl.live_slabs == 0 and sl.high_water > 0
        assert sl.free_slab_count == sl.usable_slabs
        snap = eng.stats_snapshot()
        assert snap.slabs_allocated == len(ent["prompts"])
        assert snap.slab_bytes_per_slab == sl.bytes_per_slab() > 0
    else:
        assert eng.slab is None
    if quant == "quant":
        assert any(hasattr(w, "codes") for w in
                   params["layers"][0].get("mlp", {}).values()) or \
            cfg.moe is not None


@pytest.mark.parametrize("arch", ["gemma2", "mamba"])
def test_gemma2_and_falcon_mamba_serve_like_the_reference(arch):
    ent = DOC["artifacts"][f"{arch}_fp"]
    cfg, params = artifact(f"{arch}_fp")
    dense, _ = serve(cfg, params, ent["prompts"], DOC["max_new"])
    paged, eng = serve(cfg, params, ent["prompts"], DOC["max_new"],
                       cache_kind="paged", page_size=DOC["page_size"])
    assert dense == paged == ent["dense"] == ent["paged"]
    # windows and recurrent state prefill at exact length
    assert not eng._bucket
    assert eng._extend_prefill == (arch == "gemma2")


def test_state_slabs_gate_admission():
    """A pool of one usable slab serves the Mamba requests one at a time
    (two batch slots): the same tokens, a slab high water of 1."""
    ent = DOC["artifacts"]["mamba_fp"]
    cfg, params = artifact("mamba_fp")
    toks, eng = serve(cfg, params, ent["prompts"], DOC["max_new"],
                      cache_kind="paged", page_size=DOC["page_size"],
                      state_slabs=2)
    assert toks == ent["paged"]
    assert eng.slab.high_water == 1 and eng.slab.usable_slabs == 1
    assert eng.slab.slabs_allocated == len(ent["prompts"])
    # one sequence's pages at a time: at most 10 + 5 tokens, 2 pages
    assert eng.kv.high_water <= 2


def test_matrix_covers_every_cache_topology():
    cfgs = {a: artifact(f"{a}_fp")[0] for a in MATRIX}
    assert cfgs["attention"].mla is None and cfgs["attention"].mamba is None
    assert cfgs["mla"].mla is not None
    x = cfgs["mamba-mix"]
    assert x.mamba is not None and any(s.kind != "attn" for s in x.pattern)
    assert any(s.kind == "attn" for s in x.pattern)
    assert cfgs["moe"].moe is not None
    p = artifact("mla_fp")[1]
    pool = tmodel.init_paged_cache(cfgs["mla"], 3, 8, 2, device="cpu")
    assert set(pool[0]) == {"ckv_pages", "kpe_pages"}
    pool = tmodel.init_paged_cache(x, 3, 8, 2, device="cpu")
    assert {"ssm", "conv"} <= set().union(*pool) and \
        {"k_pages", "v_pages"} <= set().union(*pool)
    assert "wkv_b" in p["layers"][0]["attn"]


def test_fp_artifacts_are_the_reference_init():
    """The zoo's fp artifacts hold the reference's init_params(smoke
    config, PRNGKey(0)), as the port's own tests take them."""
    for arch in ("mla", "mamba-mix"):
        cfg, params = artifact(f"{arch}_fp")
        ref = zoo(DOC["artifacts"][f"{arch}_fp"]["arch"])["fp"]
        for a, b in zip(jax.tree.leaves(params["layers"]),
                        jax.tree.leaves(ref["layers"])):
            assert torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(DOC["artifacts"]))
def test_zoo_artifacts_load_and_save_like_the_reference(tmp_path, name):
    """The reference's artifacts of every zoo member (MLA, Mamba and
    sandwich-norm leaves, packed and fp) load in the port with the codes
    the reference's load_packed reads, bit for bit, and the port's
    save_packed writes them back byte-equal."""
    from repro.ckpt.packed import load_packed as jax_load_packed
    from repro_torch.ckpt import save_packed
    cfg, params = artifact(name)
    _, spec, meta = load_packed(ZOO / name, device="cpu")
    jparams, _, _ = jax_load_packed(ZOO / name)
    P = len(cfg.pattern)
    for j, lp in enumerate(params["layers"]):
        jl = jparams["blocks"][f"L{j % P}"]
        for key, sub in lp.items():
            for leaf, t in (sub.items() if isinstance(sub, dict)
                            else [(None, sub)]):
                ref = jl[key] if leaf is None else jl[key][leaf]
                if hasattr(t, "codes"):
                    np.testing.assert_array_equal(
                        t.codes.numpy().view(np.uint32),
                        np.asarray(ref.codes)[j // P])
                else:
                    np.testing.assert_array_equal(t.numpy(),
                                                  np.asarray(ref)[j // P])
    out = save_packed(tmp_path / name, params, cfg=cfg, spec=spec, meta=meta)
    assert (json.loads((out / "manifest.json").read_text())
            == json.loads((ZOO / name / "manifest.json").read_text()))
    with np.load(out / "arrays.npz") as a, \
            np.load(ZOO / name / "arrays.npz") as b:
        assert a.files == b.files
        for k in b.files:
            assert a[k].tobytes() == b[k].tobytes(), k


def test_mla_preemption_by_eviction_resumes_exactly():
    """A pool too small for both sequences forces LIFO preemption
    mid-decode; the resumed sequence regenerates the reference's
    tokens."""
    d = DOC["mla_preempt"]
    cfg, params = artifact("mla_fp")
    dense, _ = serve(cfg, params, d["prompts"], d["max_new"])
    paged, eng = serve(cfg, params, d["prompts"], d["max_new"],
                       cache_kind="paged", page_size=DOC["page_size"],
                       n_pages=d["n_pages"])
    assert eng.sched.preemptions == d["preemptions"] > 0
    assert dense == paged == d["dense"] == d["paged"]


def test_mla_prefix_attach_skips_prefill_and_pages():
    d = DOC["mla_prefix"]
    cfg, params = artifact("mla_fp")
    runs = {}
    for sharing in (False, True):
        toks, eng = serve(cfg, params, d["prompts"], d["max_new"],
                          cache_kind="paged", page_size=DOC["page_size"],
                          prefix_sharing=sharing)
        runs[sharing] = (toks, eng)
        want = d["share" if sharing else "plain"]
        assert toks == want["tokens"]
        assert eng.stats["prefix_hits"] == want["prefix_hits"]
        assert eng.stats["prefix_tokens_saved"] == want["prefix_tokens_saved"]
        assert eng.kv.pages_allocated == want["pages_allocated"]
        assert eng.stats["cow_forks"] == want["cow_forks"] == 0
    base, eng = runs[False][1], runs[True][1]
    assert eng.stats["prefix_hits"] == 1
    assert (base.kv.pages_allocated - eng.kv.pages_allocated
            == 4 * DOC["page_size"] // DOC["page_size"])


# ---------------------------------------------------------------------------
# whole-model logits: sandwich norms, hybrid, pure Mamba
# ---------------------------------------------------------------------------

def close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("arch", ["gemma2-27b", "jamba-1.5-large-398b",
                                  "falcon-mamba-7b"])
def test_model_paths_match_the_reference(arch):
    """prefill logits, three dense decode steps, then the paged path: an
    extend pass over pages for gemma2 (its window layers prefill there),
    prefill + scatter + paged decode for the Mamba patterns (their state
    rows at slot 1 of 2). gemma2's 40-token prompt overruns its 32-token
    smoke window."""
    st = zoo(arch)
    jcfg, cfg = st["jcfg"], st["cfg"]
    L = 40 if arch.startswith("gemma2") else 11
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (1, L)).astype(np.int32)
    jl, jc = jmodel.prefill(jcfg, st["jfp"], jnp.asarray(toks), 48)
    tl, tc = tmodel.prefill(cfg, st["fp"], torch.from_numpy(toks), 48)
    close(tl, jl)
    for t in range(3):
        nxt = np.asarray(jnp.argmax(jl, -1), np.int32)[:, None]
        pos = np.array([L + t], np.int32)
        jl, jc = jmodel.decode_step(jcfg, st["jfp"], jc, jnp.asarray(nxt),
                                    jnp.asarray(pos))
        tl, tc = tmodel.decode_step(cfg, st["fp"], tc, torch.from_numpy(nxt),
                                    torch.from_numpy(pos))
        close(tl, jl)
    page = 8
    n_pg = -(-(L + 3) // page)
    ids = np.arange(1, n_pg + 1, dtype=np.int32)
    jpool = jmodel.init_paged_cache(jcfg, n_pg + 1, page, 2, jnp.float32)
    tpool = tmodel.init_paged_cache(cfg, n_pg + 1, page, 2, "float32",
                                    device="cpu")
    if arch.startswith("gemma2"):
        args = [np.array([0], np.int32), ids[None], np.array([L], np.int32)]
        jl, jpool = jmodel.extend_paged(jcfg, st["jfp"], jpool,
                                        jnp.asarray(toks),
                                        *map(jnp.asarray, args))
        tl, tpool = tmodel.extend_paged(cfg, st["fp"], tpool,
                                        torch.from_numpy(toks),
                                        *map(torch.from_numpy, args))
        close(tl, jl)
        bt = ids[None]
        row = 0
    else:
        with pytest.raises(NotImplementedError, match="attention-only"):
            tmodel.extend_paged(cfg, st["fp"], tpool, torch.from_numpy(toks),
                                torch.zeros(1, dtype=torch.int32),
                                torch.from_numpy(ids[None]),
                                torch.tensor([L], dtype=torch.int32))
        jl, jrow = jmodel.prefill(jcfg, st["jfp"], jnp.asarray(toks), L)
        _, trow = tmodel.prefill(cfg, st["fp"], torch.from_numpy(toks), L)
        jpool = jmodel.scatter_prefill_cache(jcfg, jpool, jrow, 1,
                                             jnp.asarray(ids[:-(-L // page)]),
                                             L)
        tmodel.scatter_prefill_cache(cfg, tpool, trow, 1,
                                     list(ids[:-(-L // page)]), L)
        bt = np.zeros((2, n_pg), np.int32)
        bt[1] = ids
        row = 1
    B = bt.shape[0]
    for t in range(3):
        nxt = np.zeros((B, 1), np.int32)
        nxt[row] = int(jnp.argmax(jl[-1]))
        pos = np.zeros((B,), np.int32)
        pos[row] = L + t
        jl, jpool = jmodel.decode_step_paged(jcfg, st["jfp"], jpool,
                                             jnp.asarray(nxt),
                                             jnp.asarray(pos),
                                             jnp.asarray(bt))
        tl, tpool = tmodel.decode_step_paged(cfg, st["fp"], tpool,
                                             torch.from_numpy(nxt),
                                             torch.from_numpy(pos),
                                             torch.from_numpy(bt))
        close(tl[row], np.asarray(jl)[row])


def test_launcher_serves_mla_and_hybrid_artifacts(tmp_path, monkeypatch,
                                                  capsys):
    """The launcher boots artifacts of the new archs from their meta and
    prints the reference's latent-cache and slab-pool lines: tiny-mla,
    and a byte-vocab copy of jamba's smoke config registered for the
    test (the launcher's prompts are bytes)."""
    from repro_torch import configs
    from repro_torch.ckpt import save_packed
    from repro_torch.launch.serve import main as launch_main
    from repro_torch.models import init_params
    hybrid = smoke_config("jamba-1.5-large-398b").replace(
        name="tiny-jamba", vocab_size=258, dtype="float32")
    monkeypatch.setitem(configs.REGISTRY, hybrid.name, hybrid)
    for cfg in (configs.get_config("tiny-mla"), hybrid):
        p = init_params(cfg, seed=0, dtype="float32", device="cpu")
        save_packed(tmp_path / cfg.name, p, cfg=cfg,
                    meta={"arch": cfg.name, "n_layers": cfg.n_layers})
        eng, reqs = launch_main(["--load-quantized", str(tmp_path / cfg.name),
                                 "--device", "cpu", "--cache", "paged",
                                 "--requests", "2", "--max-new", "3"])
        out = capsys.readouterr().out
        assert all(len(r.out) == 3 for r in reqs)
        if cfg.mla is not None:
            assert "paged latent cache" in out and eng.slab is None
        else:
            assert "paged kv cache" in out
            assert (f"state slab pool: 3 usable slabs (1 reserve), "
                    f"{eng.slab.bytes_per_slab()} B/slab") in out


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_refusals():
    mla, mp = artifact("mla_fp")
    mix, xp = artifact("mamba-mix_fp")
    msg = "speculate>0 verifies k\\+1 positions"
    for cfg, p in ((mla, mp), (mix, xp)):
        with pytest.raises(NotImplementedError, match=msg):
            ServeEngine(cfg, p, cache_kind="paged", speculate=2,
                        device="cpu")
    with pytest.raises(NotImplementedError, match="already compressed"):
        ServeEngine(mla, mp, cache_kind="paged", kv_bits=4, device="cpu")
    with pytest.raises(NotImplementedError, match="attention-only"):
        ServeEngine(mix, xp, cache_kind="paged", prefill_chunk=4,
                    device="cpu")
    # MLA shares prefixes, Mamba patterns do not
    assert ServeEngine(mla, mp, cache_kind="paged",
                       device="cpu")._prefix is not None
    assert ServeEngine(mix, xp, cache_kind="paged",
                       device="cpu")._prefix is None
    hubert = smoke_config("hubert-xlarge")
    with pytest.raises(NotImplementedError, match="frame inputs"):
        ServeEngine(hubert, {}, device="cpu")
