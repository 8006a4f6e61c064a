"""The port's serving stack (repro_torch/serve/, launch/serve.py) on the
CPU: greedy tokens of its paged engine equal those the reference's paged
engine (prefix_sharing=False) recorded on the committed fixture
artifacts (tiny-lm w3, tiny-lm w3 with 4-bit binary-coded KV pages,
tiny-moe w3), its paged and dense engines agree, pages drain back to the
pool, the allocator keeps its invariants under preemption, and the
launcher serves the fixture with --device cpu (with --kv-bits too).

The 4-bit KV engine is held to the reference at the same kv_bits, never
to fp KV pages (the reference's own 4-bit-vs-fp greedy comparison fails
on this tree)."""
import importlib.util
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.serve.engine import bucket_len as jax_bucket_len
from repro_torch.ckpt import load_packed
from repro_torch.configs import get_config
from repro_torch.launch.serve import main as launch_main
from repro_torch.serve import (OutOfPages, PagedKVCache, Request,
                               ServeEngine, bucket_len)

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "data" / "torch_port"
REF = json.loads((FIXTURE / "reference.json").read_text())
ARTIFACTS = ["w3_pc", "w3_g64_bf16"]
KV = REF["kv_bits"]


def _model(name):
    params, _, meta = load_packed(FIXTURE / name, device="cpu")
    cfg = get_config(meta["arch"]).replace(dtype="float32",
                                           n_layers=len(params["layers"]))
    return cfg, params


def _serve(cfg, params, prompts, max_new, **kw):
    kw = {"batch_size": 2, "max_len": 64, "dtype": "float32",
          "page_size": 16, "device": "cpu", **kw}
    eng = ServeEngine(cfg, params, **kw)
    reqs = [Request(prompt=np.asarray(p, np.int32), max_new_tokens=max_new)
            for p in prompts]
    eng.run(reqs)
    return eng, [r.out for r in reqs]


def check_drained(kv):
    assert kv.free_page_count == kv.usable_pages
    assert kv.live_pages == 0 and not kv.active_slots()
    assert not kv.block_tables.any()


@pytest.mark.parametrize("name", ARTIFACTS + ["w3_moe"])
def test_paged_engine_matches_reference_greedy_tokens(name):
    art = REF["artifacts"][name]
    cfg, params = _model(name)
    eng, outs = _serve(cfg, params, art["prompts"], REF["max_new"],
                       cache_kind="paged")
    assert outs == art["tokens"]
    assert eng.stats["n_done"] == len(outs)
    assert eng.stats["kv_high_water_pages"] > 0
    check_drained(eng.kv)


@pytest.mark.parametrize("name", sorted(KV["artifacts"]))
def test_kv_bits_engine_matches_reference_greedy_tokens(name):
    """4-bit binary-coded pages: the reference paged engine's tokens at
    the same kv_bits, and the pool's byte count."""
    art = KV["artifacts"][name]
    cfg, params = _model(name)
    eng, outs = _serve(cfg, params, art["prompts"], REF["max_new"],
                       cache_kind="paged", page_size=KV["page_size"],
                       kv_bits=KV["bits"])
    assert outs == art["tokens"]
    assert "k_codes" in eng.cache[0] and "k_pages" not in eng.cache[0]
    # per (token, head) at hd 64: 4 planes x 2 words + 4 alphas + 1 beta
    # = 52 B; x 2 sides x 16 tokens x 4 heads x 2 layers
    assert eng.kv.bytes_per_page() == 2 * 16 * 4 * 52 * 2
    check_drained(eng.kv)


def test_kv_bits_paged_matches_reference_logits():
    """Prefill logits and teacher-forced paged decode logits through a
    4-bit pool, against those the reference recorded."""
    from repro_torch.models import (decode_step_paged, init_paged_cache,
                                    prefill, scatter_prefill_cache)
    page, bits = KV["page_size"], KV["bits"]
    for name, art in KV["artifacts"].items():
        cfg, params = _model(name)
        prompt, toks = art["prompts"][0], art["tokens"][0]
        L = len(prompt)
        logits, row = prefill(cfg, params, torch.tensor([prompt]), L)
        steps = [(logits[0], art["prefill_logits"][0])]
        n_pg = -(-(L + len(toks)) // page)
        pool = init_paged_cache(cfg, n_pg + 1, page, 1, kv_bits=bits,
                                device="cpu")
        ids = list(range(1, n_pg + 1))
        scatter_prefill_cache(cfg, pool, row, 0, ids[:-(-L // page)], L)
        bt = torch.tensor([ids], dtype=torch.int32)
        for t, want in enumerate(art["decode_logits"][0]):
            logits, pool = decode_step_paged(
                cfg, params, pool, torch.tensor([[toks[t]]]),
                torch.tensor([L + t], dtype=torch.int32), bt)
            steps.append((logits[0], want))
        for got, want in steps:
            want = np.asarray(want, np.float64)
            np.testing.assert_allclose(
                got.double().numpy(), want, rtol=0,
                atol=REF["logits_rtol"] * np.abs(want).max())


@pytest.mark.parametrize("name", ARTIFACTS)
def test_paged_equals_dense(name):
    art = REF["artifacts"][name]
    cfg, params = _model(name)
    _, paged = _serve(cfg, params, art["prompts"], 12, cache_kind="paged",
                      batch_size=3)
    _, dense = _serve(cfg, params, art["prompts"], 12, cache_kind="dense",
                      batch_size=3)
    assert paged == dense


def test_preemption_keeps_greedy_output():
    """A pool too small for every sequence's growth forces evictions;
    recompute-on-resume is exact under greedy decoding."""
    art = REF["artifacts"]["w3_pc"]
    cfg, params = _model("w3_pc")
    _, roomy = _serve(cfg, params, art["prompts"], 16, cache_kind="paged",
                      page_size=4, batch_size=3)
    eng, tight = _serve(cfg, params, art["prompts"], 16, cache_kind="paged",
                        page_size=4, batch_size=3, n_pages=13)
    assert eng.sched.preemptions > 0
    assert tight == roomy
    check_drained(eng.kv)


def test_allocator_invariants_under_random_traffic():
    cfg = get_config("tiny-lm").replace(n_layers=1)
    kv = PagedKVCache(cfg, n_pages=9, page_size=4, max_seqs=3,
                      max_pages_per_seq=4, create_pool=False)
    rng = np.random.default_rng(0)
    lens = {}
    for _ in range(400):
        op = rng.integers(0, 4)
        if op == 0:
            s = kv.alloc_slot()
            if s is not None:
                lens[s] = 0
        elif op == 1 and lens:
            s = int(rng.choice(list(lens)))
            n = lens[s] + int(rng.integers(1, 6))
            try:
                kv.ensure(s, n)
                lens[s] = n
            except OutOfPages:
                pass
        elif op == 2 and any(lens.values()):
            s = int(rng.choice([s for s in lens if lens[s]]))
            lens[s] = int(rng.integers(1, lens[s] + 1))
            kv.truncate(s, lens[s])
        elif op == 3 and lens:
            s = int(rng.choice(list(lens)))
            kv.release(s)
            del lens[s]
        owners = np.zeros(kv.n_pages, np.int32)
        for s in range(kv.max_seqs):
            own = kv.owned_pages(s)
            assert list(kv.block_tables[s, :len(own)]) == own
            assert not kv.block_tables[s, len(own):].any()
            owners[own] += 1
        assert kv.free_page_count + kv.live_pages == kv.usable_pages
        assert (owners == kv._refcount).all() and kv.refcount(0) == 0
    for s in list(lens):
        kv.release(s)
    check_drained(kv)


def test_cow_forks_a_shared_page():
    cfg = get_config("tiny-lm").replace(n_layers=1)
    kv = PagedKVCache(cfg, n_pages=6, page_size=4, max_seqs=2,
                      create_pool=False)
    s = kv.alloc_slot()
    kv.ensure(s, 8)
    shared = kv.owned_pages(s)[1]
    kv._refcount[shared] += 1            # a second reader of page 1
    v = kv.bt_version[s]
    copies = kv.cow_for_write(s, 5, 6)
    assert copies == [(shared, kv.owned_pages(s)[1])]
    assert kv.refcount(shared) == 1 and kv.bt_version[s] == v + 1
    assert kv.cow_for_write(s, 0, 8) == []


@pytest.mark.parametrize("n", [1, 7, 8, 9, 100, 1000])
def test_prompt_buckets_match_reference(n):
    assert bucket_len(n, 512) == jax_bucket_len(n, 512)


def test_launcher_serves_fixture_on_cpu(capsys):
    lref = REF["launcher"]
    _, reqs = launch_main(["--load-quantized", str(FIXTURE / "w3_pc"),
                           "--device", "cpu", "--cache", "paged",
                           "--requests", "3", "--batch-size", "3",
                           "--max-new", str(lref["max_new"])])
    assert [r.out for r in reqs] == lref["tokens"][:3]
    assert "served 3 requests" in capsys.readouterr().out


def test_launcher_kv_bits_picks_paged_and_serves_fixture_on_cpu(capsys):
    """--kv-bits 4 with --cache auto serves from binary-coded pages; the
    launcher's prompts are held to the reference only where the
    reference recorded them (fp pages), so this checks the pool, the
    banner and that every request finishes."""
    eng, reqs = launch_main(["--load-quantized", str(FIXTURE / "w3_pc"),
                             "--device", "cpu", "--kv-bits", "4",
                             "--requests", "3", "--batch-size", "3",
                             "--max-new", "6"])
    out = capsys.readouterr().out
    assert eng.cache_kind == "paged" and eng.kv.kv_bits == 4
    assert "quantized KV cache: 4-bit binary-coded pages" in out
    assert all(r.done and len(r.out) == 6 for r in reqs)
    with pytest.raises(SystemExit):
        launch_main(["--load-quantized", str(FIXTURE / "w3_pc"),
                     "--device", "cpu", "--kv-bits", "4", "--cache",
                     "dense"])


def test_launcher_module_entry_point():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve",
                        "--load-quantized", str(FIXTURE / "w3_g64_bf16"),
                        "--device", "cpu", "--requests", "2",
                        "--max-new", "4"], env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "served 2 requests, 6 tokens" in r.stdout


@pytest.mark.parametrize("kw,slice_name", [
    ({"prefix_sharing": True}, "prefix-cache"),
    ({"prefill_chunk": 16}, "chunked-prefill"),
    ({"kv_bits": 4, "cache_kind": "dense"}, "quantized-KV"),
    ({"speculate": 2}, "speculative"),
    ({"mesh": object()}, "multi-GPU")])
def test_later_slices_raise(kw, slice_name):
    """Each slice still to come raises naming its ROADMAP Queue 1 item;
    binary-coded KV pages are served now, and on a dense cache they
    raise as in the reference."""
    cfg, params = _model("w3_pc")
    kw = {"cache_kind": "paged", **kw}
    if slice_name == "quantized-KV":
        with pytest.raises(ValueError, match="kv_bits requires cache_kind"):
            ServeEngine(cfg, params, device="cpu", **kw)
        return
    with pytest.raises(NotImplementedError,
                       match=f"{slice_name}.*ROADMAP Queue 1 item [1-8]"):
        ServeEngine(cfg, params, device="cpu", **kw)


def test_engine_runs_on_cuda_unless_told_otherwise():
    cfg, params = _model("w3_pc")
    if torch.cuda.is_available():
        eng = ServeEngine(cfg, params, cache_kind="paged")
        assert eng.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ServeEngine(cfg, params, cache_kind="paged")


# ---------------------------------------------------------------------------
# chip_smoke.py: its refusals, and its control flow rehearsed on the CPU
# ---------------------------------------------------------------------------

def _chip_smoke(monkeypatch):
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    monkeypatch.setattr(cs, "DEV", "cpu")
    return cs


def test_chip_smoke_refuses_without_sources_or_cuda(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    runs = [subprocess.run([sys.executable, str(alone)], cwd=str(tmp_path),
                           capture_output=True, text=True, timeout=300)]
    if not torch.cuda.is_available():
        runs.append(subprocess.run([sys.executable, "chip_smoke.py"],
                                   cwd=str(ROOT), capture_output=True,
                                   text=True, timeout=300))
    for r in runs:
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout


def test_chip_smoke_phases_rehearse_on_cpu(monkeypatch):
    """Every phase runs end to end with the plain versions on the CPU at
    tiny size; only the launch-count requirements (no kernel launches on
    the CPU) are unmet."""
    cs = _chip_smoke(monkeypatch)
    unmet = []
    monkeypatch.setattr(cs, "require",
                        lambda ok, what: ok or unmet.append(what))
    gen = torch.Generator().manual_seed(0)
    worst, n_checks = cs.check_bcq(gen, [(256, 96)])
    assert n_checks == {"bcq_gemv": 36, "bcq_matmul": 20}
    assert worst["bcq_gemv"] <= cs.TOL_FP32
    assert cs.check_paged(gen) <= cs.TOL_FP32
    assert cs.check_paged_quant(gen, geoms=((2, 16, 64),)) <= cs.TOL_FP32
    # the reader's grid: one case on each of the first two variants (the
    # second with bf16 q and a 4-entry scale group)
    assert cs.check_paged_quant_grid(0, cases=((1, 32, 1), (2, 32, 8))) \
        <= cs.TOL_FP32
    worst_e, n_exact = cs.check_expert(gen, E=3, shapes=((128, 64),),
                                       Ms=(4, 9))
    assert worst_e <= cs.TOL_FP32 and n_exact == 3 * 2 * 2
    quant = cs.summarize_paged_quant(gen, Hkv=2, rep=16, hd=64)
    assert quant["library_full_ms"] > 0 and "G=1," in quant["shape"]
    for row in (cs.summarize_expert(gen, E=2, K=128, N=64), quant,
                cs.summarize_paged(gen, Hkv=2, rep=16, hd=64)):
        assert row["bound_ms"] > 0 and row["max_abs_err"] <= 1e-5
    cs.phase_fixture()
    counts, row = cs.phase_main_path(0, cs.synthetic_llama(0, "tiny-lm"),
                                     0.0)
    assert row["decode_tokens"] == 4 * 31 and row["model"] == "tiny-lm"
    _, row = cs.phase_kv_bits(0, cs.synthetic_llama(0, "tiny-lm"))
    # 2 sides x 4 heads x (4 planes x 2 words + 4 alphas + 1 beta) x 4 B
    # x 4 layers
    assert row["kv_bytes_per_token"] == 2 * 4 * 13 * 4 * 4
    _, row = cs.phase_moe(0, "tiny-moe", 2)
    assert row["decode_tokens"] == 4 * 31 and "2 of 2 layers" in row["depth"]
    launches = [u for u in unmet if "launch" in u]
    assert unmet == launches and len(launches) == 7, unmet


@pytest.mark.parametrize("bits,gs", [(2, 0), (4, 32)])
def test_chip_smoke_near_ties_match_the_parity_tests(monkeypatch, bits, gs):
    """The near-ties chip_smoke's whole-model KV witness counts are the
    ones tests/test_torch_kv_quant.py excuses in kv_quantize: entries set
    halfway between two adjacent levels are ties for both, and both mark
    the same entries."""
    from repro_torch.quant import kv as tkv
    from test_torch_kv_quant import near_ties
    cs = _chip_smoke(monkeypatch)
    rng = np.random.default_rng(bits)
    x = (rng.standard_normal((16, 2, 128)) * 2.0).astype(np.float32)
    _, a, b = tkv.kv_quantize(torch.from_numpy(x), bits, gs)
    levels = np.sort(b.numpy()[..., 0, None]
                     + a.numpy()[..., 0, :] @ tkv.sign_combos(bits).numpy().T,
                     axis=-1)                                 # (16, 2, L)
    x[..., 0] = (levels[..., 0] + levels[..., 1]) / 2
    x[..., 1] = (levels[..., -2] + levels[..., -1]) / 2
    got = cs.near_ties(torch.from_numpy(x), a, b).numpy()
    want = near_ties(x, a.numpy(), b.numpy(), bits, gs or 128).reshape(x.shape)
    np.testing.assert_array_equal(got, want)
    assert got[..., :2].all() and got.mean() < 0.05
