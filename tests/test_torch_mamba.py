"""The port's Mamba block (repro_torch/models/mamba.py and its model
paths) against the reference's, at the falcon-mamba-7b smoke config
(d_model 64, d_inner 128, d_state 8, chunk 16), fp32, on the
reference's own init_params carried across.

`selective_scan` combines each chunk as a Hillis-Steele scan where the
reference runs `jax.lax.associative_scan`: the same combine in another
tree, so they agree to fp32 rounding. Tolerance: SCAN_TOL x max|y| and
x max|h| (measured: under 3e-7), across L = 1, L < chunk, L a multiple
of chunk, L not a multiple, and a nonzero initial state; model logits
1e-4 x max|logit|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import mamba as jmamba
from repro.models import model as jmodel
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.models import mamba as tmamba
from repro_torch.models import model as tmodel
from repro_torch.serve import Request, ServeEngine
from torch_threads import one_torch_thread  # noqa: F401
from torch_zoo import zoo

ARCH = "falcon-mamba-7b"
SCAN_TOL = 1e-5
TOL = 1e-4


def close(got, want, tol=TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def scan_inputs(L, B=2, di=32, ds=8, seed=0, h0=False):
    """Seeded scan operands at the smoke config's scale: softplus-range
    steps, A = -(1..ds) as A_log gives, unit-scale x, B, C."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, di)).astype(np.float32)
    dt = rng.uniform(1e-3, 0.4, (B, L, di)).astype(np.float32)
    A = -np.tile(np.arange(1, ds + 1, dtype=np.float32), (di, 1))
    Bm = rng.standard_normal((B, L, ds)).astype(np.float32)
    Cm = rng.standard_normal((B, L, ds)).astype(np.float32)
    h = (rng.standard_normal((B, di, ds)) if h0 else
         np.zeros((B, di, ds))).astype(np.float32)
    return x, dt, A, Bm, Cm, h


@pytest.mark.parametrize("L,h0", [(1, False), (5, False), (16, False),
                                  (37, False), (37, True), (64, True)])
def test_selective_scan_matches_reference(L, h0):
    ops = scan_inputs(L, h0=h0, seed=L)
    wy, wh = jmamba.selective_scan(*map(jnp.asarray, ops), 16)
    ty, th = tmamba.selective_scan(*map(torch.from_numpy, ops), 16)
    assert ty.shape == wy.shape and th.shape == wh.shape
    close(ty, wy, SCAN_TOL)
    close(th, wh, SCAN_TOL)


def test_selective_scan_long_decays_stay_finite():
    """256 steps of dt*A near -1.6 each: a cumulative sum of log-decays
    would reach exp(+400) on the way back; products of decays do not."""
    x, dt, A, Bm, Cm, h = scan_inputs(256, B=1, seed=9, h0=True)
    dt[:] = 0.1
    A = A * 16 / A.shape[1]                  # dt*A down to -1.6
    wy, wh = jmamba.selective_scan(*map(jnp.asarray, (x, dt, A, Bm, Cm, h)),
                                   256)
    ty, th = tmamba.selective_scan(*map(torch.from_numpy,
                                        (x, dt, A, Bm, Cm, h)), 256)
    assert bool(torch.isfinite(ty).all()) and bool(torch.isfinite(th).all())
    close(ty, wy, SCAN_TOL)
    close(th, wh, SCAN_TOL)


@pytest.mark.parametrize("L", [1, 2, 3, 20, 37])
def test_mamba_forward_with_state_matches_reference(L):
    """The block's output and its decode state; from L >= d_conv - 1 the
    conv tail is the reference's, below it the port left-pads the tail
    with the conv's zero history (the reference's is shorter)."""
    st = zoo(ARCH)
    jcfg, cfg = st["jcfg"], st["cfg"]
    rng = np.random.default_rng(L)
    x = rng.standard_normal((2, L, cfg.d_model)).astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], st["jfp"]["blocks"]["L0"]["mamba"])
    wy, ws = jmamba.mamba_forward(jcfg, jp, jnp.asarray(x), return_state=True)
    ty, ts = tmamba.mamba_forward(cfg, st["fp"]["layers"][0]["mamba"],
                                  torch.from_numpy(x), return_state=True)
    close(ty, wy)
    close(ts["ssm"], ws["ssm"])
    K1 = cfg.mamba.d_conv - 1
    assert ts["conv"].shape == (2, K1, cfg.d_inner)
    tail = np.asarray(ws["conv"])
    close(ts["conv"][:, K1 - tail.shape[1]:], tail, 1e-6)
    assert not ts["conv"][:, :K1 - tail.shape[1]].any()


def test_mamba_prefill_then_decode_is_continuous():
    """prefill(L) then decode steps gives the logits of prefill(L + t)
    at every step, in the port; and the port's whole-model prefill and
    decode logits match the reference's."""
    st = zoo(ARCH)
    jcfg, cfg = st["jcfg"], st["cfg"]
    rng = np.random.default_rng(5)
    seq = rng.integers(0, cfg.vocab_size, (1, 14)).astype(np.int32)
    L = 9
    jl, jc = jmodel.prefill(jcfg, st["jfp"], jnp.asarray(seq[:, :L]), L)
    tl, tc = tmodel.prefill(cfg, st["fp"], torch.from_numpy(seq[:, :L]), L)
    close(tl, jl)
    for t in range(L, 14):
        tok, pos = seq[:, t:t + 1], np.array([t], np.int32)
        jl, jc = jmodel.decode_step(jcfg, st["jfp"], jc, jnp.asarray(tok),
                                    jnp.asarray(pos))
        tl, tc = tmodel.decode_step(cfg, st["fp"], tc, torch.from_numpy(tok),
                                    torch.from_numpy(pos))
        close(tl, jl)
        full, _ = tmodel.prefill(cfg, st["fp"],
                                 torch.from_numpy(seq[:, :t + 1]), t + 1)
        close(tl, full.numpy())


def test_state_rows_are_not_page_leaves():
    """Mamba state rows keep ndim 3, so compaction and forks never move
    them, even when max_seqs equals n_pages."""
    cfg = zoo(ARCH)["cfg"]
    pool = tmodel.init_paged_cache(cfg, 4, 8, 4, "float32", device="cpu")
    assert pool[0]["ssm"].shape == (4, cfg.d_inner, cfg.mamba.d_state)
    assert pool[0]["conv"].shape == (4, cfg.mamba.d_conv - 1, cfg.d_inner)
    assert not any(tmodel.is_page_leaf(v, 4) for v in pool[0].values())
    pool[0]["ssm"][1] = 1.0
    tmodel.copy_pages(pool, [1], [3], 4)
    assert not pool[0]["ssm"][3].any()


def _greedy_by_prefill(cfg, params, prompt, n):
    """Greedy continuation with no cache: a whole prefill per token."""
    seq = list(prompt)
    for _ in range(n):
        logits, _ = tmodel.prefill(cfg, params,
                                   torch.tensor([seq], dtype=torch.int32),
                                   len(seq))
        seq.append(int(torch.argmax(logits[0])))
    return seq[len(prompt):]


@pytest.mark.parametrize("L", [1, 2, 3])
def test_short_prompts_serve_like_whole_prefills(L):
    """Prompts shorter than the conv window: the port's engines (dense
    and paged) give the tokens of whole-sequence prefills. The
    reference's engine gives them at L = 3; at L = 2 it raises (its
    2-row conv tail does not fit the 3-row state) and at L = 1 it
    broadcasts the one row over the window (ROADMAP, known defects of
    the reference), so only L = 3 is held to its tokens."""
    st = zoo(ARCH)
    jcfg, cfg = st["jcfg"], st["cfg"]
    p = (np.arange(L) * 7 + 3).astype(np.int32) % cfg.vocab_size
    want = _greedy_by_prefill(cfg, st["fp"], p, 4)
    for kind in ("dense", "paged"):
        r = Request(prompt=p, max_new_tokens=4)
        ServeEngine(cfg, st["fp"], batch_size=2, max_len=64, dtype="float32",
                    cache_kind=kind, page_size=8, device="cpu").run([r])
        assert r.out == want, kind
    jr = JRequest(prompt=p, max_new_tokens=4)
    eng = JServeEngine(jcfg, st["jfp"], batch_size=2, max_len=64,
                       dtype="float32", cache_kind="paged", page_size=8)
    if L == 2:
        with pytest.raises(ValueError, match="broadcast"):
            eng.run([jr])
    elif L == 3:
        eng.run([jr])
        assert jr.out == want
