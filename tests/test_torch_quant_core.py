"""The port's quantizer core (src/repro_torch/core/: hessian, rtn,
binary_coding, gptq, gptqt) against the JAX reference's functions on the
same seeded numpy inputs, at N <= 64, K <= 256, per-channel and grouped,
with and without actorder.

Four argmins decide the codes: the level pick of the column sweep, the
BCchoice pick over 4096 candidate level sets, the multiplier pick and
BCQ's sign reassignment. Each is chaotic at a near-tie: fp32 sums in
another order (BLAS vs XLA dots, index_add_ vs segment_sum) move both
sides by a rounding, and a flipped pick changes every later column of
the row. So codes and choices are compared exactly only where the
port's recorded margin clears the stated threshold; every row that
differs must carry such a near-tie, and fp32 results agree within
FP32_RTOL elsewhere."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import binary_coding as jbc
from repro.core import gptq as jgptq
from repro.core import gptqt as jgptqt
from repro.core import hessian as jhess
from repro.core import rtn as jrtn
from repro_torch.core import binary_coding as tbc
from repro_torch.core import gptq as tgptq
from repro_torch.core import gptqt as tgptqt
from repro_torch.core import hessian as thess
from repro_torch.core import rtn as trtn
from repro_torch.quant import codes_from_numpy, unpack_signs
from torch_threads import one_torch_thread  # noqa: F401

# fp32 results of the same sums in another order, relative to max|ref|
FP32_RTOL = 1e-5
# near-tie thresholds of the four picks. A candidate score is
# sum(s2) - 2 V.s1 + V^2.s0, whose fp32 rounding is ~1e-7 of sum(hd *
# Wn^2) (the cancelling constant); the multiplier errors and BCQ's
# distances carry no cancellation; a level pick's gap is relative to
# the row's level span.
CHOICE_TIE_RTOL = 4e-6
MULT_TIE_RTOL = 1e-6
LEVEL_TIE_RTOL = 1e-5
# Eq. 7's multipliers and the min-MSE clip ratios: XLA's fp32
# linspace rounds some entries an ulp apart
ULP_RTOL = 2.5e-7


def _data(n=48, k=256, t=320, seed=0, dead=(3,)):
    """Seeded (W_t (n, k), X (t, k)) with correlated inputs and dead
    input columns."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((k, k)) / np.sqrt(k)
    X = (rng.standard_normal((t, k)) @ (np.eye(k) + 1.5 * A)).astype(np.float32)
    X[:, list(dead)] = 0.0
    W = (rng.standard_normal((n, k)) * 0.05).astype(np.float32)
    return W, X


def _hessian(X):
    return np.asarray(jhess.hessian_from_inputs([jnp.asarray(X)])[0])


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=FP32_RTOL):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


# ---------------------------------------------------------------------------
# hessian
# ---------------------------------------------------------------------------

def test_hessian_streams_like_the_reference():
    _, X = _data(k=96)
    xs = [X[:100], X[100:101], X[101:301].reshape(2, -1, 96), X[301:]]
    Hj, nj = jhess.hessian_from_inputs([jnp.asarray(x) for x in xs])
    Ht, nt = thess.hessian_from_inputs([_t(x) for x in xs])
    assert nt == nj == len(X)                    # every row counted
    _close(Ht.numpy(), Hj)
    acc = thess.HessianAccumulator(96)
    for x in xs:
        acc.update(_t(x))
    assert acc.finalize()[1] == len(X)
    with pytest.raises(ValueError):
        thess.hessian_from_inputs([])


def test_damp_counts_dead_columns_in_the_mean():
    _, X = _data(k=64, dead=(3, 10, 11))
    H = _hessian(X)
    Hj, dj = jhess.damp(jnp.asarray(H), 0.05)
    Ht, dt = thess.damp(_t(H), 0.05)
    assert np.array_equal(dt.numpy(), np.asarray(dj)) and dt.sum() == 3
    np.testing.assert_array_equal(Ht.numpy(), np.asarray(Hj))


# ---------------------------------------------------------------------------
# rtn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gs", [0, 64])
def test_rtn_matches_reference(gs):
    W, _ = _data(n=32, k=128)
    wj, qj = jrtn.quantize_rtn(jnp.asarray(W), 3, group_size=gs)
    wt, qt = trtn.quantize_rtn(_t(W), 3, group_size=gs)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))
    Sj, cj = jrtn.row_grid(jnp.asarray(W), 5, clip=0.7)
    St, ct = trtn.row_grid(_t(W), 5, clip=0.7)
    np.testing.assert_array_equal(St.numpy(), np.asarray(Sj))
    np.testing.assert_array_equal(
        trtn.linear_levels(St, ct, 5).numpy(),
        np.asarray(jrtn.linear_levels(Sj, cj, 5)))
    assert trtn.n_k_groups(128, gs) == jrtn.n_k_groups(128, gs)
    assert trtn.group_rows(_t(W), gs)[0].shape == \
        jrtn.group_rows(jnp.asarray(W), gs)[0].shape
    with pytest.raises(ValueError):
        trtn.n_k_groups(128, 48)


def test_minmse_grid_and_linspace():
    W, _ = _data(n=32, k=128, seed=3)
    Sj, cj = jrtn.minmse_grid(jnp.asarray(W), 3)
    St, ct = trtn.minmse_grid(_t(W), 3)
    np.testing.assert_allclose(St.numpy(), np.asarray(Sj), rtol=ULP_RTOL)
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_allclose(trtn.linspace_f32(0.4, 1.0, 32).numpy(),
                               np.asarray(jnp.linspace(0.4, 1.0, 32)),
                               rtol=ULP_RTOL)
    for r, n, pts in [(1, 5, 33), (2, 4, 9), (0, 5, 33)]:
        np.testing.assert_allclose(tgptqt._mult_grid(r, n, pts).numpy(),
                                   np.asarray(jgptqt._mult_grid(r, n, pts)),
                                   rtol=ULP_RTOL)


# ---------------------------------------------------------------------------
# binary coding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k,cap", [(5, 3, 4096), (4, 2, None),
                                     (3, 3, None), (5, 2, 64)])
def test_enumerate_bc_choices_exact(n, k, cap):
    Ej, Jj = jbc.enumerate_bc_choices(n, k, max_candidates=cap)
    Et, Jt = tbc.enumerate_bc_choices(n, k, max_candidates=cap)
    np.testing.assert_array_equal(Et.numpy(), np.asarray(Ej))
    np.testing.assert_array_equal(Jt.numpy(), np.asarray(Jj))
    np.testing.assert_array_equal(tbc.choice_levels_int(Et, Jt, k).numpy(),
                                  np.asarray(jbc.choice_levels_int(Ej, Jj, k)))
    np.testing.assert_array_equal(tbc.sign_combos(k), jbc.sign_combos(k))


def test_enumerate_bc_choices_samples_7225_down_to_4096():
    E, _ = tbc.enumerate_bc_choices(5, 3)
    assert len(E) == 7225
    assert len(tbc.enumerate_bc_choices(5, 3, max_candidates=4096)[0]) == 4096


def _bcq_tie_rows(W, alphas, bits, rtol=LEVEL_TIE_RTOL):
    """Rows where some weight sits within rtol x the level span of the
    midpoint between its two nearest BCQ levels."""
    lv = alphas.reshape(W.shape[0], -1, bits) @ tbc._combos(bits, "cpu").T
    Kg = W.shape[1] // lv.shape[1]
    d = torch.abs(W.reshape(W.shape[0], lv.shape[1], Kg, 1)
                  - lv[:, :, None, :])
    two = torch.topk(d, 2, dim=-1, largest=False).values
    gap = (two[..., 1] - two[..., 0]) / (lv.amax(-1) - lv.amin(-1))[..., None]
    return (gap < rtol).flatten(1).any(1).numpy()


@pytest.mark.parametrize("gs", [0, 64])
def test_bcq_matches_reference(gs):
    W, _ = _data(n=32, k=128, seed=1)
    aj, sj = jbc.bcq_greedy(jnp.asarray(W), 3)
    at, st = tbc.bcq_greedy(_t(W), 3)
    _close(at.numpy(), aj)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    wj, aj, sj = jbc.bcq_alternating(jnp.asarray(W), 3, group_size=gs)
    wt, at, st = tbc.bcq_alternating(_t(W), 3, group_size=gs)
    assert at.shape == aj.shape and st.shape == sj.shape
    diff = (st.numpy() != np.asarray(sj)).any(0).any(1)
    tie = _bcq_tie_rows(_t(W), at, 3)
    assert not (diff & ~tie).any(), np.flatnonzero(diff & ~tie)
    _close(wt.numpy()[~diff], np.asarray(wj)[~diff])
    _close(at.numpy()[~diff], np.asarray(aj)[~diff])
    _close(tbc.bcq_levels(_t(W), 3, group_size=gs).numpy()[~diff],
           np.asarray(jbc.bcq_levels(jnp.asarray(W), 3,
                                     group_size=gs))[~diff])


# ---------------------------------------------------------------------------
# gptq
# ---------------------------------------------------------------------------

def _solve_order(H, actorder):
    K = H.shape[0]
    if not actorder:
        return np.arange(K)
    Hd, _ = thess.damp(_t(H))
    return torch.argsort(-torch.diagonal(Hd), stable=True).numpy()


def _level_tie_rows(diff, margin, span, order):
    """Rows whose first differing code (in solve order) sits on a level
    near-tie: its gap under LEVEL_TIE_RTOL x the level span. Returns
    (explained rows, unexplained rows)."""
    ok, bad = [], []
    for r in np.flatnonzero(diff.any(1)):
        c = order[np.argmax(diff[r, order])]
        (ok if margin[r, c] < LEVEL_TIE_RTOL * span[r, c] else bad).append(r)
    return ok, bad


@pytest.mark.parametrize("gs,actorder", [(0, True), (0, False), (64, True),
                                         (64, False)])
def test_gptq_solve_matches_reference(gs, actorder):
    W, X = _data(seed=2)
    H = _hessian(X)
    Wr = W.reshape(-1, gs or W.shape[1])
    lv = np.asarray(jrtn.linear_levels(*jrtn.row_grid(jnp.asarray(Wr), 3), 3))
    lv = lv.reshape(W.shape[0], -1, 8) if gs else lv
    qj, ij = jgptq.gptq_solve(jnp.asarray(W), jnp.asarray(H), jnp.asarray(lv),
                              actorder=actorder)
    qt, it, mg = tgptq.gptq_solve(_t(W), _t(H), _t(lv), actorder=actorder,
                                  margins=True)
    diff = it.numpy() != np.asarray(ij)
    lv3 = lv.reshape(W.shape[0], -1, 8)
    G = lv3.shape[1]
    span = np.repeat(lv3.max(-1) - lv3.min(-1), W.shape[1] // G, axis=1)
    ok, bad = _level_tie_rows(diff, mg.numpy(), span,
                              _solve_order(H, actorder))
    assert not bad, f"rows {bad} differ without a level near-tie"
    same = ~diff.any(1)
    assert same.sum() >= 0.75 * len(W), ok
    _close(qt.numpy()[same], np.asarray(qj)[same])
    _same_rows_error(W, H, qt.numpy(), qj, same)


def _same_rows_error(W, H, got, want, same):
    """output_error over the rows without a near-tie agrees within
    FP32_RTOL."""
    ej = jgptq.output_error(jnp.asarray(W[same]),
                            jnp.asarray(np.asarray(want)[same]),
                            jnp.asarray(H))
    et = tgptq.output_error(_t(W[same]), _t(got[same]), _t(H))
    assert abs(et - ej) <= FP32_RTOL * abs(ej), (et, ej)


def test_gptq_solve_refresh_matches_reference():
    W, X = _data(n=32, k=128, seed=4)
    H = _hessian(X)
    qj, ij = jgptq.gptq_solve_refresh(jnp.asarray(W), jnp.asarray(H), bits=3,
                                      group_size=32)
    qt, it = tgptq.gptq_solve_refresh(_t(W), _t(H), bits=3, group_size=32)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    _close(qt.numpy(), qj)
    with pytest.raises(ValueError):
        tgptq.gptq_solve_refresh(_t(W), _t(H), bits=3, group_size=48)


def test_chol_inv_upper_nan_not_raise_on_indefinite():
    H = np.eye(8, dtype=np.float32)
    H[5, 5] = -1.0
    Uj = np.asarray(jgptq._chol_inv_upper(jnp.asarray(H)))
    Ut = tgptq._chol_inv_upper(_t(H)).numpy()
    assert np.isnan(Uj).any() and np.isnan(Ut).any()
    _, X = _data(k=64)
    H = _hessian(X) + 0.1 * np.eye(64, dtype=np.float32)
    _close(tgptq._chol_inv_upper(_t(H)).numpy(),
           jgptq._chol_inv_upper(jnp.asarray(H)))


# ---------------------------------------------------------------------------
# gptqt
# ---------------------------------------------------------------------------

def explain_gptqt(res, ref, W, H, actorder=True):
    """Hold a port GPTQTResult (with margins) against the reference's.
    Returns (tie rows: choice/multiplier, tie rows: level, rows equal).
    Fails on any row that differs without a recorded near-tie."""
    N = W.shape[0]
    pick_tie = ((res.choice_margin < CHOICE_TIE_RTOL)
                | (res.mult_margin < MULT_TIE_RTOL)).numpy().reshape(N, -1)
    picks_differ = (
        (res.choice_e.numpy() != np.asarray(ref.choice_e)).reshape(N, -1,
                                                                  res.qt.bits)
        .any(-1)
        | (res.choice_j.numpy() != np.asarray(ref.choice_j)).reshape(N, -1)
        | ~np.isclose(res.mult.numpy(), np.asarray(ref.mult), rtol=ULP_RTOL,
                      atol=0).reshape(N, -1))
    bad = picks_differ & ~pick_tie
    assert not bad.any(), f"picks differ without a near-tie: rows " \
                          f"{np.flatnonzero(bad.any(1))}"
    choice_rows = picks_differ.any(1)
    # same picks: the levels agree to the multipliers' ulp
    lv, lvr = res.levels.numpy(), np.asarray(ref.levels)
    _close(lv[~choice_rows], lvr[~choice_rows], ULP_RTOL * 8)
    # codes: per (row, column), from the packed signs
    k = res.qt.bits
    ct = unpack_signs(res.qt.codes, W.shape[1]).numpy()          # (k, K, N)
    cr = unpack_signs(codes_from_numpy(np.asarray(ref.qt.codes)),
                      W.shape[1]).numpy()
    diff = (ct != cr).any(0).T & ~choice_rows[:, None]
    lv3 = lv.reshape(N, -1, 2 ** k)
    span = np.repeat(lv3.max(-1) - lv3.min(-1), W.shape[1] // lv3.shape[1],
                     axis=1)
    level_rows, badl = _level_tie_rows(diff, res.level_margin.numpy(), span,
                                       _solve_order(H, actorder))
    assert not badl, f"rows {badl} differ without a level near-tie"
    same = ~choice_rows & ~diff.any(1)
    _close(res.wq_t.numpy()[same], np.asarray(ref.wq_t)[same])
    g = lambda a: np.asarray(a).transpose(1, 0, *range(2, np.ndim(a)))  # noqa
    _close(g(res.qt.alphas.numpy())[~choice_rows],
           g(ref.qt.alphas)[~choice_rows])
    _close(g(res.qt.betas.numpy())[~choice_rows],
           g(ref.qt.betas)[~choice_rows])
    return np.flatnonzero(choice_rows), level_rows, same


@pytest.mark.parametrize("gs,actorder,exact", [
    (0, True, False), (0, False, False), (64, True, False),
    (64, False, False), (0, True, True)])
def test_gptqt_matches_reference(gs, actorder, exact):
    W, X = _data(seed=5 + gs)
    H = _hessian(X)
    kw = dict(group_size=gs, actorder=actorder, exact=exact,
              max_candidates=256 if exact else 4096, orig_dtype="float32")
    ref = jgptqt.gptqt_quantize(jnp.asarray(W), jnp.asarray(H), **kw)
    res = tgptqt.gptqt_quantize(_t(W), _t(H), margins=True, **kw)
    assert res.qt.codes.shape == ref.qt.codes.shape
    assert res.qt.alphas.shape == ref.qt.alphas.shape
    assert res.levels.shape == ref.levels.shape
    choice_rows, level_rows, same = explain_gptqt(res, ref, W, H, actorder)
    assert same.sum() >= 0.75 * len(W), (choice_rows, level_rows)
    # the fuse's own invariant: levels computed as dequant computes them
    wq = res.qt.dequant("float32").T
    np.testing.assert_allclose(wq.numpy(), res.wq_t.numpy(), rtol=0,
                               atol=1e-6 * np.abs(W).max())
    _same_rows_error(W, H, res.wq_t.numpy(), ref.wq_t, same)
