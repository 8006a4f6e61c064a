"""The port's model-level quantizer against the JAX reference: the spec
(quant/spec.py), the registry and its six built-ins (quant/registry.py,
core/quantizers.py), the activation taps (models/layers.py,
models/moe.py), calibration and quantize_model (core/api.py) and the
sensitivity search (quant/search.py).

quantize_model runs on the fixture's own inputs — the reference's
init_params(cfg, PRNGKey(0)) carried across and its two (2, 48)
calibration batches (tests/data/torch_port/make_fixture.py) — and is
held against the committed artifacts w3_pc, w3_g64_bf16 and w3_moe,
which tests/test_torch_ckpt.py re-derives from the JAX quantizer. The
port's Hessians come from its own forward (torch's sums in their own
order, ~1e-6 of the reference's), so picks flip at near-ties: every row
whose codes or scales differ must carry a near-tie in the port's own
record (gptqt_quantize(margins=True)), and the per-leaf output errors
agree within the stated tolerances. The counts of such rows are
printed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import api as japi
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.quant import OverrideRule as JaxRule
from repro.quant import QuantSpec as JaxSpec
from repro.quant import get_quantizer as jax_get_quantizer
from repro.quant import search as jsearch
from repro_torch.ckpt import load_packed, params_from_tree
from repro_torch.configs import LayerSpec, get_config
from repro_torch.core import (collect_hessians, eligible_paths,
                              output_error, quantize_model)
from repro_torch.core.api import forward_unrolled
from repro_torch.core.gptqt import gptqt_quantize
from repro_torch.core.hessian import damp
from repro_torch.models import layers as L
from repro_torch.models.moe import moe_forward
from repro_torch.quant import (OverrideRule, QuantResult, Quantizer,
                               QuantSpec, available_quantizers,
                               get_quantizer, register_quantizer,
                               unpack_signs)
from repro_torch.quant import search as tsearch
from repro_torch.quant import registry
from torch_threads import one_torch_thread  # noqa: F401

from test_torch_ckpt import FIXTURE

KEY = jax.random.PRNGKey(0)
ARTIFACTS = {"w3_pc": ("tiny-lm", 0), "w3_g64_bf16": ("tiny-lm", 64),
             "w3_moe": ("tiny-moe", 0)}
# Hessians from the port's forward against the reference's: fp32 sums
# of the same activations in another order, relative to max|H|
HESSIAN_RTOL = 1e-5
# near-ties (the port's margins, gptqt_quantize(margins=True)): a
# candidate score rounds at ~1e-7 of the row's weighted energy and the
# Hessians differ by ~1e-6, which moves a column's weight by ~1e-6 of
# its level span (the rows that differ read at most 3.2e-7 and 1.4e-5)
CHOICE_TIE_RTOL = 4e-6
MULT_TIE_RTOL = 1e-6
LEVEL_TIE_RTOL = 1e-4
# scales of rows with equal picks: the multipliers' ulp, then bf16
SCALE_RTOL = {None: 1e-6, "bfloat16": 2 ** -8}
# per-leaf output error (the report's mean over groups and experts) of
# the port's quantization against the artifact's, both under the port's
# Hessian: rows without a near-tie agree to fp32 sums; a tie row re-runs
# its sweep from the flip on (the leaves read up to 4.4e-3 apart)
SAME_ROWS_ERR_RTOL = 1e-4
LEAF_ERR_RTOL = 2e-2


def _jax_cfg(arch):
    return jax_get_config(arch).replace(dtype="float32", n_layers=2)


def _cfg(arch):
    return get_config(arch).replace(dtype="float32", n_layers=2)


def _calib(cfg):
    return [np.array(jax.random.randint(jax.random.fold_in(KEY, i), (2, 48),
                                        0, cfg.vocab_size))
            for i in range(2)]


@pytest.fixture(scope="module")
def models():
    """arch -> (reference params, port params on the CPU, calibration)."""
    out = {}
    for arch in ("tiny-lm", "tiny-moe"):
        p = jax_init_params(_jax_cfg(arch), KEY)
        out[arch] = (p, params_from_tree(jax.tree.map(np.asarray, p),
                                         device="cpu"), _calib(_cfg(arch)))
    return out


# ---------------------------------------------------------------------------
# spec and registry
# ---------------------------------------------------------------------------

RULES = [
    (("wv", dict(bits=4)),),
    (("blocks.L1.*", dict(bits=4, group_size=64)), ("*.wd", dict(skip=True))),
    (("wq", dict(method="bcq")), ("blocks.L0.mlp.*", dict(bits=2)),
     ("wq", dict(bits=5))),
]


def _slot_leaves(cfg, params):
    """(dotted path, name, ndim) of every port leaf, as the reference
    addresses it."""
    P = len(cfg.pattern)
    out = []
    for j, lp in enumerate(params["layers"]):
        def walk(node, path):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v, path + (k,))
                else:
                    out.append(("blocks." + ".".join(path + (k,)), k,
                                v.dim()))
        walk(lp, (f"L{j % P}",))
    return out


@pytest.mark.parametrize("rules", RULES)
def test_override_rules_resolve_like_the_reference(rules):
    cfg = get_config("tiny-lm").replace(
        pattern=(LayerSpec(), LayerSpec(window=16)), n_layers=4)
    params = {"layers": [{"attn": {w: torch.zeros(2, 2) for w in
                                   ("wq", "wk", "wv", "wo")},
                          "mlp": {w: torch.zeros(2, 2) for w in
                                  ("wg", "wu", "wd")},
                          "ln": torch.zeros(2)} for _ in range(4)]}
    spec = QuantSpec(overrides=tuple(OverrideRule(p, **kw) for p, kw in rules),
                     exclude=("wk",))
    jspec = JaxSpec(overrides=tuple(JaxRule(p, **kw) for p, kw in rules),
                    exclude=("wk",))
    leaves = _slot_leaves(cfg, params)
    assert any(p.startswith("blocks.L1.") for p, _, _ in leaves)
    for dotted, name, nd in leaves:
        got = spec.resolve(dotted, name, nd + 1)
        want = jspec.resolve(dotted, name, nd + 1)
        assert (got is None) == (want is None), dotted
        if got is not None:
            assert vars(got) == vars(want), dotted
    assert spec.to_dict() == jspec.to_dict()
    assert QuantSpec.from_dict(jspec.to_dict()) == spec


def test_spec_of_a_loaded_artifact_reads_back():
    _, spec, _ = load_packed(FIXTURE / "w3_g64_bf16", device="cpu")
    qs = QuantSpec.from_dict(spec)
    assert qs.group_size == 64 and qs.mode == "packed"
    assert qs.to_dict() == spec
    with pytest.raises(ValueError):
        QuantSpec(mode="int8")
    with pytest.raises(ValueError):
        OverrideRule("wq", group_size=-1)


def test_registry_matches_reference():
    assert available_quantizers() == sorted(
        ["rtn", "bcq", "gptq", "gptq_minmse", "gptq_bcq", "gptqt"])
    for m in available_quantizers():
        assert get_quantizer(m).supports_packed == \
            jax_get_quantizer(m).supports_packed
        assert get_quantizer(m).name == m
    with pytest.raises(KeyError, match="registered"):
        get_quantizer("nope")


def test_custom_quantizer_plugs_into_quantize_model(models):
    @register_quantizer("test_zero")
    class Zero(Quantizer):
        def quantize(self, Wt, H, plan, *, orig_dtype="bfloat16"):
            return QuantResult(wq_t=torch.zeros_like(Wt))
    try:
        _, params, calib = models["tiny-lm"]
        qp, rep = quantize_model(_cfg("tiny-lm"), params, calib,
                                 spec=QuantSpec(method="test_zero"),
                                 device="cpu")
        assert not qp["layers"][1]["attn"]["wq"].any()
        assert params["layers"][1]["attn"]["wq"].any()   # input untouched
        assert {v["method"] for v in rep.values()} == {"test_zero"}
    finally:
        registry._REGISTRY.pop("test_zero")


@pytest.mark.parametrize("method", ["rtn", "bcq", "gptq", "gptq_minmse",
                                    "gptq_bcq", "gptqt"])
def test_builtin_quantizers_match_reference(method):
    rng = np.random.default_rng(7)
    X = rng.standard_normal((200, 128)).astype(np.float32)
    W = (rng.standard_normal((32, 128)) * 0.05).astype(np.float32)
    H = 2 * X.T @ X / len(X)
    for gs, mode in [(0, "fake"), (32, "packed" if method in ("bcq", "gptqt")
                                  else "fake")]:
        plan = QuantSpec(method=method, group_size=gs,
                         mode=mode).resolve("blocks.L0.attn.wq", "wq")
        jplan = JaxSpec(method=method, group_size=gs,
                        mode=mode).resolve("blocks.L0.attn.wq", "wq")
        got = get_quantizer(method).quantize(torch.from_numpy(W),
                                             torch.from_numpy(H), plan)
        want = jax_get_quantizer(method).quantize(jnp.asarray(W),
                                                  jnp.asarray(H), jplan)
        assert (got.qt is None) == (want.qt is None)
        if method == "gptqt":
            # its parity, near-ties and all, is test_torch_quant_core's;
            # here the wrapper hands the plan through
            res = gptqt_quantize(torch.from_numpy(W), torch.from_numpy(H),
                                 group_size=gs)
            assert torch.equal(got.wq_t, res.wq_t)
            if got.qt is not None:
                assert torch.equal(got.qt.codes, res.qt.codes)
                assert got.qt.alphas.shape == want.qt.alphas.shape
            continue
        np.testing.assert_allclose(got.wq_t.numpy(), np.asarray(want.wq_t),
                                   rtol=0, atol=1e-5 * np.abs(W).max())
        if got.qt is not None:
            np.testing.assert_array_equal(
                got.qt.codes.numpy().view(np.uint32), np.asarray(want.qt.codes))
            np.testing.assert_allclose(got.qt.alphas.numpy(),
                                       np.asarray(want.qt.alphas), rtol=1e-5)


# ---------------------------------------------------------------------------
# taps and calibration
# ---------------------------------------------------------------------------

def test_taps_record_linear_and_expert_inputs():
    w = torch.randn(8, 4)
    x = torch.randn(2, 3, 8)
    with L.tap_activations() as rec:
        L.linear(x, w)
        L.linear(x, w)
    assert L._TAP is None
    assert [t.shape for t in rec[id(w)]] == [(6, 8), (6, 8)]
    L.linear(x, w)                                   # no tap: nothing kept
    cfg = _cfg("tiny-moe")
    gen = torch.Generator().manual_seed(0)
    from repro_torch.models.moe import capacity, init_moe
    p = init_moe(cfg, gen, "float32", "cpu")
    h = torch.randn(2, 5, cfg.d_model, generator=gen)
    with L.tap_activations() as rec:
        moe_forward(cfg, p, h, capacity_factor=cfg.moe.capacity_factor)
    C = capacity(cfg, 10, cfg.moe.capacity_factor)
    E, F = cfg.moe.n_experts, cfg.moe.d_ff_expert
    assert rec[id(p["wg"])][0] is rec[id(p["wu"])][0]
    assert rec[id(p["wg"])][0].shape == (E, C, cfg.d_model)
    assert rec[id(p["wd"])][0].shape == (E, C, F)
    assert id(p["router"]) not in rec


@pytest.mark.parametrize("arch", ["tiny-lm", "tiny-moe"])
def test_collect_hessians_matches_reference(models, arch):
    """Same keys (the reference's report keys), the same row counts
    (capacity-padded expert slots counted, at the train-time capacity
    factor), Hessians within HESSIAN_RTOL."""
    p, params, calib = models[arch]
    spec = QuantSpec(include_head=False)
    want = japi.collect_hessians(_jax_cfg(arch), p, [jnp.asarray(c) for c in
                                                     calib],
                                 spec=JaxSpec(include_head=False))
    got = collect_hessians(_cfg(arch), params, calib, spec=spec,
                           device="cpu")
    assert set(got) == set(want)
    for key, (path, g, leaf, H) in got.items():
        wpath, wg, wleaf, wH = want[key]
        assert g == wg and ".".join(path) == ".".join(
            str(k.key) for k in wpath)
        for a, b in zip(H if isinstance(H, list) else [H],
                        wH if isinstance(wH, list) else [wH]):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                       atol=HESSIAN_RTOL * np.abs(b).max())


@pytest.mark.parametrize("arch", ["tiny-lm", "tiny-moe"])
def test_calibration_forward_is_the_reference_forward(models, arch):
    """forward_unrolled is the reference's training forward: MoE layers
    at the train-time capacity factor (prefill's inference factor gives
    other capacities and other logits)."""
    p, params, calib = models[arch]
    want = np.asarray(jax_forward(_jax_cfg(arch), p, jnp.asarray(calib[0]))[0])
    got = forward_unrolled(_cfg(arch), params, torch.from_numpy(calib[0]))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_eligible_paths_and_head(models):
    _, params, _ = models["tiny-lm"]
    cfg = _cfg("tiny-lm")
    paths = [p for p, _ in eligible_paths(cfg, params)]
    assert len(paths) == 2 * 7 and paths[0][:2] == ("layers", 0)
    cfg = get_config("llama2-7b").replace(n_layers=1, d_model=8, n_heads=1,
                                          n_kv_heads=1, head_dim=8, d_ff=8,
                                          vocab_size=16)
    from repro_torch.models import init_params
    p = init_params(cfg, dtype="float32", device="cpu")
    assert ("lm_head",) in [q for q, _ in eligible_paths(cfg, p, True)]
    assert ("lm_head",) not in [q for q, _ in eligible_paths(cfg, p)]


# ---------------------------------------------------------------------------
# quantize_model against the committed artifacts
# ---------------------------------------------------------------------------

def _matrices(params, art, hs, P=1):
    """(report key, g, expert, W (K, N), H, port leaf, artifact leaf);
    P is the pattern length (layer j = g * P + slot)."""
    for (g, pstr), (path, _, leaf, H) in sorted(hs.items()):
        j = g * P + int(path[0][1:])
        mine, theirs = params["layers"][j], art["layers"][j]
        for k in path[1:]:
            mine, theirs = mine[k], theirs[k]
        if leaf.dim() == 3:
            for e in range(leaf.shape[0]):
                yield pstr, g, e, leaf[e], H[e], mine, theirs
        else:
            yield pstr, g, None, leaf, H, mine, theirs


def _part(qt, e):
    """(codes, alphas fp32, betas fp32, dequantized (K, N)) of a leaf or
    one expert of a stack."""
    codes, a, b = qt.codes, qt.alphas.float(), qt.betas.float()
    w = qt.dequant("float32")
    if e is not None:
        codes, a, b, w = codes[e], a[e], b[e], w[e]
    return codes, a, b, w


@pytest.mark.parametrize("name", list(ARTIFACTS))
def test_quantize_model_reproduces_committed_artifact(models, name):
    arch, gs = ARTIFACTS[name]
    cfg = _cfg(arch)
    _, params, calib = models[arch]
    art, aspec, _ = load_packed(FIXTURE / name, device="cpu")
    spec = QuantSpec.from_config(cfg.quant, method="gptqt", mode="packed",
                                 group_size=gs)
    assert spec.to_dict() == aspec
    qp, report = quantize_model(cfg, params, calib, spec=spec, device="cpu")
    hs = collect_hessians(cfg, params, calib, spec=spec, device="cpu")
    _hold_to_artifact(name, qp, report, hs, art, gs, name.endswith("bf16"))


def _hold_to_artifact(name, qp, report, hs, art, gs, bf16, P=1, bits=3):
    """The port's quantization `qp` against the artifact's, matrix by
    matrix: equal codes and scales except on rows the port's own record
    shows a near-tie, and the per-leaf output errors within the stated
    tolerances."""
    assert set(report) == {k for _, k in hs}
    n_rows = n_pick = n_level = 0
    errs: dict = {}
    for pstr, g, e, W, H, mine, theirs in _matrices(qp, art, hs, P):
        assert mine.orig_dtype == theirs.orig_dtype == "float32"
        assert mine.codes.shape == theirs.codes.shape
        c1, a1, b1, w1 = _part(mine.cast_scales("bfloat16") if bf16
                               else mine, e)
        c2, a2, b2, w2 = _part(theirs, e)
        N, K = W.shape[1], W.shape[0]
        n_rows += N
        rtol = SCALE_RTOL["bfloat16" if bf16 else None]
        scale_diff = (((a1 - a2).abs() > rtol * a2.abs()).any(-1)
                      | ((b1 - b2).abs() > rtol * b2.abs().max())).any(0)
        code_diff = (unpack_signs(c1, K) != unpack_signs(c2, K)).any(0).T
        Wt = W.float().T
        e1, e2 = output_error(Wt, w1.T, H), output_error(Wt, w2.T, H)
        errs.setdefault(pstr, []).append(
            (output_error(Wt, _part(mine, e)[3].T, H), e1, e2))
        if not (scale_diff.any() or code_diff.any()):
            continue
        # explain from the port's own record of its picks
        res = gptqt_quantize(Wt, H, bits=bits, group_size=gs,
                             orig_dtype="float32", margins=True)
        assert torch.equal(res.qt.codes, mine.codes if e is None
                           else mine.codes[e])
        pick_tie = ((res.choice_margin < CHOICE_TIE_RTOL)
                    | (res.mult_margin < MULT_TIE_RTOL)).reshape(N, -1).any(1)
        assert not (scale_diff & ~pick_tie).any(), \
            f"{pstr}: scales differ without a near-tie"
        Hd, _ = damp(H)
        order = torch.argsort(-torch.diagonal(Hd), stable=True)
        lv = res.levels.reshape(N, -1, 8)
        span = torch.repeat_interleave(lv.amax(-1) - lv.amin(-1),
                                       K // lv.shape[1], dim=1)
        for r in torch.nonzero((code_diff.any(1) & ~scale_diff)).flatten():
            c = order[torch.nonzero(code_diff[r, order])[0, 0]]
            assert res.level_margin[r, c] < LEVEL_TIE_RTOL * span[r, c], \
                f"{pstr} row {int(r)}: codes differ without a near-tie"
            n_level += 1
        n_pick += int(scale_diff.sum())
        same = ~(code_diff.any(1) | scale_diff)
        s1 = output_error(Wt[same], w1.T[same], H)
        s2 = output_error(Wt[same], w2.T[same], H)
        assert abs(s1 - s2) <= SAME_ROWS_ERR_RTOL * s2, (pstr, s1, s2)
    for pstr, rows in errs.items():
        own, mine, theirs = (float(np.mean(c)) for c in zip(*rows))
        assert abs(report[pstr]["err"] - own) <= 1e-6 * own
        assert abs(mine - theirs) <= LEAF_ERR_RTOL * theirs, pstr
    print(f"{name}: {n_rows} rows, {n_pick} differ at a choice/multiplier "
          f"near-tie, {n_level} at a level near-tie")
    assert n_pick + n_level <= 0.02 * n_rows


@pytest.mark.parametrize("name", ["mla_quant", "mamba-mix_quant"])
def test_quantize_model_reproduces_zoo_artifact(name):
    """MLA (minicpm3-4b smoke, w3) and the hybrid Mamba + MoE pattern
    (jamba smoke, w4), quantized by the port from the reference's
    init_params and calibration, against the reference's quantization
    of the same (tests/data/torch_port/zoo/, make_fixture.py --zoo).
    As in the reference, conv_w, A_log and x_proj (the config's
    exclude) stay fp and dt_w is packed: the exclude's "dt_proj" names
    no leaf."""
    from test_torch_model_zoo_serve import DOC, ZOO, artifact
    from torch_zoo import calibration
    cfg, fp = artifact(name.replace("_quant", "_fp"))
    cfg = artifact(name)[0]
    art, aspec, _ = load_packed(ZOO / name, device="cpu")
    spec = QuantSpec.from_config(cfg.quant, method="gptqt", mode="packed")
    assert spec.to_dict() == aspec
    calib = calibration(cfg.vocab_size)
    qp, report = quantize_model(cfg, fp, calib, spec=spec, device="cpu")
    hs = collect_hessians(cfg, fp, calib, spec=spec, device="cpu")
    _hold_to_artifact(name, qp, report, hs, art, 0, False, len(cfg.pattern),
                      cfg.quant.bits)
    for j, spec_j in enumerate(cfg.layer_specs()):
        if spec_j.kind == "mamba":
            m = qp["layers"][j]["mamba"]
            assert hasattr(m["dt_w"], "codes") and hasattr(m["in_proj"],
                                                           "codes")
            for leaf in ("conv_w", "A_log", "x_proj", "dt_b", "D"):
                assert torch.is_tensor(m[leaf]) and torch.equal(
                    m[leaf], fp["layers"][j]["mamba"][leaf])
        elif cfg.mla is not None:
            a = qp["layers"][j]["attn"]
            assert all(hasattr(a[w], "codes") for w in
                       ("wq_a", "wq_b", "wkv_a", "wkv_b", "wo"))
            assert torch.is_tensor(a["q_a_norm"])
    assert DOC["artifacts"][name]["bits"] == cfg.quant.bits


def test_quantize_model_modes_and_refusals(models):
    _, params, calib = models["tiny-lm"]
    cfg = _cfg("tiny-lm")
    qf, rep = quantize_model(cfg, params, calib, spec=QuantSpec(
        method="rtn", overrides=(OverrideRule("wo", skip=True),)),
        device="cpu")
    assert qf["layers"][0]["attn"]["wq"].dtype == torch.float32
    assert qf["layers"][0]["attn"]["wo"] is params["layers"][0]["attn"]["wo"]
    assert "['L0']['attn']['wo']" not in rep
    with pytest.raises(ValueError, match="packed"):
        quantize_model(cfg, params, calib,
                       spec=QuantSpec(method="gptq", mode="packed"),
                       device="cpu")
    with pytest.raises(ValueError, match="group_size"):
        quantize_model(cfg, params, calib, spec=QuantSpec(group_size=48),
                       device="cpu")
    with pytest.raises(ValueError, match="live on"):
        quantize_model(cfg, params, calib, device="meta")


# ---------------------------------------------------------------------------
# sensitivity search
# ---------------------------------------------------------------------------

def test_sensitivity_sweep_and_suggestions_match_reference(models):
    p, params, calib = models["tiny-lm"]
    got = tsearch.sensitivity_sweep(_cfg("tiny-lm"), params, calib,
                                    device="cpu")
    want = jsearch.sensitivity_sweep(_jax_cfg("tiny-lm"), p,
                                     [jnp.asarray(c) for c in calib])
    assert [s.path for s in got] == [s.path for s in want]
    for a, b in zip(got, want):
        assert a.params == b.params
        for bits in b.err:
            assert abs(a.err[bits] - b.err[bits]) <= 1e-4 * b.err[bits]
    for kw in (dict(bump_frac=0.25), dict(bytes_budget=200_000),
               dict(bytes_budget=0)):
        rules = tsearch.suggest_overrides(got, base_bits=3, **kw)
        jrules = jsearch.suggest_overrides(want, base_bits=3, **kw)
        assert [vars(r) for r in rules] == [vars(r) for r in jrules]
    assert tsearch.format_overrides(rules) == jsearch.format_overrides(jrules)
    assert tsearch.format_report(got).splitlines()[0] == \
        jsearch.format_report(want).splitlines()[0]
    assert tsearch.bump_cost_bytes(got[0], 3, 4) == \
        jsearch.bump_cost_bytes(want[0], 3, 4)
