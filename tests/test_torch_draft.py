"""The port's draft views (src/repro_torch/quant/draft.py) and the v4
draft block of its packed artifacts (ckpt/packed.py: save_packed(
draft_bits=), load_draft_scales) against the reference's, on
numpy-seeded QuantizedTensors and the committed fixture artifacts
(tests/data/torch_port/).

Tolerances: re-fit alphas and betas within 1e-5 x max|alpha| of the
reference's (fp32 sums of up to K products in another order, then a
small solve); stored draft arrays the same, relative to each array's
max; everything else (codes, manifests, dense leaves, arrays read back)
bit for bit.

Where a scale group holds no more rows than the draft has columns
(gs <= d, the sign matrix [S' 1] of a group has a null space), the
re-fit system is singular but for its 1e-6 ridge. Its solution along
that null space is rounding amplified by 1e6, and each package's LU
(LAPACK's, in two builds) resolves it differently: the alphas there
differ by up to ~0.2 x max|alpha| between the packages, while the draft
weight S' a' + b' 1 they reconstruct agrees to ~1e-7. Those cases hold
the reconstructed weight within 1e-5 x max|W| instead of the alphas.
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
from repro.quant import QuantizedTensor as JaxQT
from repro.quant import draft as jdraft
from repro_torch.ckpt import (load_draft_scales, load_packed,
                              params_from_tree, save_packed)
from repro_torch.configs import get_config
from repro_torch.quant import (QuantizedTensor, codes_from_numpy,
                               draft_extra_bytes, draft_view,
                               make_draft_params, refit_draft_scales)
from torch_threads import one_torch_thread  # noqa: F401

from test_torch_ckpt import FIXTURE, _bits, _flat_port, _jbits

TOL = 1e-5
# one compilation a case instead of one a jnp op
_jax_refit = jax.jit(jdraft.refit_draft_scales, static_argnums=1)

# (bits, draft bits, K, N, groups, expert stack, scale dtype)
REFIT_CASES = {
    "w3-d1-pc": (3, 1, 128, 16, 1, None, "float32"),
    "w3-d2-pc": (3, 2, 128, 16, 1, None, "float32"),
    "w3-d3-pc": (3, 3, 128, 16, 1, None, "float32"),
    "w4-d1-pc": (4, 1, 128, 16, 1, None, "float32"),
    "w4-d2-pc": (4, 2, 128, 16, 1, None, "float32"),
    "w4-d3-pc": (4, 3, 128, 16, 1, None, "float32"),
    "w3-d2-g32": (3, 2, 128, 16, 4, None, "float32"),
    "w4-d3-g16": (4, 3, 128, 16, 8, None, "float32"),
    "w3-d2-experts": (3, 2, 128, 16, 4, 3, "float32"),
    "w3-d2-g32-bf16": (3, 2, 128, 16, 4, None, "bfloat16"),
    "w4-d3-pc-bf16": (4, 3, 128, 16, 1, None, "bfloat16"),
}
# groups of gs <= d rows: singular but for the ridge (module docstring)
RIDGE_CASES = {
    "w3-d2-gs2": (3, 2, 128, 16, 64, None, "float32"),
    "w3-d3-gs2": (3, 3, 128, 16, 64, None, "float32"),
    "w3-d3-gs3": (3, 3, 96, 16, 32, None, "float32"),
    "w4-d3-gs2-experts": (4, 3, 128, 16, 64, 2, "float32"),
}


def _qts(case, seed):
    """The same seeded packed weight in both packages."""
    bits, _, K, N, G, E, sdt = case
    rng = np.random.default_rng(seed)
    lead = () if E is None else (E,)
    codes = rng.integers(0, 2 ** 32, (*lead, bits, -(-K // 32), N),
                         dtype=np.uint64).astype(np.uint32)
    base = np.array([4.0, 2.0, 1.0, 0.5][:bits], np.float32)
    alphas = ((rng.random((*lead, G, N, bits)) + 0.5) * base) \
        .astype(np.float32)
    betas = (rng.standard_normal((*lead, G, N)) * 0.1).astype(np.float32)
    ja, jb = jnp.asarray(alphas), jnp.asarray(betas)
    ta, tb = torch.from_numpy(alphas), torch.from_numpy(betas)
    if sdt == "bfloat16":
        ja, jb = ja.astype(jnp.bfloat16), jb.astype(jnp.bfloat16)
        ta, tb = ta.bfloat16(), tb.bfloat16()
    jq = JaxQT(codes=jnp.asarray(codes), alphas=ja, betas=jb, k_in=K,
               orig_dtype="float32")
    tq = QuantizedTensor(codes_from_numpy(codes), ta, tb, K, "float32")
    return jq, tq


@pytest.mark.parametrize("cid", sorted(REFIT_CASES))
def test_refit_matches_reference(cid):
    case = REFIT_CASES[cid]
    jq, tq = _qts(case, seed=len(cid))
    d = case[1]
    ja, jb = (np.asarray(a) for a in _jax_refit(jq, d))
    ta, tb = refit_draft_scales(tq, d)
    assert ta.dtype == tb.dtype == torch.float32
    assert tuple(ta.shape) == ja.shape and tuple(tb.shape) == jb.shape
    atol = TOL * np.abs(ja).max()
    np.testing.assert_allclose(ta.numpy(), ja, rtol=0, atol=atol)
    np.testing.assert_allclose(tb.numpy(), jb, rtol=0, atol=atol)


@pytest.mark.parametrize("cid", sorted(RIDGE_CASES))
def test_refit_on_ridge_groups_reconstructs_the_reference_draft(cid):
    case = RIDGE_CASES[cid]
    jq, tq = _qts(case, seed=len(cid))
    d = case[1]
    ta, tb = refit_draft_scales(tq, d)
    assert bool(torch.isfinite(ta).all() and torch.isfinite(tb).all())
    want = np.asarray(jdraft.draft_view(jq, d).dequant(jnp.float32))
    got = draft_view(tq, d).dequant(torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max())


def test_stacked_refit_equals_each_matrix_alone():
    """A stack is refit matrix by matrix: bit for bit each matrix's own
    refit (what lets a saved draft block equal a refit after load)."""
    _, tq = _qts(REFIT_CASES["w3-d2-experts"], seed=5)
    a, b = refit_draft_scales(tq, 2)
    for e in range(tq.codes.shape[0]):
        one = QuantizedTensor(tq.codes[e], tq.alphas[e], tq.betas[e],
                              tq.k_in, tq.orig_dtype)
        ae, be = refit_draft_scales(one, 2)
        assert torch.equal(a[e], ae) and torch.equal(b[e], be)


def test_draft_view_identity_refusal_aliasing():
    _, tq = _qts(REFIT_CASES["w3-d2-g32-bf16"], seed=1)
    assert draft_view(tq, 3) is tq
    with pytest.raises(ValueError, match="exceeds"):
        draft_view(tq, 4)
    with pytest.raises(ValueError, match="draft_bits"):
        refit_draft_scales(tq, 0)
    dv = draft_view(tq, 2)
    assert dv.codes is tq.codes and dv.bits == 2 and dv.stored_bits == 3
    assert dv.alphas.dtype == dv.betas.dtype == torch.bfloat16
    a, b = refit_draft_scales(tq, 2)
    assert torch.equal(dv.alphas, a.bfloat16())
    assert torch.equal(dv.betas, b.bfloat16())
    # installed scales: cast to the target's dtype, codes still shared
    given = draft_view(tq, 2, scales=(a * 2, b))
    assert given.codes is tq.codes
    assert torch.equal(given.alphas, (a * 2).bfloat16())
    # d == bits with given scales is a re-scaled view, not the target
    full = draft_view(tq, 3, scales=refit_draft_scales(tq, 3))
    assert full is not tq and full.codes is tq.codes


@pytest.fixture(scope="module")
def fixture_params():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        params, spec, meta = load_packed(FIXTURE / "w3_pc", device="cpu")
        yield params, spec, meta
    finally:
        torch.set_num_threads(threads)


def _qt_leaves(tree):
    return {p: v for p, v in _flat_port(tree).items()
            if isinstance(v, QuantizedTensor)}


def _scale_bytes(tree):
    return sum(t.numel() * t.element_size()
               for q in _qt_leaves(tree).values() for t in (q.alphas, q.betas))


def test_make_draft_params_shares_leaves_and_falls_back(fixture_params):
    params, _, _ = fixture_params
    draft = make_draft_params(params, 2)
    flat_t, flat_d = _flat_port(params), _flat_port(draft)
    assert flat_t.keys() == flat_d.keys()
    for path, leaf in flat_t.items():
        if isinstance(leaf, QuantizedTensor):
            assert flat_d[path].codes is leaf.codes
            assert flat_d[path].bits == 2
        else:
            assert flat_d[path] is leaf, path
    # a scales tree whose bits disagree is ignored (the refit is used),
    # one whose bits agree is installed
    qt_paths = list(_qt_leaves(params))
    tree = {"layers": [{g: {n: {"bits": 1, "alphas": None, "betas": None}
                            for n in layer[g]
                            if isinstance(layer[g][n], QuantizedTensor)}
                        for g in ("attn", "mlp")}
                       for layer in params["layers"]]}
    mismatched = _qt_leaves(make_draft_params(params, 2, tree))
    for path in qt_paths:
        assert torch.equal(mismatched[path].alphas,
                           _qt_leaves(draft)[path].alphas)
    for layer in tree["layers"]:
        for grp in layer.values():
            for ent in grp.values():
                ent.update(bits=2, alphas=torch.ones(1, 1, 2),
                           betas=torch.zeros(1, 1))
    with pytest.raises(ValueError):       # installed: shapes now checked
        make_draft_params(params, 2, tree)


def test_draft_extra_bytes_counts_storage(fixture_params):
    params, _, _ = fixture_params
    draft = make_draft_params(params, 2)
    assert draft_extra_bytes(params, draft) == _scale_bytes(draft) > 0
    assert draft_extra_bytes(params, params) == 0
    assert draft_extra_bytes(params, make_draft_params(params, 3)) == 0
    # a draft whose codes were copied pays for them
    path, leaf = next(iter(_qt_leaves(draft).items()))
    copied = QuantizedTensor(leaf.codes.clone(), leaf.alphas, leaf.betas,
                             leaf.k_in, leaf.orig_dtype)
    layer, grp, name = path[1], path[2], path[3]
    draft["layers"][layer][grp][name] = copied
    assert draft_extra_bytes(params, draft) == _scale_bytes(draft) \
        + leaf.codes.numel() * 4


# ---------------------------------------------------------------------------
# the v4 draft block
# ---------------------------------------------------------------------------

def _cfg(meta, params):
    return get_config(meta["arch"]).replace(dtype="float32",
                                            n_layers=len(params["layers"]))


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Each fixture artifact saved with draft_bits=2 by the reference
    and by the port (from the same loaded params)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {}
        for name in ("w3_pc", "w3_g64_bf16"):
            root = tmp_path_factory.mktemp(name)
            jp, jspec, jmeta = jax_load_packed(FIXTURE / name)
            jd = jax_save_packed(root / "ref", jp, spec=jspec, meta=jmeta,
                                 draft_bits=2)
            params, spec, meta = load_packed(FIXTURE / name, device="cpu")
            td = save_packed(root / "port", params, cfg=_cfg(meta, params),
                             spec=spec, meta=meta, draft_bits=2)
            out[name] = (jd, td)
        yield out
    finally:
        torch.set_num_threads(threads)


def _draft_keys(node, out):
    if isinstance(node, dict):
        if "draft" in node:
            out.update((node["draft"]["alphas"], node["draft"]["betas"]))
        for v in node.values():
            _draft_keys(v, out)
    return out


def _floats(a):
    """A stored scale array as fp32 (bf16 arrive as uint16 bits)."""
    if a.dtype == np.uint16:
        return (a.astype(np.uint32) << 16).view(np.float32)
    return a


@pytest.mark.parametrize("name", ["w3_pc", "w3_g64_bf16"])
def test_save_packed_draft_block_matches_reference(artifacts, name):
    jd, td = artifacts[name]
    want = json.loads((jd / "manifest.json").read_text())
    got = json.loads((td / "manifest.json").read_text())
    assert got == want and got["draft_bits"] == 2
    assert got["tree"]["blocks"]["L0"]["attn"]["wq"]["draft"]["bits"] == 2
    keys = _draft_keys(want["tree"], set())
    assert keys
    with np.load(jd / "arrays.npz") as a, np.load(td / "arrays.npz") as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            if k in keys:
                w, g = _floats(a[k]), _floats(b[k])
                np.testing.assert_allclose(g, w, rtol=0,
                                           atol=TOL * np.abs(w).max())
            else:
                assert a[k].tobytes() == b[k].tobytes(), k


def _flat_draft_ref(tree):
    """The reference's draft tree ({"blocks": stacked}) at the port's
    per-layer paths, one numpy slice a layer."""
    out = {}
    blocks = tree["blocks"]
    P = len(blocks)

    def walk(node, path, g):
        if isinstance(node, dict) and "alphas" not in node:
            for k, v in node.items():
                walk(v, path + (k,), g)
        elif node is not None:
            out[path] = (node["bits"], np.asarray(node["alphas"])[g],
                         np.asarray(node["betas"])[g])
    for i in range(P):
        n_groups = next(np.asarray(v["alphas"]).shape[0]
                        for v in jax.tree.leaves(
                            blocks[f"L{i}"],
                            is_leaf=lambda x: isinstance(x, dict)
                            and "alphas" in x)
                        if isinstance(v, dict))
        for g in range(n_groups):
            walk(blocks[f"L{i}"], ("layers", g * P + i), g)
    return out


def _flat_draft_port(tree):
    out = {}

    def walk(node, path):
        if isinstance(node, dict) and "alphas" not in node:
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        elif node is not None:
            out[path] = (node["bits"], node["alphas"], node["betas"])
    walk(tree, ())
    return out


@pytest.mark.parametrize("name", ["w3_pc", "w3_g64_bf16"])
def test_load_draft_scales_reads_both_packages_bit_for_bit(artifacts, name):
    for d in artifacts[name]:
        want = _flat_draft_ref(jax_load_draft_scales(d))
        got = _flat_draft_port(load_draft_scales(d, device="cpu"))
        assert got.keys() == want.keys() and len(got) == 14
        for path, (bits, a, b) in want.items():
            gbits, ga, gb = got[path]
            assert gbits == bits == 2
            np.testing.assert_array_equal(_bits(ga), _jbits(a))
            np.testing.assert_array_equal(_bits(gb), _jbits(b))


def test_params_from_tree_carries_a_reference_draft_tree(artifacts):
    """A reference draft tree (leaves with fewer alphas than code
    planes; here from the reference's own draft block) crosses over
    leaf for leaf, bit for bit."""
    jd, _ = artifacts["w3_g64_bf16"]
    ref, _, _ = jax_load_packed(jd)
    jtree = jdraft.make_draft_params(ref, 2, jax_load_draft_scales(jd))
    draft = params_from_tree(jtree, device="cpu")
    leaves = _qt_leaves(draft)
    assert len(leaves) == 14 and all(q.bits == 2 and q.stored_bits == 3
                                     for q in leaves.values())
    blocks = jtree["blocks"]
    P = len(blocks)
    for (_, layer, grp, name), q in leaves.items():
        want = blocks[f"L{layer % P}"][grp][name]
        assert q.alphas.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            _bits(q.alphas), _jbits(np.asarray(want.alphas)[layer // P]))
        np.testing.assert_array_equal(
            _bits(q.betas), _jbits(np.asarray(want.betas)[layer // P]))


def test_block_draft_equals_refit_draft(artifacts):
    _, td = artifacts["w3_pc"]
    params, _, _ = load_packed(td, device="cpu")
    tree = load_draft_scales(td, device="cpu")
    from_block = _qt_leaves(make_draft_params(params, 2, tree))
    refit = _qt_leaves(make_draft_params(params, 2))
    assert from_block.keys() == refit.keys()
    for path, q in from_block.items():
        assert q.codes is refit[path].codes and q.bits == 2
        assert torch.equal(q.alphas, refit[path].alphas), path
        assert torch.equal(q.betas, refit[path].betas), path
    assert load_draft_scales(FIXTURE / "w3_pc", device="cpu") is None

