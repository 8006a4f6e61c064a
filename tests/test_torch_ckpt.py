"""The port's packed-artifact loader (repro_torch/ckpt/packed.py) against
the reference's `load_packed` on the committed fixture artifacts
(tests/data/torch_port/, written by the JAX package), leaf for leaf and
bit for bit; manifest versions v1-v4; refusals; the weight-carrying
function; and the fixture's own reproducibility."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.packed import load_packed as jax_load_packed
from repro.configs import get_config
from repro.models import init_params as jax_init_params
from repro.quant import QuantizedTensor as JaxQT
from repro_torch.ckpt import load_packed, params_from_tree
from repro_torch.quant import QuantizedTensor, codes_to_numpy

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "data" / "torch_port"
ARTIFACTS = ["w3_pc", "w3_g64_bf16", "w3_moe"]   # w3_moe: expert stacks


def _bits(t: torch.Tensor) -> np.ndarray:
    """Raw bits of a tensor (bf16 as uint16) for bit-exact comparison."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _flat_port(params):
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path + (i,))
        else:
            out[path] = node
    walk(params, ())
    return out


def _flat_ref(tree):
    """Reference tree -> the port's per-layer paths, slicing the
    (n_groups, ...) block stacks with numpy."""
    out = {}
    blocks = tree.get("blocks", {})
    P = len(blocks)

    def walk(node, path, g=None, i=None):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,), g, i)
            return
        if g is not None:
            node = (JaxQT(np.asarray(node.codes)[g], np.asarray(node.alphas)[g],
                          np.asarray(node.betas)[g], node.k_in,
                          node.orig_dtype)
                    if isinstance(node, JaxQT) else np.asarray(node)[g])
        out[path] = node
    for k, v in tree.items():
        if k == "blocks":
            continue
        walk(v, (k,))
    for i in range(P):
        blk = blocks[f"L{i}"]
        probe = jax.tree.leaves(blk)[0]
        for g in range(probe.shape[0]):
            walk(blk, ("layers", g * P + i), g, i)
    return out


def assert_same_tree(port_params, ref_tree):
    fp, fr = _flat_port(port_params), _flat_ref(ref_tree)
    assert sorted(fp, key=str) == sorted(fr, key=str)
    for path, want in fr.items():
        got = fp[path]
        if isinstance(want, JaxQT):
            assert isinstance(got, QuantizedTensor), path
            assert (got.k_in, got.orig_dtype) == (want.k_in, want.orig_dtype)
            np.testing.assert_array_equal(codes_to_numpy(got.codes),
                                          np.asarray(want.codes))
            for f in ("alphas", "betas"):
                a, b = getattr(got, f), np.asarray(getattr(want, f))
                assert str(a.dtype).removeprefix("torch.") == b.dtype.name
                np.testing.assert_array_equal(_bits(a), _jbits(b))
        else:
            want = np.asarray(want)
            assert str(got.dtype).removeprefix("torch.") == want.dtype.name
            np.testing.assert_array_equal(_bits(got), _jbits(want))


@pytest.mark.parametrize("name", ARTIFACTS)
def test_load_packed_matches_reference_bit_for_bit(name):
    ref_tree, ref_spec, ref_meta = jax_load_packed(FIXTURE / name)
    params, spec, meta = load_packed(FIXTURE / name, device="cpu")
    assert_same_tree(params, ref_tree)
    assert spec == ref_spec.to_dict() and meta == ref_meta
    assert len(params["layers"]) == 2


def test_bf16_scales_load_as_bf16():
    params, spec, _ = load_packed(FIXTURE / "w3_g64_bf16", device="cpu")
    qts = [v for v in _flat_port(params).values()
           if isinstance(v, QuantizedTensor)]
    assert qts and all(q.alphas.dtype == torch.bfloat16
                       and q.betas.dtype == torch.bfloat16 for q in qts)
    assert {q.group_size for q in qts} == {64}
    assert spec["group_size"] == 64
    fp32, _, _ = load_packed(FIXTURE / "w3_pc", device="cpu")
    assert all(q.alphas.dtype == torch.float32
               for q in _flat_port(fp32).values()
               if isinstance(q, QuantizedTensor))


def _copy(tmp_path, name="w3_pc"):
    d = tmp_path / name
    shutil.copytree(FIXTURE / name, d)
    return d


def test_uncommitted_artifact_is_refused(tmp_path):
    d = _copy(tmp_path)
    (d / "COMMITTED").unlink()
    with pytest.raises(FileNotFoundError, match="COMMITTED"):
        load_packed(d, device="cpu")


def test_newer_format_is_refused(tmp_path):
    d = _copy(tmp_path)
    m = json.loads((d / "manifest.json").read_text())
    m["format_version"] = 99
    (d / "manifest.json").write_text(json.dumps(m))
    with pytest.raises(ValueError, match="newer"):
        load_packed(d, device="cpu")


def _strip(node, keys):
    if isinstance(node, dict):
        return {k: _strip(v, keys) for k, v in node.items() if k not in keys}
    return node


@pytest.mark.parametrize("version", [1, 2, 3])
def test_older_manifests_load_like_the_reference(tmp_path, version):
    """v3 adds per-leaf pspecs and the sharding block, v2 the group
    fields: an artifact rewritten as the older format loads the same in
    both packages."""
    d = _copy(tmp_path, "w3_g64_bf16" if version >= 3 else "w3_pc")
    m = json.loads((d / "manifest.json").read_text())
    m["format_version"] = version
    drop = set()
    if version < 3:
        drop |= {"pspec", "sharding"}
    if version < 2:
        drop |= {"groups", "group_size"}
    m = _strip(m, drop)
    (d / "manifest.json").write_text(json.dumps(m))
    ref_tree, _, _ = jax_load_packed(d)
    params, _, _ = load_packed(d, device="cpu")
    assert_same_tree(params, ref_tree)


def test_corrupt_group_count_is_refused(tmp_path):
    d = _copy(tmp_path, "w3_g64_bf16")
    m = json.loads((d / "manifest.json").read_text())
    m["tree"]["blocks"]["L0"]["attn"]["wq"]["groups"] = 7
    (d / "manifest.json").write_text(json.dumps(m))
    with pytest.raises(ValueError, match="corrupt"):
        load_packed(d, device="cpu")


@pytest.mark.parametrize("name", ARTIFACTS)
def test_params_from_tree_equals_load_packed(name):
    """Both load paths end in the same port representation."""
    ref_tree, _, _ = jax_load_packed(FIXTURE / name)
    carried = params_from_tree(ref_tree, device="cpu")
    loaded, _, _ = load_packed(FIXTURE / name, device="cpu")
    assert_same_tree(carried, ref_tree)
    fc, fl = _flat_port(carried), _flat_port(loaded)
    assert fc.keys() == fl.keys()
    for k in fc:
        a, b = fc[k], fl[k]
        if isinstance(a, QuantizedTensor):
            for f in ("codes", "alphas", "betas"):
                assert torch.equal(getattr(a, f), getattr(b, f))
        else:
            assert torch.equal(a, b)


def test_params_from_tree_carries_dense_and_bf16_trees():
    cfg = get_config("tiny-lm-wide").replace(n_layers=2)
    tree = jax_init_params(cfg, jax.random.PRNGKey(3))      # bf16 leaves
    params = params_from_tree(tree, device="cpu")
    assert_same_tree(params, tree)
    assert params["embed"].dtype == torch.bfloat16
    tree32 = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    assert_same_tree(params_from_tree(tree32, device="cpu"), tree32)


def test_entry_points_default_to_cuda():
    """Without device="cpu" the loader targets CUDA: on a machine with no
    GPU that raises instead of silently loading onto the host."""
    if torch.cuda.is_available():
        params, _, _ = load_packed(FIXTURE / "w3_pc")
        assert params["embed"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load_packed(FIXTURE / "w3_pc")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            params_from_tree({"w": np.zeros(3, np.float32)})


def test_fixture_rebuilds_identically(tmp_path):
    """The committed fixture is what its generator writes today: same
    artifacts bit for bit, same prompts and greedy tokens, logits equal
    to the 7 significant digits they are stored with."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(FIXTURE / "make_fixture.py"),
                        str(tmp_path)], env=env, capture_output=True,
                       text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    for name in ARTIFACTS:
        assert (json.loads((tmp_path / name / "manifest.json").read_text())
                == json.loads((FIXTURE / name / "manifest.json").read_text()))
        with np.load(tmp_path / name / "arrays.npz") as a, \
                np.load(FIXTURE / name / "arrays.npz") as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k])
    new = json.loads((tmp_path / "reference.json").read_text())
    old = json.loads((FIXTURE / "reference.json").read_text())
    for name in ARTIFACTS:
        n, o = new["artifacts"][name], old["artifacts"][name]
        assert n["prompts"] == o["prompts"] and n["tokens"] == o["tokens"]
        for key in ("prefill_logits", "decode_logits"):
            np.testing.assert_allclose(np.asarray(n[key]), np.asarray(o[key]),
                                       rtol=1e-6, atol=1e-7)
    for name, o in old["kv_bits"]["artifacts"].items():
        n = new["kv_bits"]["artifacts"][name]
        assert n["prompts"] == o["prompts"] and n["tokens"] == o["tokens"]
        # and the first prompt the quantizer-margin filter dropped
        nt, ot = n["near_tie"], o["near_tie"]
        assert nt["prompt"] == ot["prompt"] and nt["tokens"] == ot["tokens"]
        for a, b in ((n, o), (nt, ot)):
            for key in ("prefill_logits", "decode_logits"):
                np.testing.assert_allclose(np.asarray(a[key]),
                                           np.asarray(b[key]),
                                           rtol=1e-6, atol=1e-7)
    assert new["launcher"]["tokens"] == old["launcher"]["tokens"]
