"""The port's `save_packed` (src/repro_torch/ckpt/packed.py) against the
reference's format, both directions:

- each committed artifact (tests/data/torch_port/, written by the JAX
  package), loaded by the port and saved again by the port, gives the
  same manifest.json (parsed) and byte-equal arrays.npz members;
- an artifact the port quantized and saved loads in the reference's
  load_packed leaf for leaf, bit for bit, and the reference's model
  functions give logits within LOGITS_RTOL x max|logit| of the port's
  on the fixture's prompts.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt.packed import load_packed as jax_load_packed
from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.models import model as jmodel
from repro_torch.ckpt import load_packed, params_from_tree, save_packed
from repro_torch.ckpt.pspec import named_pspec
from repro_torch.configs import get_config
from repro_torch.core import quantize_model
from repro_torch.models import model as tmodel
from repro_torch.quant import QuantSpec
from torch_threads import one_torch_thread  # noqa: F401

from test_torch_ckpt import ARTIFACTS, FIXTURE, assert_same_tree

KEY = jax.random.PRNGKey(0)
LOGITS_RTOL = 1e-4
REFERENCE = json.loads((FIXTURE / "reference.json").read_text())


def _cfg(arch, jax_cfg=False):
    get = jax_get_config if jax_cfg else get_config
    return get(arch).replace(dtype="float32", n_layers=2)


@pytest.mark.parametrize("name", ARTIFACTS)
def test_load_then_save_rewrites_the_committed_artifact(tmp_path, name):
    params, spec, meta = load_packed(FIXTURE / name, device="cpu")
    out = save_packed(tmp_path / name, params, cfg=_cfg(meta["arch"]),
                      spec=spec, meta=meta)
    assert (out / "COMMITTED").read_text() == "4"
    assert not (tmp_path / f"{name}.tmp").exists()
    want = json.loads((FIXTURE / name / "manifest.json").read_text())
    assert json.loads((out / "manifest.json").read_text()) == want
    with np.load(out / "arrays.npz") as a, \
            np.load(FIXTURE / name / "arrays.npz") as b:
        assert a.files == b.files
        for k in b.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            assert a[k].tobytes() == b[k].tobytes(), k


def test_save_refusals_and_overwrite(tmp_path):
    params, spec, meta = load_packed(FIXTURE / "w3_pc", device="cpu")
    cfg = _cfg("tiny-lm")
    with pytest.raises(ValueError, match="draft_bits"):
        save_packed(tmp_path / "a", params, cfg=cfg, draft_bits=0)
    # draft_bits=2 writes the v4 draft block on every quantized leaf
    d = save_packed(tmp_path / "d", params, cfg=cfg, spec=spec, meta=meta,
                    draft_bits=2)
    manifest = json.loads((d / "manifest.json").read_text())
    assert manifest["format_version"] == 4 and manifest["draft_bits"] == 2
    drafts = [leaf["draft"] for blk in manifest["tree"]["blocks"].values()
              for grp in ("attn", "mlp") for leaf in blk[grp].values()]
    assert len(drafts) == 7 and all(x["bits"] == 2 for x in drafts)
    with pytest.raises(ValueError):
        save_packed(tmp_path / "a", params, cfg=cfg, scale_dtype="float16")
    with pytest.raises(TypeError, match="cfg"):
        save_packed(tmp_path / "a", params)
    with pytest.raises(ValueError, match="layers"):
        save_packed(tmp_path / "a", params, cfg=cfg.replace(n_layers=4))
    save_packed(tmp_path / "a", params, cfg=cfg, spec=spec, meta=meta)
    (tmp_path / "a" / "stale").write_text("x")
    save_packed(tmp_path / "a", params, cfg=cfg, spec=spec, meta=meta,
                scale_dtype="bfloat16")                 # replaces the dir
    assert not (tmp_path / "a" / "stale").exists()
    bf, _, _ = load_packed(tmp_path / "a", device="cpu")
    qt = bf["layers"][1]["mlp"]["wd"]
    assert qt.alphas.dtype == torch.bfloat16
    ref = params["layers"][1]["mlp"]["wd"].alphas
    assert torch.equal(qt.alphas, ref.to(torch.bfloat16))


def test_symbolic_pspecs_follow_the_reference_rule():
    """A few cases of the rule beyond the committed artifacts' leaves."""
    from repro.dist import sharding
    mesh = sharding.symbolic_mesh()
    for names, shape in [(("lm_head",), (8, 16)),
                         (("blocks", "L0", "moe", "router"), (2, 8, 4)),
                         (("blocks", "L0", "moe", "wd", ".codes"),
                          (2, 4, 3, 1, 8)),
                         (("blocks", "L0", "attn", "wo", ".alphas"),
                          (2, 1, 8, 3)),
                         (("blocks", "L0", "ln"), (2, 8))]:
        leaf = jnp.zeros(shape)
        assert list(named_pspec(names, shape)) == list(
            sharding.named_pspec(None, list(names), leaf, mesh))


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    """Artifacts the port quantized (fixture weights and calibration,
    carried across from the reference) and saved. A module fixture runs
    before the per-test one-thread fixture, so it sets the thread count
    itself."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield _write(tmp_path_factory)
    finally:
        torch.set_num_threads(threads)


def _write(tmp_path_factory):
    out = {}
    for name, arch, kw, scale_dtype in [
            ("pc", "tiny-lm", dict(method="gptqt"), None),
            ("g64_bf16", "tiny-lm", dict(method="bcq", group_size=64),
             "bfloat16"),
            ("moe", "tiny-moe", dict(method="gptqt"), None)]:
        cfg = _cfg(arch)
        p = jax_init_params(_cfg(arch, True), KEY)
        calib = [np.array(jax.random.randint(jax.random.fold_in(KEY, i),
                                             (2, 48), 0, cfg.vocab_size))
                 for i in range(2)]
        spec = QuantSpec.from_config(cfg.quant, mode="packed", **kw)
        qp, _ = quantize_model(cfg, params_from_tree(
            jax.tree.map(np.asarray, p), device="cpu"), calib, spec=spec,
            device="cpu")
        d = save_packed(tmp_path_factory.mktemp("port") / name, qp, cfg=cfg,
                        spec=spec, meta={"arch": arch, "n_layers": 2},
                        scale_dtype=scale_dtype)
        out[name] = (arch, d)
    return out


@pytest.mark.parametrize("name", ["pc", "g64_bf16", "moe"])
def test_port_written_artifact_serves_in_the_reference(written, name):
    arch, d = written[name]
    ref_tree, ref_spec, meta = jax_load_packed(d)
    params, spec, _ = load_packed(d, device="cpu")
    assert ref_spec.to_dict() == spec and meta["arch"] == arch
    assert_same_tree(params, ref_tree)
    jcfg, cfg = _cfg(arch, True), _cfg(arch)
    prompts = REFERENCE["artifacts"]["w3_moe" if arch == "tiny-moe"
                                     else "w3_pc"]["prompts"]
    for prompt in prompts:
        toks = np.asarray(prompt, np.int32)[None]
        want, _ = jmodel.prefill(jcfg, ref_tree, jnp.asarray(toks), len(prompt))
        got, _ = tmodel.prefill(cfg, params, torch.from_numpy(toks),
                                len(prompt))
        want = np.asarray(want, np.float64)
        np.testing.assert_allclose(got.double().numpy(), want, rtol=0,
                                   atol=LOGITS_RTOL * np.abs(want).max())


def test_launcher_serves_a_port_written_artifact(written, capsys):
    from repro_torch.launch.serve import main as launch_main
    _, d = written["pc"]
    eng, reqs = launch_main(["--load-quantized", str(d), "--device", "cpu",
                             "--cache", "paged", "--requests", "2",
                             "--max-new", "4"])
    assert len(reqs) == 2 and all(len(r.out) == 4 for r in reqs)
    assert "gptqt w3" in capsys.readouterr().out
