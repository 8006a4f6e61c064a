"""The port's launchers on the CPU: repro_torch.launch.train (train,
checkpoint, resume; int8 gradient accumulation over microbatches) and
repro_torch.launch.serve's quantize flags on a 2-layer tiny config
trained for a few steps by get_trained_lm (cache redirected to a
temporary directory): --quant with --save-quantized writes an artifact
the reference's load_packed reads, with the values the port's reads,
and that boots again with --load-quantized; --suggest-overrides prints
rules; conflicting flags are refused.
"""
import jax
import numpy as np
import pytest
import torch

from repro.ckpt import CheckpointManager as JaxCheckpointManager
from repro.ckpt.packed import load_packed as jax_load_packed
from repro_torch.ckpt import load_packed, stack_params
from repro_torch.configs import get_config
from repro_torch.data import pretrained
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch
from repro_torch.quant import QuantizedTensor
from repro_torch.tree import keystr, leaves_with_paths
from torch_threads import one_torch_thread  # noqa: F401


def test_train_launcher_checkpoints_and_resumes(tmp_path, capsys):
    argv = ["--arch", "tiny-moe", "--steps", "3", "--batch", "4", "--seq",
            "32", "--microbatches", "2", "--grad-compress", "int8",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2", "--device",
            "cpu"]
    params, opt, losses = train_launch.main(argv)
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert int(opt["step"]) == 3
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000002", "step_00000003"]
    # the reference restores the launcher's checkpoint
    cfg = get_config("tiny-moe").replace(dtype="float32")
    ref_tree = jax.tree.map(lambda t: np.asarray(t.detach()),
                            {"params": params, "opt": opt})
    got, meta = JaxCheckpointManager(tmp_path).restore(ref_tree)
    assert meta["step"] == 3
    want = dict(leaves_with_paths(ref_tree))
    for path, a in leaves_with_paths(jax.tree.map(np.asarray, got)):
        assert np.array_equal(a, want[path]), keystr(path)
    # a second launch resumes at step 3 and has nothing left to run
    _, _, more = train_launch.main(argv)
    assert more == [] and "resumed from step 3" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="item 6"):
        train_launch.main(argv + ["--mesh", "pod"])


def test_serve_launcher_quantizes_saves_and_boots(tmp_path, monkeypatch,
                                                  capsys):
    monkeypatch.setattr(pretrained, "MODELS_DIR", tmp_path / "models")
    out = tmp_path / "tiny-moe-w3"
    common = ["--requests", "2", "--batch-size", "2", "--max-new", "4",
              "--device", "cpu"]
    eng, reqs = serve_launch.main(
        ["--arch", "tiny-moe", "--quant", "3", "--train-steps", "3",
         "--save-quantized", str(out), "--draft-bits", "2"] + common)
    assert all(r.done and len(r.out) == 4 for r in reqs)
    assert (tmp_path / "models" / "tiny-moe-wiki-s3").is_dir()
    text = capsys.readouterr().out
    assert "quantizing with gptqt to 3 bits" in text
    assert "w2 draft scales included" in text
    # the artifact loads in the reference with the port's values
    params, spec, meta = load_packed(out, device="cpu")
    assert meta["arch"] == "tiny-moe" and spec["method"] == "gptqt"
    jp, jspec, jmeta = jax_load_packed(out)
    assert jmeta["arch"] == "tiny-moe" and jspec.bits == 3
    cfg = get_config("tiny-moe").replace(dtype="float32")
    mine = dict(leaves_with_paths(stack_params(cfg, params)))
    ref = dict(leaves_with_paths(jp))
    assert set(map(keystr, mine)) == set(map(keystr, ref))
    n_qt = 0
    for path, leaf in mine.items():
        r = ref[path]
        if isinstance(leaf, QuantizedTensor):
            n_qt += 1
            assert np.array_equal(leaf.alphas.numpy(), np.asarray(r.alphas))
            assert np.array_equal(
                leaf.codes.numpy().view(np.uint32), np.asarray(r.codes))
        else:
            assert np.array_equal(leaf.numpy(), np.asarray(r))
    # the one pattern slot's stacked linears: wq, wk, wv, wo and the
    # expert stacks wg, wu, wd (the router stays fp)
    assert n_qt == 7
    # and boots again as-is, speculatively from its draft block
    eng, reqs = serve_launch.main(["--load-quantized", str(out),
                                   "--speculate", "2"] + common)
    assert all(r.done and len(r.out) == 4 for r in reqs)
    assert "manifest v4 draft block" in capsys.readouterr().out
    # the fp model of the same cache serves too
    eng, reqs = serve_launch.main(["--arch", "tiny-moe", "--train-steps",
                                   "3"] + common)
    assert all(r.done for r in reqs)


def test_serve_launcher_suggests_overrides_and_refuses_conflicts(
        tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(pretrained, "MODELS_DIR", tmp_path)
    rules = serve_launch.main(["--arch", "tiny-moe", "--train-steps", "2",
                               "--suggest-overrides", "--bytes-budget",
                               "20000", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "bytes budget 20000" in text and "OverrideRule" in text
    assert all(r.bits == 4 for r in rules)
    with pytest.raises(SystemExit):
        serve_launch.main(["--save-quantized", str(tmp_path / "x"),
                           "--device", "cpu"])
    with pytest.raises(SystemExit):
        serve_launch.main(["--load-quantized", str(tmp_path), "--quant",
                           "3", "--device", "cpu"])


def test_serve_launcher_spawns_a_mesh(capfd):
    """--mesh 2,2 --devices cpu,cpu,cpu,cpu spawns four gloo ranks over
    the fixture artifact (the batch of 3 rounded up to 4 for the data
    axis); rank 0 alone prints, and every rank holds the single-device
    launcher's tokens. --devices needs --mesh, and --mesh an artifact."""
    from pathlib import Path
    art = str(Path(__file__).resolve().parent / "data" / "torch_port"
              / "w3_pc")
    common = ["--load-quantized", art, "--requests", "3", "--max-new", "4"]
    _, want = serve_launch.main(common + ["--device", "cpu", "--cache",
                                          "paged"])
    capfd.readouterr()
    ranks = serve_launch.main(common + ["--mesh", "2,2", "--devices",
                                        "cpu,cpu,cpu,cpu"])
    assert [r["rank"] for r in ranks] == [0, 1, 2, 3]
    assert all(r["tokens"] == [q.out for q in want] for r in ranks)
    out = capfd.readouterr().out
    assert "mesh (data=2, model=2) backend=gloo devices=cpu,cpu,cpu,cpu" \
        in out
    assert out.count("served 3 requests") == 1
    assert "batch_size rounded 3 -> 4" in out
    for argv in (common + ["--devices", "cpu,cpu"],
                 ["--mesh", "2,1", "--devices", "cpu,cpu"]):
        with pytest.raises(SystemExit):
            serve_launch.main(argv)


def test_serve_launcher_speculates_on_a_mesh(capfd):
    """--speculate 2 with --mesh 1,2: the ranks refit the w2 draft (the
    fixture has no draft block; a row-split leaf on its gathered rows)
    and give the single-device launcher's plain tokens."""
    from pathlib import Path
    art = str(Path(__file__).resolve().parent / "data" / "torch_port"
              / "w3_pc")
    common = ["--load-quantized", art, "--requests", "2", "--max-new", "6",
              "--batch-size", "2"]
    _, want = serve_launch.main(common + ["--device", "cpu", "--cache",
                                          "paged"])
    capfd.readouterr()
    ranks = serve_launch.main(common + ["--mesh", "1,2", "--devices",
                                        "cpu,cpu", "--speculate", "2"])
    assert all(r["tokens"] == [q.out for q in want] for r in ranks)
    out = capfd.readouterr().out
    assert out.count("draft scales: on-the-fly LS re-fit") == 1
    assert "speculation: k=2, w2 draft" in out
