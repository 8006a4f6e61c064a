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
    with pytest.raises(NotImplementedError, match="item 6.2"):
        train_launch.main(argv + ["--mesh", "multipod"])


def test_chip_smoke_train_mesh_phase_rehearses_moe_on_cpu(monkeypatch):
    """Phase 13's MoE and MLA meshes (mixtral-8x7b's and minicpm3-4b's
    plans) in one spawn on the CPU at tiny size, tiny-moe then tiny-mla:
    every check holds, each MoE mesh drops the single device's (token,
    choice) pairs a step beside its aux loss, the noise-floor line is
    tiny-mla's alone (a MoE config's microbatches route apart), and a
    rank holds the specs' blocks but shard_params' of the router and the
    latent projections (whole on the model axis)."""
    import importlib.util
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    monkeypatch.setitem(sys.modules, "chip_smoke", cs)
    monkeypatch.syspath_prepend(str(root))
    monkeypatch.setattr(cs, "DEV", "cpu")
    unmet, rows = [], []
    monkeypatch.setattr(cs, "require",
                        lambda ok, what: ok or unmet.append(what))
    monkeypatch.setattr(cs, "emit", rows.append)
    plans = {a: rest for a, _, *rest in cs.TRAIN_MESH_FAMILIES}
    counts = cs.phase_train_mesh(
        0, "tiny-moe", 2, 4, 32, meshes=plans["mixtral-8x7b"][0],
        others=(("tiny-mla", 2, *plans["minicpm3-4b"]),))
    assert unmet == [] and not any(counts.values())
    assert [r["model"] for r in rows
            if r["check"] == "train_mesh_noise_floor"] == ["tiny-mla"]
    spawn = next(r for r in rows if r["check"] == "train_mesh_spawn")
    assert spawn["stages"] == [["1x2@0"], ["2x2@0"], ["1x2@0"], ["2x2@0"]]
    paths = [r for r in rows if r["check"] == "train_mesh_path"]
    assert [(p["model"], p["mesh"]) for p in paths] == [
        ("tiny-moe", [1, 2]), ("tiny-moe", [2, 2]), ("tiny-mla", [1, 2]),
        ("tiny-mla", [2, 2])]
    assert sum(paths[0]["single_dropped_pairs"]) > 0
    for p in paths:
        assert ("drops_equal" in p) == (p["model"] == "tiny-moe")
        if p["model"] == "tiny-moe":
            assert p["drops_equal"] and len(p["dropped_pairs"]) == 3
        assert p["mu_gate"] == cs.TOL_TRAIN_MESH
        for r in p["ranks"]:
            assert r["held_bytes"] == r["rule_local_bytes"]
            if p["mesh"][1] > 1:      # the whole router or latent
                assert r["held_bytes"] > r["spec_local_bytes"]


def test_train_launcher_trains_moe_on_a_model_axis(tmp_path, capfd):
    """--arch tiny-moe --mesh 1,2 --devices cpu,cpu: two gloo ranks, each
    with 2 of the 4 experts (expert parallelism), whose losses are --mesh
    host's within 1e-5 relative."""
    common = ["--arch", "tiny-moe", "--steps", "2", "--batch", "4",
              "--seq", "32", "--ckpt-every", "100"]
    _, _, want = train_launch.main(common + [
        "--device", "cpu", "--ckpt-dir", str(tmp_path / "host")])
    _, opt, got = train_launch.main(common + [
        "--mesh", "1,2", "--devices", "cpu,cpu", "--ckpt-dir",
        str(tmp_path / "mesh")])
    assert np.allclose(got, want, rtol=1e-5, atol=0), (got, want)
    assert int(opt["step"]) == 2
    assert "mesh (data=1, model=2) backend=gloo devices=cpu,cpu" in \
        capfd.readouterr().out


def test_train_launcher_trains_on_a_mesh(tmp_path, capfd):
    """--mesh 2,1 --devices cpu,cpu spawns two gloo ranks (FSDP on the
    data axis) whose losses are --mesh host's within 1e-5 relative, and
    whose whole trained params (gathered) are the host run's within 1e-5
    x max|p| a leaf (1 + w for a norm scale). --devices needs a mesh."""
    common = ["--arch", "tiny-lm", "--steps", "2", "--batch", "4", "--seq",
              "32", "--ckpt-every", "100"]
    params, _, want = train_launch.main(common + [
        "--device", "cpu", "--ckpt-dir", str(tmp_path / "host")])
    got_params, opt, got = train_launch.main(common + [
        "--mesh", "2,1", "--devices", "cpu,cpu", "--ckpt-dir",
        str(tmp_path / "mesh")])
    assert np.allclose(got, want, rtol=1e-5, atol=0), (got, want)
    assert int(opt["step"]) == 2
    mine = dict(leaves_with_paths(got_params))
    for path, w in leaves_with_paths(params):
        scale = (1 + w if w.ndim < 3 and "ln" in path[-1] else w).abs().max()
        assert (mine[path] - w).abs().max() <= 1e-5 * scale, keystr(path)
    out = capfd.readouterr().out
    assert "mesh (data=2, model=1) backend=gloo devices=cpu,cpu" in out
    assert out.count("training complete") == 2       # host, then rank 0
    # the mesh's checkpoint is whole: the host launcher resumes it
    _, _, more = train_launch.main(common + [
        "--device", "cpu", "--ckpt-dir", str(tmp_path / "mesh")])
    assert more == [] and "resumed from step 2" in capfd.readouterr().out
    with pytest.raises(SystemExit):
        train_launch.main(common + ["--devices", "cpu,cpu"])


def test_chip_smoke_train_mesh_phase_rehearses_on_cpu(monkeypatch):
    """Phase 13 of chip_smoke.py end to end on the CPU at tiny size
    (tiny-lm cut to 2 layers, batches of 4 x 32, 3 steps) on its three
    meshes: every check holds (no peak-memory gate off the card), the
    (2, 2) checkpoint resumes on one device, and each line carries the
    collectives of a step by direction."""
    import importlib.util
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    monkeypatch.setitem(sys.modules, "chip_smoke", cs)
    monkeypatch.syspath_prepend(str(root))
    monkeypatch.setattr(cs, "DEV", "cpu")
    unmet, rows = [], []
    monkeypatch.setattr(cs, "require",
                        lambda ok, what: ok or unmet.append(what))
    monkeypatch.setattr(cs, "emit", rows.append)
    counts = cs.phase_train_mesh(0, "tiny-lm", 2, 4, 32)
    assert unmet == [] and not any(counts.values())
    paths = [r for r in rows if r["check"] == "train_mesh_path"]
    assert [p["mesh"] for p in paths] == [[2, 1], [1, 2], [2, 2]]
    spawn = next(r for r in rows if r["check"] == "train_mesh_spawn")
    assert spawn["stages"] == [["2x1@0", "1x2@2"], ["2x2@0"]]
    floor = next(r for r in rows if r["check"] == "train_mesh_noise_floor")
    assert floor["params_norm"] <= cs.TOL_TRAIN_MESH
    for p in paths:
        assert p["max_loss_rel_err"] <= cs.TOL_TRAIN_MESH
        assert p["max_grad_norm_rel_err"] <= cs.TOL_TRAIN_MESH
        # at tiny size even the largest entry error is within the bound
        assert p["errors"]["params_max"] <= cs.TOL_TRAIN_MESH
        assert p["errors"]["mu_max"] <= cs.TOL_TRAIN_MESH
        n = p["mesh"][0] * p["mesh"][1]
        assert len(p["ranks"]) == n
        for r in p["ranks"]:
            assert r["held_bytes"] == r["rule_local_bytes"] \
                == r["spec_local_bytes"]
            # a rank holds 1/n of the state, but the replicated norm
            # scales (0.2 % of tiny-lm's state on (2, 2))
            assert r["held_bytes"] <= 1.01 * p["whole_state_bytes"] / n
            assert len(r["wall_ms"]) == 3
        last = p["ranks"][0]["collectives_last_step"]
        assert ("reduce_scatter_data_backward" in last["backward"]) \
            == p["fsdp"]
        assert ("all_reduce_backward" in last["backward"]) \
            == (p["mesh"][1] > 1)
    resume = paths[2]["resume"]
    assert resume["resumed"] and resume["from_step"] == 2
    assert len(resume["losses"]) == 1 and len(resume["restore_s"]) == 1
    assert resume["errors"]["params_max"] <= cs.TOL_TRAIN_MESH
    assert paths[2]["ranks"][0]["save_s"] is not None


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
