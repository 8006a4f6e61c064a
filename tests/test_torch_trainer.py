"""The port's Trainer and get_trained_lm (repro_torch/train/trainer.py,
repro_torch/data/pretrained.py): resume exactness, SIGTERM handling,
a run from the reference's step-0 checkpoint against the reference's
Trainer, and trained-model caches shared by the two packages.

Tolerances: an interrupted and resumed run lands on the uninterrupted
run's params exactly (the same ops on the same inputs on the CPU); the
port's 6-step run from the reference's weights matches the reference
Trainer's losses within 1e-5 relative and its params within 2e-5 x
max|p| a leaf (gradients agree to ~1e-6 of their largest entry; Adam
moves an entry whose gradient is near that noise by up to lr x
lr_scale, 5e-5 at most here, in another direction); a cached model
restores bit-exact.
"""
import os
import shutil
import signal
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.ckpt import CheckpointManager as JaxCheckpointManager
from repro.configs import get_config as jax_get_config
from repro.data import pretrained as jax_pretrained
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch.ckpt import stack_params
from repro_torch.configs import get_config
from repro_torch.data import batches, token_stream
from repro_torch.data import pretrained
from repro_torch.train import AdamWConfig, Trainer, TrainerConfig
from repro_torch.tree import keystr, leaves_with_paths
from torch_threads import one_torch_thread  # noqa: F401

KW = dict(n_layers=2, d_model=64, d_ff=128, remat="none")


def _cfg():
    return get_config("tiny-lm").replace(dtype="float32", **KW)


def _trainer(d, steps, data, ckpt_every=100, **kw):
    opt = AdamWConfig(lr=1e-3, master_fp32=False)
    return Trainer(_cfg(), TrainerConfig(
        steps=steps, ckpt_every=ckpt_every, ckpt_dir=str(d), log_every=100,
        opt=opt, **kw), data, dtype="float32", device="cpu")


def _data(toks):
    return batches(toks, 4, 32, seed=0)


def test_trainer_resume_exact(tmp_path):
    """Same seed and batches: a run interrupted at step 3 and resumed
    lands on the uninterrupted run's params."""
    toks = token_stream("wiki", 30_000)
    full = _trainer(tmp_path / "a", 6, _data(toks))
    out = full.run()
    assert not out["resumed"] and out["final_step"] == 6
    first = _trainer(tmp_path / "b", 3, _data(toks), ckpt_every=3)
    first.run()
    it = _data(toks)
    for _ in range(3):                    # replay the stream to step 3
        next(it)
    second = _trainer(tmp_path / "b", 6, it)
    out = second.run()
    assert out["resumed"] and out["final_step"] == 6
    for (path, a), (_, b) in zip(leaves_with_paths(full.params),
                                 leaves_with_paths(second.params)):
        assert torch.equal(a, b), keystr(path)
    assert [m["loss"] for m in full.metrics_log[3:]] == \
        [m["loss"] for m in second.metrics_log]


def test_sigterm_checkpoints_and_exits_cleanly(tmp_path):
    toks = token_stream("wiki", 30_000)

    def data():
        for i, b in enumerate(_data(toks)):
            if i == 2:                    # preempted while fetching step 3
                os.kill(os.getpid(), signal.SIGTERM)
            yield b
    tr = _trainer(tmp_path, 10, data())
    before = signal.getsignal(signal.SIGTERM)
    out = tr.run()
    assert out["final_step"] == 3 and tr.ckpt.latest_step() == 3
    assert signal.getsignal(signal.SIGTERM) == before
    again = _trainer(tmp_path, 10, data())
    assert again.try_resume() and again.step == 3
    for (path, a), (_, b) in zip(leaves_with_paths(again.params),
                                 leaves_with_paths(tr.params)):
        assert torch.equal(a, b), keystr(path)


def test_run_from_a_reference_checkpoint_matches_the_reference(tmp_path):
    """The reference Trainer writes its step-0 state; the port's Trainer
    resumes from it and both run 6 steps on the same batches."""
    jcfg = jax_get_config("tiny-lm").replace(dtype="float32", **KW)
    jopt_cfg = jopt.AdamWConfig(lr=1e-3, master_fp32=False)
    toks = token_stream("wiki", 30_000)
    jtr = jtrainer.Trainer(jcfg, jtrainer.TrainerConfig(
        steps=6, ckpt_every=100, ckpt_dir=str(tmp_path / "ref"),
        log_every=100, warmup=2, opt=jopt_cfg), _data(toks),
        dtype="float32")
    JaxCheckpointManager(tmp_path / "ref", async_save=False).save(
        0, {"params": jtr.params, "opt": jtr.opt_state})
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    jtr.run()
    tr = _trainer(tmp_path / "port", 6, _data(toks), warmup=2)
    out = tr.run()
    assert out["resumed"]
    for mine, ref in zip(tr.metrics_log, jtr.metrics_log):
        assert abs(mine["loss"] - ref["loss"]) <= 1e-5 * ref["loss"]
    want = dict(leaves_with_paths(jax.tree.map(np.asarray, jtr.params)))
    for path, a in leaves_with_paths(tr.params):
        w = want[path]
        assert np.abs(a.numpy() - w).max() <= 2e-5 * np.abs(w).max(), \
            keystr(path)


def _bit_equal(port_params, ref_params):
    want = dict(leaves_with_paths(jax.tree.map(np.asarray, ref_params)))
    got = dict(leaves_with_paths(stack_params(
        get_config("tiny-mla").replace(dtype="float32"), port_params)))
    assert set(map(keystr, got)) == set(map(keystr, want))
    return all(np.array_equal(got[k].numpy(), want[k]) for k in got)


def test_get_trained_lm_shares_its_cache_with_the_reference(tmp_path,
                                                            monkeypatch):
    """Each package restores the model the other trained (2-layer
    tiny-mla, 2 steps), under the same artifacts/models/<name>-<corpus>
    -s<steps> scheme."""
    monkeypatch.setattr(jax_pretrained, "MODELS_DIR", tmp_path)
    monkeypatch.setattr(pretrained, "MODELS_DIR", tmp_path)
    jcfg, jp = jax_pretrained.get_trained_lm("tiny-mla", steps=2)
    assert (tmp_path / "tiny-mla-wiki-s2").is_dir()
    cfg, p = pretrained.get_trained_lm("tiny-mla", steps=2, device="cpu")
    assert cfg.remat == "none" and cfg.dtype == "float32"
    assert len(p["layers"]) == 2 and _bit_equal(p, jp)
    cfg, p3 = pretrained.get_trained_lm("tiny-mla", steps=3, device="cpu")
    assert (tmp_path / "tiny-mla-wiki-s3").is_dir()
    _, jp3 = jax_pretrained.get_trained_lm("tiny-mla", steps=3)
    assert _bit_equal(p3, jp3)


def test_chip_smoke_train_phase_rehearses_on_cpu(monkeypatch):
    """Phase 10 of chip_smoke.py end to end on the CPU at tiny size
    (tiny-lm cut to 2 layers at batch 4 x 32; the table on tiny-mla
    trained 2 steps; hubert-xlarge at full width cut to 1 layer): every
    check holds but the launch counts (no kernel runs on the CPU), and
    the registry keeps the reference's names."""
    import importlib.util
    from repro_torch.quant import available_quantizers
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    monkeypatch.setattr(cs, "DEV", "cpu")
    unmet, rows = [], []
    monkeypatch.setattr(cs, "require",
                        lambda ok, what: ok or unmet.append(what))
    monkeypatch.setattr(cs, "emit", rows.append)
    names = available_quantizers()
    counts, out = cs.phase_train_eval(0, "tiny-lm", 2, 4, 32, table_steps=2,
                                      table_arch="tiny-mla",
                                      encoder_layers=1)
    assert available_quantizers() == names
    assert all("launch" in u for u in unmet) and len(unmet) == 4, unmet
    train = out["train"]
    assert train["resumed"] and train["resume_max_abs_diff"] == 0.0
    assert len(train["steps"]) == 4 and len(train["losses_b"]) == 2
    assert train["checkpoint_bytes"] > 3 * 4 * train["params"]
    assert len(train["save_s"]) == 1 and len(train["restore_s"]) == 1
    table = out["table"]["ppl"]
    assert set(table) == {"fp", "rtn", "gptqt"}
    evals = [r for r in rows if r["check"] == "eval_path"]
    assert len(evals) == 4 and all(r["rel_diff"] <= cs.TOL_PPL
                                   for r in evals)
    enc = out["encoder"]
    assert enc["grads_finite"] and enc["grad_global_norm"] > 0
    assert enc["frames"] == [2, 256, 1280]
