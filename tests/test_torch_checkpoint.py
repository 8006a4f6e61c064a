"""The port's CheckpointManager (repro_torch/ckpt/checkpoint.py): round
trips, crash safety, keep_n, async saves, and the format as the
interface: checkpoints written by the reference's CheckpointManager
restore bit-exact in the port and the port's in the reference, params
and optimizer state alike (fp32 params, fp32 moments, the int32 step),
with the same keys and meta.json fields. A bf16 leaf (bf16 params with
fp32 master weights) round-trips through the port bit-exact and reads
back from a reference checkpoint bit-exact.
"""
import json
import os
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.ckpt import CheckpointManager as JaxCheckpointManager
from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.train import optimizer as jopt
from repro_torch.ckpt import CheckpointManager, stack_params, unstack_blocks
from repro_torch.configs import get_config
from repro_torch.models import init_params
from repro_torch.train import AdamWConfig, adamw_init
from repro_torch.tree import keystr, leaves_with_paths, tree_map
from torch_threads import one_torch_thread  # noqa: F401

KW = dict(n_layers=2, d_model=64, d_ff=128)


def _bits(a) -> np.ndarray:
    """Raw bytes of a leaf (torch or numpy/jax), for bit-exact checks."""
    if torch.is_tensor(a):
        a = a.detach()
        if a.dtype == torch.bfloat16:
            a = a.view(torch.int16)
        a = a.numpy()
    return np.ascontiguousarray(np.asarray(a)).reshape(-1).view(np.uint8)


def assert_bit_equal(got, want):
    g = dict(leaves_with_paths(got))
    w = dict(leaves_with_paths(want))
    assert set(map(keystr, g)) == set(map(keystr, w))
    for path, a in g.items():
        assert np.array_equal(_bits(a), _bits(w[path])), keystr(path)


def _port_state(cfg, seed=0, dtype="float32", master=False):
    params = stack_params(cfg, init_params(cfg, seed=seed, dtype=dtype,
                                           device="cpu"))
    opt = adamw_init(params, AdamWConfig(master_fp32=master))
    return {"params": params, "opt": opt}


def test_round_trip_crash_safety_and_keep_n(tmp_path):
    cfg = get_config("tiny-lm").replace(dtype="float32", **KW)
    state = _port_state(cfg, dtype="bfloat16", master=True)
    state["opt"]["step"] = torch.tensor(7, dtype=torch.int32)
    cm = CheckpointManager(tmp_path, keep_n=2, async_save=False)
    for s in (1, 2, 3):
        cm.save(s, state, metadata={"note": s})
    assert cm.committed_steps() == [2, 3]           # keep_n prunes step 1
    # a crash mid-save: a half-written tmp dir and an uncommitted step
    (tmp_path / "step_00000004.tmp").mkdir()
    os.makedirs(tmp_path / "step_00000005")
    assert cm.latest_step() == 3
    template = _port_state(cfg, seed=1, dtype="bfloat16", master=True)
    restored, meta = cm.restore(template)
    assert_bit_equal(restored, state)
    assert restored["params"]["embed"].dtype == torch.bfloat16
    assert restored["opt"]["step"].dtype == torch.int32
    assert meta["step"] == 3 and meta["note"] == 3 and "time" in meta
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore(template)
    bad = _port_state(cfg.replace(d_ff=64))
    with pytest.raises(ValueError, match="shape"):
        cm.restore(bad)


def test_async_save_snapshots_before_the_write(tmp_path):
    cfg = get_config("tiny-lm").replace(dtype="float32", **KW)
    state = _port_state(cfg)
    want = tree_map(lambda a: a.clone(), state)
    cm = CheckpointManager(tmp_path)
    cm.save(10, state)                      # on a thread
    state["params"]["final_ln"].add_(1.0)   # a later in-place change
    cm.wait()
    restored, meta = cm.restore(_port_state(cfg, seed=3))
    assert meta["step"] == 10
    assert_bit_equal(restored, want)


def _reference_state(jcfg, dtype="float32", master=False):
    p = jax_init_params(jcfg, jax.random.PRNGKey(0), dtype=dtype)
    ocfg = jopt.AdamWConfig(master_fp32=master)
    s = jopt.adamw_init(p, ocfg)
    # non-trivial moments and step: one update of seeded gradients
    rng = np.random.default_rng(0)
    g = jax.tree.map(lambda a: rng.standard_normal(a.shape)
                     .astype(np.float32), p)
    p, s, _ = jopt.adamw_update(g, s, p, ocfg)
    return {"params": p, "opt": s}


@pytest.mark.parametrize("name", ["tiny-lm", "tiny-moe"])
def test_reference_checkpoints_restore_bit_exact_both_ways(name, tmp_path):
    jcfg = jax_get_config(name).replace(dtype="float32", remat="none")
    cfg = get_config(name).replace(dtype="float32")
    if name == "tiny-lm":
        jcfg, cfg = jcfg.replace(**KW), cfg.replace(**KW)
    ref = _reference_state(jcfg)
    # reference -> port
    JaxCheckpointManager(tmp_path / "ref", async_save=False).save(
        1, ref, metadata={"who": "reference"})
    got, meta = CheckpointManager(tmp_path / "ref").restore(_port_state(cfg))
    assert_bit_equal(got, ref)
    assert meta["who"] == "reference" and meta["step"] == 1
    # port -> reference
    got["params"]["final_ln"] = got["params"]["final_ln"] + 0.5
    CheckpointManager(tmp_path / "port", async_save=False).save(
        2, got, metadata={"who": "port"})
    back, meta2 = JaxCheckpointManager(tmp_path / "port").restore(ref)
    assert_bit_equal(got, back)
    assert sorted(meta2) == sorted(meta) and meta2["step"] == 2
    names = {p.name for p in (tmp_path / "port" / "step_00000002").iterdir()}
    assert names == {"arrays.npz", "meta.json", "COMMITTED"}
    with np.load(tmp_path / "port" / "step_00000002" / "arrays.npz") as a, \
            np.load(tmp_path / "ref" / "step_00000001" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert "['params']['blocks']['L0']['attn']['wq']" in a.files
        assert all(a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                   for k in a.files)
    # the stacked params unstack into the port's per-layer layout
    layers = unstack_blocks(got["params"])["layers"]
    assert len(layers) == cfg.n_layers
    assert torch.equal(layers[1]["attn"]["wq"],
                       got["params"]["blocks"]["L0"]["attn"]["wq"][1])


def test_reference_bf16_checkpoint_reads_bit_exact(tmp_path):
    """bf16 params with fp32 master weights: the reference writes its
    bf16 leaves as 2-byte voids; the port reads their bits."""
    jcfg = jax_get_config("tiny-lm").replace(dtype="bfloat16", remat="none",
                                            **KW)
    cfg = get_config("tiny-lm").replace(dtype="bfloat16", **KW)
    ref = _reference_state(jcfg, dtype="bfloat16", master=True)
    JaxCheckpointManager(tmp_path, async_save=False).save(3, ref)
    got, _ = CheckpointManager(tmp_path).restore(
        _port_state(cfg, dtype="bfloat16", master=True))
    assert got["params"]["blocks"]["L0"]["ln"].dtype == torch.bfloat16
    assert_bit_equal(got, ref)
