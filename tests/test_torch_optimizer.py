"""The port's optimizer, schedule and train step (repro_torch/train/:
optimizer.py, schedule.py, train_step.py) against the reference's.

Same inputs: the reference's init_params(PRNGKey(0)) of a 2-layer
tiny-lm (d_model 64, d_ff 128) and of tiny-moe, carried across in the
stacked layout the train state keeps, and batches of the wiki corpus
(data/corpus.py:batches, seed 0). Tolerances: the schedule 1e-6
absolute; an AdamW update of given gradients within 1e-6 x max|ref| a
leaf (fp32 elementwise, the pow and sqrt of two libraries); three train
steps within 2e-5 x max|ref| a leaf for params and moments and 1e-5
relative for the loss and grad norm: the gradients agree to ~1e-6 of
their largest entry, and Adam normalises each entry by its own size,
so an entry whose gradient is near that noise moves by up to
lr x lr_scale (2e-5 at these settings) in another direction.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data import batches as jax_batches
from repro.data import token_stream as jax_token_stream
from repro.models import init_params as jax_init_params
from repro.train import optimizer as jopt
from repro.train import schedule as jsched
from repro.train import train_step as jstep
from repro_torch.ckpt.packed import _tensor
from repro_torch.configs import get_config
from repro_torch.train import (AdamWConfig, adamw_init, adamw_update,
                               cosine_with_warmup, global_norm,
                               make_train_step)
from repro_torch.tree import keystr, leaves_with_paths, tree_map
from torch_threads import one_torch_thread  # noqa: F401


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return _tensor(np.asarray(tree))


def _np(t):
    t = t.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _jnp(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def assert_trees_close(got, want, tol, what=""):
    """Every leaf of `got` (torch) within tol x max|leaf| of `want`."""
    w = dict(leaves_with_paths(jax.tree.map(_jnp, want)))
    g = dict(leaves_with_paths(got))
    assert set(map(keystr, g)) == set(map(keystr, w)), what
    for path, a in g.items():
        ref = w[path]
        err = np.abs(_np(a).astype(np.float64) - ref).max()
        assert err <= tol * max(np.abs(ref).max(), 1e-30), (
            what, keystr(path), err, np.abs(ref).max())


def _small_cfgs(name):
    jcfg = jax_get_config(name).replace(dtype="float32", remat="none")
    cfg = get_config(name).replace(dtype="float32")
    if name == "tiny-lm":
        kw = dict(n_layers=2, d_model=64, d_ff=128)
        jcfg, cfg = jcfg.replace(**kw), cfg.replace(**kw)
    return jcfg, cfg


def test_cosine_with_warmup_matches_the_reference():
    for warmup, total in ((20, 100), (0, 50), (10, 10)):
        for s in range(0, 130, 3):
            want = float(jsched.cosine_with_warmup(s, warmup=warmup,
                                                   total=total))
            got = cosine_with_warmup(torch.tensor(s, dtype=torch.int32),
                                     warmup=warmup, total=total)
            assert got.dtype == torch.float32
            assert abs(float(got) - want) <= 1e-6, (warmup, total, s)


@pytest.mark.parametrize("dtype,master", [("float32", False),
                                          ("float32", True),
                                          ("bfloat16", True)])
def test_adamw_update_matches_the_reference(dtype, master):
    """Three updates of seeded gradients; weight decay on the stacked
    rank (each block's 1-D norm is a (n_groups, d) leaf there and is
    decayed; only final_ln is not)."""
    jcfg, cfg = _small_cfgs("tiny-lm")
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0), dtype=dtype)
    # move the (zero-initialised) norms off zero, so that their decay
    # shows
    jp = jax.tree.map(lambda a: a + 0.1 if a.ndim <= 2 and a.shape[-1] == 64
                      else a, jp)
    ocfg = AdamWConfig(lr=1e-2, weight_decay=0.3, master_fp32=master)
    jocfg = jopt.AdamWConfig(lr=1e-2, weight_decay=0.3, master_fp32=master)
    js = jopt.adamw_init(jp, jocfg)
    tp = _torch_tree(jax.tree.map(np.asarray, jp))
    ts = adamw_init(tp, ocfg)
    assert sorted(ts) == sorted(js)
    rng = np.random.default_rng(1)
    for i in range(3):
        g = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.05)
                         .astype(np.float32), jp)
        scale = 0.5 + 0.25 * i
        jp, js, jm = jopt.adamw_update(g, js, jp, jocfg, scale)
        tp, ts, tm = adamw_update(_torch_tree(g), ts, tp, ocfg, scale)
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-6 * float(jm["grad_norm"])
    tol = 1e-6 if dtype == "float32" else 2 ** -8   # one bf16 ulp
    assert_trees_close(tp, jp, tol, "params")
    for k in ("mu", "nu") + (("master",) if master else ()):
        assert_trees_close(ts[k], js[k], 1e-6, k)
    assert int(ts["step"]) == int(js["step"]) == 3
    assert ts["step"].dtype == torch.int32
    assert tp["blocks"]["L0"]["ln"].dtype == tp["final_ln"].dtype == \
        getattr(torch, dtype)
    # the decay rule reads the stacked rank, so per-layer trees are refused
    with pytest.raises(ValueError, match="stacked layout"):
        adamw_update(g, ts, {"layers": []}, ocfg)


def test_global_norm_sums_in_the_reference_order():
    jcfg, _ = _small_cfgs("tiny-lm")
    jp = jax_init_params(jcfg, jax.random.PRNGKey(2))
    want = float(jopt.global_norm(jp))
    got = float(global_norm(_torch_tree(jax.tree.map(np.asarray, jp))))
    assert abs(got - want) <= 1e-6 * want


_jit_steps: dict = {}


@pytest.mark.parametrize("name,microbatches,compress", [
    ("tiny-lm", 1, "none"), ("tiny-lm", 4, "none"), ("tiny-lm", 4, "int8"),
    ("tiny-lm", 1, "int8"), ("tiny-moe", 2, "int8")])
def test_train_step_matches_the_reference(name, microbatches, compress):
    """Three steps of make_train_step from the reference's weights:
    loss, grad norm and lr each step; params and moments after."""
    jcfg, cfg = _small_cfgs(name)
    jocfg = jopt.AdamWConfig(lr=1e-3, master_fp32=False)
    ocfg = AdamWConfig(lr=1e-3, master_fp32=False)
    kw = dict(microbatches=microbatches, warmup=2, total_steps=10,
              grad_compress=compress)
    key = (name, microbatches, compress)
    if key not in _jit_steps:
        _jit_steps[key] = jax.jit(jstep.make_train_step(jcfg, jocfg, **kw))
    jfn = _jit_steps[key]
    tfn = make_train_step(cfg, ocfg, **kw)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    js = jstep.init_train_state(jcfg, jp, jocfg)
    tp = _torch_tree(jax.tree.map(np.asarray, jp))
    ts = adamw_init(tp, ocfg)
    data = jax_batches(jax_token_stream("wiki", 20_000), 4, 32, seed=0)
    for _ in range(3):
        batch = next(data)
        jp, js, jm = jfn(jp, js, batch)
        tp, ts, tm = tfn(tp, ts, batch)
        for k in ("loss", "grad_norm", "lr"):
            assert abs(float(tm[k]) - float(jm[k])) <= \
                1e-5 * abs(float(jm[k])) + 1e-9, (k, tm[k], jm[k])
    assert_trees_close(tp, jp, 2e-5, "params")
    assert_trees_close(ts["mu"], js["mu"], 2e-5, "mu")
    assert_trees_close(ts["nu"], js["nu"], 2e-5, "nu")
    assert int(ts["step"]) == 3


def test_int8_accumulator_rounds_half_to_even_like_the_reference():
    from repro.train.train_step import _quantize_leaf as jq
    from repro_torch.train.train_step import _quantize_leaf as tq
    g = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0, 3.49, -127.0],
                 dtype=np.float32)
    jqv, js = jq(jnp.asarray(g))
    tqv, ts = tq(torch.from_numpy(g))
    assert np.array_equal(np.asarray(jqv), tqv.numpy())
    assert float(ts) == float(js)
