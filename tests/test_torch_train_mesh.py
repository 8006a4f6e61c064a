"""Training over a mesh on the CPU (the reference's sharded train step,
src/repro/launch/train.py with params_shardings / opt_state_shardings).

Spawned gloo ranks (dist/context.py:spawn, one torch thread a rank; the
rank bodies are tests/torch_mesh.py's, which imports no JAX) train
tiny-lm cut to 2 layers (fp32, remat full) for 3 steps on batches of 4 x
32 from the wiki corpus, on meshes (2, 1) and (1, 2) side by side, then
(2, 2): FSDP on and off, 2 microbatches with grad_compress none and
int8, and tiny-lm-wide with qk-norm (3 KV heads: a 2-way model axis
keeps wk and wv whole, each rank's 3 query heads straddling 2 GQA
groups). Each mesh's losses, gradient norms, gathered params and AdamW
first moments are held against the reference's host-mesh
make_train_step (jit, run here on the same numpy params and batches)
and against the port's single device. The ranks
hold the blocks local_shape gives for the reference's specs, params and
moments alike. A (2, 2) checkpoint resumes on one device and a one-device
checkpoint on (2, 1), through the Trainer.

Tolerances: losses and gradient norms within 1e-5 relative; each leaf
of mu within 1e-5 x max|mu|; each params leaf within 1e-5 x max|p| of
the leaf, where p is what the forward applies: the weight itself, or
for a zero-centred norm scale w (rmsnorm's 1 + w) 1 + w. A
norm scale starts at 0 and moves ~lr a step, and the mesh sums its
gradient in another order than one device (reduce-scatter, all-reduce):
near-zero entries carry ~1e-5 relative noise, which puts the scale
2e-5-6e-5 x max|w| from one device's (measured), 1e-8 of 1 + w.
"""
import contextlib
import tempfile
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.dist.sharding import named_pspec as jax_named_pspec
from repro.train import optimizer as jopt
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.ckpt import CheckpointManager, stack_params
from repro_torch.configs import get_config, smoke_config
from repro_torch.data import batches, token_stream
from repro_torch.dist import context
from repro_torch.dist.context import ServeMesh, spawn
from repro_torch.dist.sharding import (REPLICATED_LEAVES, TrainLayout,
                                       local_shape, whole_kv_leaves)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import init_params
from repro_torch.train import (AdamWConfig, Trainer, TrainerConfig,
                               init_train_state, make_train_step)
from repro_torch.tree import keystr, leaves_with_paths
from torch_mesh import train_config, train_meshes
from torch_threads import one_torch_thread  # noqa: F401

STEPS, WARMUP, TOL = 3, 4, 1e-5
TINY = {"arch": "tiny-lm"}
WIDE = {"arch": "tiny-lm-wide", "kw": {"qk_norm": True}}
# (mesh shape, first rank, stage): (2, 1) and (1, 2) side by side
MESHES = {(2, 1): (0, 0), (1, 2): (2, 0), (2, 2): (0, 1)}
# the cases held against the reference and one device, by mesh
CASES = {(2, 1): ("fsdp", "nofsdp", "mb2"), (1, 2): ("tp", "wide"),
         (2, 2): ("fsdp", "nofsdp", "int8", "wide")}
MESH_CASES = [(shape, key) for shape, keys in CASES.items() for key in keys]


def _batches():
    it = batches(token_stream("wiki", 30_000), 4, 32, seed=0)
    return [next(it) for _ in range(STEPS)]


def _cases(tmp):
    """{mesh shape: {case id: case}}; a case's reference run is its
    `ref` key (arch, microbatches, compression)."""
    b = _batches()
    c = {"batches": b, "warmup": WARMUP}
    mb2 = {"microbatches": 2}
    return {
        (2, 1): {"fsdp": {**c, **TINY}, "nofsdp": {**c, **TINY, "fsdp": False},
                 "mb2": {**c, **TINY, **mb2},
                 # a one-device checkpoint at step 2, resumed to 3
                 "resume": {**c, **TINY, "ckpt": str(tmp / "one"),
                            "start": 2},
                 "alive": {**c, **TINY, "alive": True}},
        (1, 2): {"tp": {**c, **TINY}, "wide": {**c, **WIDE}},
        (2, 2): {"fsdp": {**c, **TINY}, "nofsdp": {**c, **TINY, "fsdp": False},
                 "int8": {**c, **TINY, **mb2, "grad_compress": "int8"},
                 "wide": {**c, **WIDE},
                 # saved at step 2 for one device to resume
                 "save": {**c, **TINY, "ckpt": str(tmp / "mesh"),
                          "save_at": 2}},
    }


def _ref_key(case):
    return (case["arch"], bool(case.get("kw")), case.get("microbatches", 1),
            case.get("grad_compress", "none"))


def _whole(cfg):
    return stack_params(cfg, init_params(cfg, seed=0, device="cpu"))


def _jax_run(cfg_case, bs):
    """The reference's host-mesh step (jit) on the port's seeded init:
    (losses, gradient norms, {keystr: array} of the params and mu)."""
    arch, qk, mb, comp = cfg_case
    kw = {"qk_norm": True} if qk else {}
    jcfg = jax_get_config(arch).replace(dtype="float32", n_layers=2,
                                        remat="full", **kw)
    cfg = train_config({"arch": arch, "kw": kw})
    params = jax.tree.map(lambda t: jax.numpy.asarray(t.numpy()),
                          _whole(cfg))
    ocfg = jopt.AdamWConfig(lr=1e-3, master_fp32=False)
    opt = jopt.adamw_init(params, ocfg)
    step = jax.jit(jax_make_train_step(jcfg, ocfg, microbatches=mb,
                                       warmup=WARMUP, grad_compress=comp))
    losses, norms = [], []
    for b in bs:
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, _flat(jax.tree.map(np.asarray, {
        "params": params, "opt": {"mu": opt["mu"]}}))


def _port_run(cfg_case, bs):
    """The port on one device: as _jax_run."""
    arch, qk, mb, comp = cfg_case
    cfg = train_config({"arch": arch, "kw": {"qk_norm": True} if qk
                        else {}})
    ocfg = AdamWConfig(lr=1e-3, master_fp32=False)
    params = _whole(cfg)
    opt = init_train_state(cfg, params, ocfg)
    step = make_train_step(cfg, ocfg, microbatches=mb, warmup=WARMUP,
                           grad_compress=comp)
    losses, norms = [], []
    for b in bs:
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, _flat({"params": params, "opt": {"mu": opt["mu"]}})


def _flat(tree) -> dict:
    """{keystr: numpy array} of a tree of arrays or tensors."""
    return {keystr(p): np.asarray(a) for p, a in leaves_with_paths(tree)}


_RUN: dict = {}


def _run():
    """Every mesh's cases in one spawn of four ranks, the references and
    the single device's runs here (once a process)."""
    if _RUN:
        return _RUN
    tmp = Path(tempfile.mkdtemp(prefix="train_mesh_"))
    cases = _cases(tmp)
    bs = cases[(2, 1)]["fsdp"]["batches"]
    # the one-device checkpoint at step 2 that (2, 1) resumes
    tr = Trainer(train_config(TINY), TrainerConfig(
        steps=2, ckpt_every=10 ** 9, ckpt_dir=str(tmp / "one"),
        log_every=10 ** 9, warmup=WARMUP,
        opt=AdamWConfig(lr=1e-3, master_fp32=False)), iter(bs),
        dtype="float32", device="cpu")
    tr.run()
    world = ServeMesh(2, 2, ["cpu"] * 4)
    plan = [(shape, *MESHES[shape], cs) for shape, cs in cases.items()]
    ranks = spawn(train_meshes, world, (plan,), threads=1, timeout_s=300)
    refs = {k: None for cs in cases.values() for k in map(_ref_key,
                                                          cs.values())}
    _RUN.update(tmp=tmp, cases=cases, bs=bs, ranks=ranks,
                jax={k: _jax_run(k, bs) for k in refs},
                port={k: _port_run(k, bs) for k in refs})
    return _RUN


def _held_to(got: dict, want: dict, tol=TOL) -> None:
    """Each leaf of `want` (params, and mu where it has it) within tol x
    max|p| of `got`'s (p the applied scale 1 + w of a norm leaf)."""
    for key, w in want.items():
        norm = (key.startswith("['params']")
                and key.split("'")[-2] in REPLICATED_LEAVES)
        scale = np.abs(1.0 + w if norm else w).max()
        err = np.abs(got[key] - w).max()
        assert err <= tol * scale, (key, err / scale)


def _params(state: dict) -> dict:
    return {k: v for k, v in state.items() if k.startswith("['params']")}


@pytest.mark.parametrize("shape,key", MESH_CASES,
                         ids=[f"{s[0]}x{s[1]}-{k}" for s, k in MESH_CASES])
def test_mesh_trains_as_the_reference_and_one_device(shape, key):
    run = _run()
    case = run["cases"][shape][key]
    rank0 = run["ranks"][MESHES[shape][0]][(shape, key)]
    for ref in ("jax", "port"):
        losses, norms, state = run[ref][_ref_key(case)]
        # every rank reports the whole step's loss and gradient norm
        for r in run["ranks"][MESHES[shape][0]:][:shape[0] * shape[1]]:
            got = r[(shape, key)]
            assert np.allclose(got["losses"], losses, rtol=TOL, atol=0), \
                (ref, got["losses"], losses)
            assert np.allclose(got["grad_norms"], norms, rtol=TOL, atol=0), \
                (ref, got["grad_norms"], norms)
        _held_to(rank0["state"], state)


@pytest.mark.parametrize("shape", list(MESHES), ids=lambda s: f"{s[0]}x{s[1]}")
def test_ranks_hold_the_reference_specs_blocks(shape):
    """Each rank's params, mu and nu have the shapes local_shape gives
    for the reference's named_pspec at the mesh (fsdp on and off; a
    moment as its param); on a model axis that does not divide the KV
    heads, wk and wv are whole on the model axis (whole_kv_leaves)."""
    run = _run()

    class Mesh:
        axis_names = ("data", "model")
        devices = np.empty(shape)
    first = MESHES[shape][0]
    for key, case in run["cases"][shape].items():
        if case.get("alive"):
            continue
        cfg = train_config(case)
        jcfg = jax_get_config(case["arch"]).replace(
            dtype="float32", n_layers=2, **case.get("kw", {}))
        whole = dict(leaves_with_paths(_whole(cfg)))
        kv = whole_kv_leaves(cfg, Mesh)
        for r in run["ranks"][first:first + shape[0] * shape[1]]:
            held = r[(shape, key)]["held"]
            for part in ("params", "opt"):
                for path, got in held[part].items():
                    if part == "opt" and path == ("step",):
                        assert got == ()
                        continue
                    p = path if part == "params" else path[1:]
                    spec = jax_named_pspec(jcfg, list(p), whole[p], Mesh,
                                           fsdp=case.get("fsdp", True))
                    spec = tuple(None if a == "model" and p[-1] in kv
                                 else a for a in spec)
                    assert got == local_shape(whole[p].shape, spec, Mesh), \
                        (key, part, path, got)


def test_checkpoints_resume_across_meshes():
    """(2, 2) saves at step 2 (whole, the reference's format) and one
    device resumes it to step 3; a one-device checkpoint at step 2
    resumes on (2, 1). Both land on the single device's 3-step run."""
    run = _run()
    want_losses, _, want = run["port"][_ref_key(TINY)]
    want = _params(want)
    saved = CheckpointManager(run["tmp"] / "mesh")
    assert saved.committed_steps() == [2]
    tr = Trainer(train_config(TINY), TrainerConfig(
        steps=STEPS, ckpt_every=10 ** 9, ckpt_dir=str(run["tmp"] / "mesh"),
        log_every=10 ** 9, warmup=WARMUP,
        opt=AdamWConfig(lr=1e-3, master_fp32=False)), iter(run["bs"][2:]),
        dtype="float32", device="cpu")
    assert tr.run()["resumed"]
    _held_to(_flat({"params": tr.params}), want)
    assert np.allclose([m["loss"] for m in tr.metrics_log], want_losses[2:],
                       rtol=TOL, atol=0)
    mesh_run = run["ranks"][0][((2, 1), "resume")]
    assert mesh_run["resumed"]
    assert np.allclose(mesh_run["losses"], want_losses[2:], rtol=TOL, atol=0)
    _held_to(_params(mesh_run["state"]), want)
    save_run = run["ranks"][0][((2, 2), "save")]
    assert np.allclose(save_run["losses"], want_losses[:2], rtol=TOL, atol=0)


def test_gathered_layers_live_one_at_a_time():
    """On (2, 1) under FSDP with remat full, no gathered weight outlives
    its layer's pass: none is alive once the forward has run, the
    backward gathers each layer's again, and every block gets a
    gradient."""
    got = _run()["ranks"][0][((2, 1), "alive")]
    # 2 layers x 7 matmul leaves (wq, wk, wv, wo, wg, wu, wd), whose
    # d_model the data axis cuts; the embedding and head are not
    # gathered (their activations are)
    assert got["gathered"] == 14 and got["gathered_in_backward"] == 14
    assert got["alive_after_forward"] == 0
    assert got["alive_after_backward"] == 0
    assert got["grads"] == len(list(leaves_with_paths(_whole(
        train_config(TINY)))))


def test_mesh_step_collectives():
    """FSDP gathers each layer's blocks in the forward and again in the
    backward (remat), reduce-scatters their gradients and all-reduces
    the leaves the data axis leaves whole; a model axis all-reduces each
    mixer's and MLP's output (forward) and each column-parallel input's
    gradient (backward); without FSDP nothing is gathered over data."""
    run = _run()
    got = {(s, k): run["ranks"][MESHES[s][0]][(s, k)]["counts"]
           for s, k in MESH_CASES}
    fsdp = got[((2, 1), "fsdp")]
    assert fsdp["all_gather_data"] > 0 and \
        fsdp["reduce_scatter_data_backward"] > 0
    assert "all_reduce" not in fsdp and "all_reduce_backward" not in fsdp
    nof = got[((2, 1), "nofsdp")]
    assert set(nof) == {"step_all_reduce_data"}
    tp = got[((1, 2), "tp")]
    assert tp["all_reduce"] > 0 and tp["all_reduce_backward"] > 0
    assert not any("data" in k for k in tp)
    # the int8 scale is each whole leaf's: a MAX over both axes a
    # microbatch
    assert got[((2, 2), "int8")]["step_all_reduce_max_data"] == 2 * STEPS
    assert got[((2, 2), "int8")]["step_all_reduce_max_model"] == 2 * STEPS
    # a step: wk, wv and the qk-norm scales summed over the model group,
    # and the global norm's model-cut leaves
    assert got[((1, 2), "wide")]["step_all_reduce_model"] == 2 * STEPS
    assert got[((1, 2), "tp")]["step_all_reduce_model"] == STEPS


def test_training_mesh_refusals():
    """MoE, MLA and Mamba train on a mesh (tests/test_torch_train_mesh_
    families.py); a model axis that does not divide a MoE config's
    experts (the reference cuts inside each expert), a multi-pod mesh and
    a mesh of more cards than are visible raise, citing the ROADMAP
    item."""
    mesh = ServeMesh(2, 1, ["cpu", "cpu"], rank=0)
    for arch in ("tiny-moe", "tiny-mla", "falcon-mamba-7b"):
        cfg = smoke_config(arch) if arch.startswith("falcon") else \
            get_config(arch)
        TrainLayout(cfg.replace(n_layers=2), mesh)
        make_train_step(cfg, AdamWConfig(), mesh=mesh)
    three = ServeMesh(1, 3, ["cpu"] * 3, rank=0)
    cfg = get_config("tiny-moe").replace(n_layers=2)
    with pytest.raises(ValueError, match="item 6.5"):
        TrainLayout(cfg, three)
    with pytest.raises(ValueError, match="item 6.5"):
        make_train_step(cfg, AdamWConfig(), mesh=three)
    with pytest.raises(NotImplementedError, match="item 6.2"):
        make_production_mesh(multi_pod=True)
    with pytest.raises(ValueError, match="visible.*item 6.4"):
        make_production_mesh(model=2, devices=None)


def test_hooks_outside_a_mesh_return_their_input():
    """Outside a mesh, and on a (1, 1) mesh, each model-side hook is the
    identity: the very object, with no autograd Function in the way
    (serving's CUDA graphs and collective counts are unchanged)."""
    x = torch.ones(2, 3, requires_grad=True)
    for mesh in (None, ServeMesh(1, 1, ["cpu"], rank=0)):
        with context.mesh_context(mesh) if mesh else \
                contextlib.nullcontext():
            assert context.reduce_model(x) is x
            assert context.copy_to_model(x) is x
            assert not context.routes_over_data(x)
            c = torch.arange(3)
            assert torch.equal(context.gather_counts(c), c[None])
            assert context.gather_model(x, -1) is x
            assert context.gather_fsdp(x, 0) is x
            assert context.reduce_fsdp(x) is x
            assert context.gather_data(x) is x
            assert context.sync_grads([x], "data") == [x]
            assert context.reduce_max(x) is x
