"""Training MoE (expert parallel), MLA, Mamba and hybrid decoders over a
mesh on the CPU (the reference's sharded train step, src/repro/launch/
train.py with params_shardings / opt_state_shardings, for every family).

Spawned gloo ranks (dist/context.py:spawn, one torch thread a rank; the
rank bodies are tests/torch_mesh.py's, which imports no JAX) train
tiny-moe, tiny-mla and the smoke configs of falcon-mamba-7b and
jamba-1.5-large (fp32, remat full) for 3 steps on batches of 4 x 32
from the wiki corpus (ids mod the smoke vocabulary), on (2, 1) with
FSDP and (1, 2) side by side, then (2, 2) with FSDP, and tiny-moe with
2 microbatches and int8 accumulation on (2, 2). Each run's losses,
gradient norms, gathered params and AdamW first moments are held
against the reference's host-mesh make_train_step (jit, run here on the
port's seeded init as numpy and the same batches) and against the
port's single device, at test_torch_train_mesh.py's tolerances. tiny-moe
drops tokens: the reference's dropped (token, choice) pairs are counted
from its own routing (above 0), the port's single device and every mesh
report the same count a step, and routing each data rank's rows on its
own would have dropped another set. The ranks hold the blocks
shard_params cuts, leaf for leaf. A (2, 2) jamba checkpoint resumes on
one device and a one-device one on (2, 1). The rest of the registry's
smoke configs train on (2, 2) as on one device.

Tolerances: losses and gradient norms within 1e-5 relative; each
params leaf within 1e-5 x max|p| of the leaf, where p is the weight
itself, or 1 + w for a leaf the rules replicate (REPLICATED_LEAVES: a
zero-centred norm scale, rmsnorm's 1 + w, and Mamba's per-channel
leaves), and each leaf of mu within 1e-5 x max|mu|, as
test_torch_train_mesh.py holds them. A family whose gradients cancel
holds mu's largest entry to FLOOR_X times its noise floor instead, where
that is larger (as chip_smoke.py's phase 13 does): the floor is the port's
single device on the batches with their rows in reverse order against
in order, at a capacity where no MoE layer drops (so the same function,
each token sum in another order), and a family's gradients cancel where
it moves a leaf of mu by 1e-5 / 2 or more in norm. Only jamba's do: its
Mamba leaves' mu is ~7e-6 at most, and the floor puts layer 1's A_log mu
1.6e-5 x max|mu| off (5.6e-6 in norm), the meshes 1.4e-5-2.5e-5.
"""
import dataclasses
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.model as jax_model
from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.train import optimizer as jopt
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.ckpt import CheckpointManager, stack_params
from repro_torch.dist.context import ServeMesh, spawn
from repro_torch.dist.fsdp import FsdpLeaf
from repro_torch.dist.sharding import REPLICATED_LEAVES, shard_params
from repro_torch.data import batches, token_stream
from repro_torch.models import init_params
from repro_torch.models.model import loss_fn
from repro_torch.models.moe import count_drops
from repro_torch.train import (AdamWConfig, Trainer, TrainerConfig,
                               init_train_state, make_train_step)
from repro_torch.tree import keystr, leaves_with_paths
from torch_mesh import train_config, train_meshes
from torch_threads import one_torch_thread  # noqa: F401

STEPS, WARMUP, TOL = 3, 4, 1e-5
# a mesh reorders several sums at once where the floor reorders one, and
# independent rounding errors add in quadrature
FLOOR_X = 2
FAMILIES = {"moe": {"arch": "tiny-moe"}, "mla": {"arch": "tiny-mla"},
            "mamba": {"arch": "falcon-mamba-7b", "smoke": True},
            "hybrid": {"arch": "jamba-1.5-large-398b", "smoke": True}}
SWEEP = ("qwen3-0.6b", "qwen3-4b", "chameleon-34b", "gemma2-27b",
         "mixtral-8x7b", "qwen3-moe-235b-a22b", "hubert-xlarge")
INT8 = {"microbatches": 2, "grad_compress": "int8"}
# (mesh shape, first rank, stage): (2, 1) and (1, 2) side by side
MESHES = {(2, 1): (0, 0), (1, 2): (2, 0), (2, 2): (0, 1)}
# the cases held against the reference and one device, by mesh
HELD = [((2, 1), f) for f in FAMILIES] + [((1, 2), f) for f in FAMILIES] \
    + [((2, 2), f) for f in FAMILIES] + [((2, 2), "moe-int8")]


def _cfg(case):
    return train_config(case)


def _batches(cfg):
    """STEPS batches of 4 x 32 for `cfg`: wiki token ids (mod a smoke
    vocabulary), or seeded frames with labels for a frame-input config."""
    it = batches(token_stream("wiki", 30_000), 4, 32, seed=0)
    out = [next(it) for _ in range(STEPS)]
    if cfg.embed_input != "tokens":
        rng = np.random.default_rng(0)
        return [{"inputs": rng.standard_normal(
                    (4, 32, cfg.d_model)).astype(np.float32),
                 "labels": b["labels"] % cfg.vocab_size} for b in out]
    return [{k: v % cfg.vocab_size for k, v in b.items()} for b in out]


def _case(base, **kw):
    case = {**base, **kw, "warmup": WARMUP}
    case["batches"] = _batches(_cfg(case))
    return case


def _cases(tmp):
    """{mesh shape: {case id: case}}."""
    fam = {k: _case(v) for k, v in FAMILIES.items()}
    hybrid = FAMILIES["hybrid"]
    return {
        (2, 1): {**fam,
                 # a one-device checkpoint at step 2, resumed to 3
                 "resume": _case(hybrid, ckpt=str(tmp / "one"), start=2)},
        (1, 2): {k: {**c, "fsdp": False} for k, c in fam.items()},
        (2, 2): {**fam, "moe-int8": _case(FAMILIES["moe"], **INT8),
                 # saved at step 2 for one device to resume
                 "save": _case(hybrid, ckpt=str(tmp / "mesh"), save_at=2),
                 **{f"sweep/{a}": _case({"arch": a, "smoke": True})
                    for a in SWEEP}},
    }


def _ref_key(case):
    return (case["arch"], bool(case.get("smoke")),
            case.get("microbatches", 1), case.get("grad_compress", "none"))


def _whole(cfg):
    return stack_params(cfg, init_params(cfg, seed=0, device="cpu"))


def _jax_cfg(case):
    arch = case["arch"]
    jcfg = jax_smoke_config(arch) if case.get("smoke") else \
        jax_get_config(arch).replace(n_layers=2)
    return jcfg.replace(dtype="float32", remat="full")


def _jax_dropped(jcfg, params, batch, mb):
    """The (token, choice) pairs the reference's MoE layers drop in its
    forward of `batch` split into `mb` microbatches, counted from its own
    routing: per expert, the choices past its capacity C."""
    box = []
    plain = jax_model.moe_forward

    def counted(cfg, p, x, *, capacity_factor=None, dropless=False):
        m = cfg.moe
        B, S, D = x.shape
        T, E, K = B * S, m.n_experts, m.top_k
        cf = capacity_factor or m.capacity_factor
        C = min(T, max(1, int(-(-T * K // E) * cf)))
        probs = jax.nn.softmax(x.reshape(T, D).astype(jnp.float32)
                               @ p["router"].astype(jnp.float32), axis=-1)
        _, topi = jax.lax.top_k(probs, K)
        counts = jnp.zeros((E,), jnp.int32).at[topi.reshape(-1)].add(1)
        jax.debug.callback(lambda n: box.append(int(n)),
                           jnp.maximum(counts - C, 0).sum())
        return plain(cfg, p, x, capacity_factor=capacity_factor,
                     dropless=dropless)
    jax_model.moe_forward = counted
    try:
        n = batch["inputs"].shape[0] // mb
        for i in range(mb):
            part = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            jax.block_until_ready(jax_model.loss_fn(jcfg, params, part))
    finally:
        jax_model.moe_forward = plain
    return sum(box)


def _jax_run(case):
    """The reference's host-mesh step (jit) on the port's seeded init:
    (losses, gradient norms, {keystr: array} of the params and mu, the
    dropped pairs of each step's forward for a MoE config)."""
    jcfg = _jax_cfg(case)
    mb, comp = case.get("microbatches", 1), case.get("grad_compress", "none")
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                          _whole(_cfg(case)))
    ocfg = jopt.AdamWConfig(lr=1e-3, master_fp32=False)
    opt = jopt.adamw_init(params, ocfg)
    step = jax.jit(jax_make_train_step(jcfg, ocfg, microbatches=mb,
                                       warmup=WARMUP, grad_compress=comp))
    losses, norms, dropped = [], [], []
    for b in case["batches"]:
        if jcfg.moe is not None:
            dropped.append(_jax_dropped(jcfg, params, b, mb))
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms, _flat(jax.tree.map(np.asarray, {
        "params": params, "opt": {"mu": opt["mu"]}})), dropped


def _port_run(case, cfg=None):
    """The port on one device (`cfg`, by default the case's): (losses,
    gradient norms, state, the (aux, dropped pairs) of each step of a MoE
    config)."""
    cfg = cfg or _cfg(case)
    ocfg = AdamWConfig(lr=1e-3, master_fp32=False)
    params = _whole(cfg)
    opt = init_train_state(cfg, params, ocfg)
    step = make_train_step(cfg, ocfg, warmup=WARMUP,
                           microbatches=case.get("microbatches", 1),
                           grad_compress=case.get("grad_compress", "none"))
    losses, norms, moe = [], [], []
    for b in case["batches"]:
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        if "moe_dropped" in m:
            moe.append((float(m["aux"]), float(m["moe_dropped"])))
    return (losses, norms, _flat({"params": params, "opt": {"mu": opt["mu"]}}),
            moe)


def _flat(tree) -> dict:
    return {keystr(p): np.asarray(a) for p, a in leaves_with_paths(tree)}


_RUN: dict = {}


def _run():
    """Every mesh's cases in one spawn of four ranks; the reference's
    runs, the single device's and the one-device checkpoint here (once
    a process)."""
    if _RUN:
        return _RUN
    tmp = Path(tempfile.mkdtemp(prefix="train_mesh_families_"))
    cases = _cases(tmp)
    resume = cases[(2, 1)]["resume"]
    tr = Trainer(_cfg(resume), TrainerConfig(
        steps=2, ckpt_every=10 ** 9, ckpt_dir=resume["ckpt"],
        log_every=10 ** 9, warmup=WARMUP,
        opt=AdamWConfig(lr=1e-3, master_fp32=False)),
        iter(resume["batches"]), dtype="float32", device="cpu")
    tr.run()
    plan = [(shape, *MESHES[shape], cs) for shape, cs in cases.items()]
    ranks = spawn(train_meshes, ServeMesh(2, 2, ["cpu"] * 4), (plan,),
                  threads=1, timeout_s=300)
    held = {_ref_key(cases[s][k]): cases[s][k] for s, k in HELD}
    every = {_ref_key(c): c for cs in cases.values() for c in cs.values()}
    _RUN.update(tmp=tmp, cases=cases, ranks=ranks,
                jax={k: _jax_run(c) for k, c in held.items()},
                port={k: _port_run(c) for k, c in every.items()})
    return _RUN


def _mu_errors(got: dict, want: dict) -> dict:
    """{mu leaf: (max|got - want| / max|want|, ||got - want|| /
    ||want||)}."""
    return {k: (np.abs(got[k] - w).max() / max(np.abs(w).max(), 1e-30),
                np.linalg.norm(got[k] - w) / max(np.linalg.norm(w), 1e-30))
            for k, w in want.items() if not k.startswith("['params']")}


_FLOORS: dict = {}


def _mu_gate(case) -> float:
    """The bound on mu's largest entry error (of max|mu|) for the case's
    family: TOL, or FLOOR_X x its noise floor's where the floor moves a
    leaf of mu by TOL / 2 or more in norm (see the module doc)."""
    key = (case["arch"], bool(case.get("smoke")))
    if key not in _FLOORS:
        cfg = _cfg(case)
        if cfg.moe is not None:
            m = cfg.moe
            cfg = cfg.replace(moe=dataclasses.replace(
                m, capacity_factor=m.n_experts / m.top_k))
        rev = [{k: v[::-1].copy() for k, v in b.items()}
               for b in case["batches"]]
        base = {k: v for k, v in case.items()
                if k not in ("microbatches", "grad_compress")}
        fwd = _port_run(base, cfg)
        back = _port_run({**base, "batches": rev}, cfg)
        assert not any(d for _, d in fwd[3] + back[3])   # nothing drops
        errs = _mu_errors(back[2], fwd[2]).values()
        _FLOORS[key] = (max(e[0] for e in errs), max(e[1] for e in errs))
    floor_max, floor_norm = _FLOORS[key]
    if floor_norm < TOL / 2:
        return TOL
    return max(TOL, FLOOR_X * floor_max)


def _held_to(got: dict, want: dict, tol=TOL, mu_tol=TOL) -> None:
    """Each params leaf of `want` within tol x max|p| of `got`'s, p as
    test_torch_train_mesh.py takes it (1 + w for a leaf the rules
    replicate: norm scales, Mamba's per-channel leaves, whose zero-init
    conv_b moves ~lr a step and whose near-zero entries carry the
    reduction order's noise as a norm scale's do; else w); each leaf of
    mu within mu_tol x max|mu| (_mu_gate)."""
    for key, (err, _) in _mu_errors(got, want).items():
        assert err <= mu_tol, (key, err, mu_tol)
    for key, w in want.items():
        if not key.startswith("['params']"):
            continue
        norm = key.split("'")[-2] in REPLICATED_LEAVES
        scale = np.abs(1.0 + w if norm else w).max()
        err = np.abs(got[key] - w).max()
        assert err <= tol * scale, (key, err / scale)


def _mesh_ranks(run, shape):
    first = MESHES[shape][0]
    return run["ranks"][first:first + shape[0] * shape[1]]


@pytest.mark.parametrize("shape,key", HELD,
                         ids=[f"{s[0]}x{s[1]}-{k}" for s, k in HELD])
def test_family_trains_as_the_reference_and_one_device(shape, key):
    run = _run()
    case = run["cases"][shape][key]
    ranks = _mesh_ranks(run, shape)
    for ref in ("jax", "port"):
        losses, norms, state, _ = run[ref][_ref_key(case)]
        for r in ranks:
            got = r[(shape, key)]
            assert np.allclose(got["losses"], losses, rtol=TOL, atol=0), \
                (ref, got["losses"], losses)
            assert np.allclose(got["grad_norms"], norms, rtol=TOL, atol=0), \
                (ref, got["grad_norms"], norms)
        _held_to(ranks[0][(shape, key)]["state"], state,
                 mu_tol=_mu_gate(case))


@pytest.mark.parametrize("key", ["moe", "moe-int8"])
def test_moe_drops_the_references_pairs_on_every_mesh(key):
    """The reference drops tiny-moe's pairs at each step; the port's
    single device drops as many with the same aux loss, and so does
    every mesh, each data rank routing the whole microbatch."""
    run = _run()
    case = run["cases"][(2, 2)][key]
    want = run["jax"][_ref_key(case)][3]
    assert len(want) == STEPS and want[0] > 0, want
    one = run["port"][_ref_key(case)][3]
    assert [d for _, d in one] == want
    for shape in (MESHES if key == "moe" else [(2, 2)]):
        for r in _mesh_ranks(run, shape):
            got = r[(shape, key)]["moe"]
            assert [d for _, d in got] == want, (shape, got)
            assert np.allclose([a for a, _ in got], [a for a, _ in one],
                               rtol=TOL, atol=0), (shape, got, one)


def test_rank_local_routing_would_drop_another_set():
    """Routing each data rank's rows with its own capacity drops other
    (token, choice) pairs than the whole microbatch does, at tiny-moe's
    first layer (whose input is row by row the same either way)."""
    case = _run()["cases"][(2, 2)]["moe"]
    cfg = _cfg(case)
    params = _whole(cfg)
    b = {k: torch.from_numpy(v) for k, v in case["batches"][0].items()}
    with torch.no_grad():
        with count_drops() as whole:
            loss_fn(cfg, params, b)
        halves = []
        for d in range(2):
            with count_drops() as part:
                loss_fn(cfg, params, {k: v[2 * d:2 * d + 2]
                                      for k, v in b.items()})
            halves.append(part[0])
    assert whole[0].any()
    assert not torch.equal(torch.cat(halves), whole[0])


@pytest.mark.parametrize("shape", list(MESHES), ids=lambda s: f"{s[0]}x{s[1]}")
def test_ranks_hold_shard_params_blocks(shape):
    """Each rank's params, mu and nu have, leaf for leaf, the shapes of
    shard_params' cut of the whole init (its model-axis cut by the
    port's local spec, its data-axis block with FSDP), stacked."""
    run = _run()
    D, M = shape
    for key, case in run["cases"][shape].items():
        cfg = _cfg(case)
        per_layer = init_params(cfg, seed=0, device="cpu")
        for r, got in enumerate(_mesh_ranks(run, shape)):
            mesh = ServeMesh(D, M, ["cpu"] * (D * M), rank=r)
            cut = shard_params(cfg, per_layer, mesh,
                               fsdp=case.get("fsdp", True))
            want = {}
            for path, leaf in leaves_with_paths(
                    stack_params(cfg, _as_tensors(cut))):
                want[path] = tuple(leaf.shape)
            held = got[(shape, key)]["held"]
            assert held["params"] == want, key
            for path, s in held["opt"].items():
                if path != ("step",):
                    assert s == want[path[1:]], (key, path)


def _as_tensors(tree):
    """shard_params' tree with each FsdpLeaf as its block (stack_params
    takes tensors)."""
    if isinstance(tree, FsdpLeaf):
        return tree.fields["w"]
    if isinstance(tree, dict):
        return {k: _as_tensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_tensors(v) for v in tree]
    return tree


def test_jamba_checkpoints_resume_across_meshes():
    """jamba-smoke on (2, 2) saves at step 2 (whole, the reference's
    format) and one device resumes it to step 3; a one-device checkpoint
    at step 2 resumes on (2, 1). Both land on the single device's 3-step
    run."""
    run = _run()
    case = run["cases"][(2, 2)]["save"]
    want_losses, _, want, _ = run["port"][_ref_key(case)]
    want = {k: v for k, v in want.items() if k.startswith("['params']")}
    assert CheckpointManager(case["ckpt"]).committed_steps() == [2]
    tr = Trainer(_cfg(case), TrainerConfig(
        steps=STEPS, ckpt_every=10 ** 9, ckpt_dir=case["ckpt"],
        log_every=10 ** 9, warmup=WARMUP,
        opt=AdamWConfig(lr=1e-3, master_fp32=False)),
        iter(case["batches"][2:]), dtype="float32", device="cpu")
    assert tr.run()["resumed"]
    _held_to(_flat({"params": tr.params}), want)
    assert np.allclose([m["loss"] for m in tr.metrics_log], want_losses[2:],
                       rtol=TOL, atol=0)
    saved = run["ranks"][0][((2, 2), "save")]
    assert np.allclose(saved["losses"], want_losses[:2], rtol=TOL, atol=0)
    resumed = run["ranks"][0][((2, 1), "resume")]
    assert resumed["resumed"]
    assert np.allclose(resumed["losses"], want_losses[2:], rtol=TOL, atol=0)
    _held_to({k: v for k, v in resumed["state"].items()
              if k.startswith("['params']")}, want)


@pytest.mark.parametrize("arch", SWEEP)
def test_registry_trains_on_2x2_as_one_device(arch):
    run = _run()
    key = f"sweep/{arch}"
    case = run["cases"][(2, 2)][key]
    losses, norms, state, moe = run["port"][_ref_key(case)]
    for r in _mesh_ranks(run, (2, 2)):
        got = r[((2, 2), key)]
        assert np.allclose(got["losses"], losses, rtol=TOL, atol=0), \
            (got["losses"], losses)
        assert np.allclose(got["grad_norms"], norms, rtol=TOL, atol=0)
        assert [d for _, d in got["moe"]] == [d for _, d in moe]
    _held_to(run["ranks"][0][((2, 2), key)]["state"], state)
