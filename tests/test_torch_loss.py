"""The port's training forward and loss (models/model.py: forward,
loss_fn; models/layers.py: cross_entropy) against the reference's, for
every config of the registry's ASSIGNED pool (as its smoke config) and
tiny-lm, tiny-moe and tiny-mla, hubert-xlarge's frame inputs included.

Same inputs: the reference's init_params(PRNGKey(0)) in its stacked
layout (the port's forward unbinds the stacked leaves, so gradients
come back per stacked leaf, as jax.grad gives them), a (2, 40) token
batch (or (2, 40, d_model) frames) and labels made from a numpy seed.
Tolerances, relative to the reference: logits and the MoE aux loss
within 1e-4 x max|ref|; the loss within 1e-4 x |ref|; every gradient
leaf within 1e-4 x max|g_ref| of that leaf (fp32 end to end in other
summation orders; measured <= 6e-6). Each remat policy (none, full,
dots) is held to the same reference values. MoE routing: a top-k
near-tie would switch experts between the packages and move the
gradients discontinuously, so the test records each MoE layer's gap
between the k-th and (k+1)-th router probability and requires it above
ROUTER_TIE_MARGIN (these inputs have none).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch.ckpt import params_from_tree
from repro_torch.ckpt.packed import _tensor
from repro_torch.configs import ASSIGNED, get_config, smoke_config
from repro_torch.core.api import forward_unrolled
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.tree import keystr, leaves, leaves_with_paths, tree_map
from torch_threads import one_torch_thread  # noqa: F401

NAMES = sorted(ASSIGNED) + ["tiny-lm", "tiny-moe", "tiny-mla"]
TOL = 1e-4
ROUTER_TIE_MARGIN = 1e-5
B, S = 2, 40

_ref: dict = {}


def _configs(name):
    tiny = name.startswith("tiny-")
    jcfg = (jax_get_config(name) if tiny else jax_smoke_config(name))
    cfg = (get_config(name) if tiny else smoke_config(name))
    return (jcfg.replace(dtype="float32", remat="none"),
            cfg.replace(dtype="float32"))


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return _tensor(np.asarray(tree))


def reference(name):
    """Inputs, the reference's params and its loss, metrics, logits and
    gradients (one jit of each per config, shared by the cases)."""
    st = _ref.get(name)
    if st is None:
        jcfg, cfg = _configs(name)
        p = jmodel.init_params(jcfg, jax.random.PRNGKey(0))
        rng = np.random.default_rng(0)
        if cfg.embed_input == "tokens":
            x = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        else:
            x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
        y = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
        batch = {"inputs": x, "labels": y}
        (loss, met), g = jax.jit(jax.value_and_grad(
            lambda pp: jmodel.loss_fn(jcfg, pp, batch), has_aux=True))(p)
        logits, aux = jax.jit(lambda pp: jmodel.forward(jcfg, pp, x))(p)
        st = _ref[name] = {
            "cfg": cfg, "params": jax.tree.map(np.asarray, p),
            "batch": batch, "loss": float(loss),
            "xent": float(met["xent"]), "aux": float(aux),
            "logits": np.asarray(logits),
            "grads": dict(leaves_with_paths(jax.tree.map(np.asarray, g)))}
    return st


class RouterGaps:
    """Records the smallest k-th vs (k+1)-th router probability gap of
    every MoE layer the port's forward runs while installed."""

    def __init__(self, monkeypatch):
        self.gaps = []
        inner = tmodel.moe_forward

        def wrapped(cfg, p, x, **kw):
            probs = torch.softmax(x.reshape(-1, x.shape[-1]).float()
                                  @ p["router"].float(), dim=-1)
            top = torch.topk(probs, cfg.moe.top_k + 1, dim=-1).values
            self.gaps.append(float((top[:, -2] - top[:, -1]).min()))
            return inner(cfg, p, x, **kw)
        monkeypatch.setattr(tmodel, "moe_forward", wrapped)


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("name", NAMES)
def test_loss_and_every_gradient_match_the_reference(name, remat,
                                                     monkeypatch):
    ref = reference(name)
    cfg = ref["cfg"]
    gaps = RouterGaps(monkeypatch)
    live = tree_map(lambda a: a.requires_grad_(),
                    _torch_tree(ref["params"]))
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    loss, met = tmodel.loss_fn(cfg, live, batch, remat=remat)
    grads = torch.autograd.grad(loss, leaves(live), allow_unused=True)
    assert abs(float(loss.detach()) - ref["loss"]) <= TOL * abs(ref["loss"])
    assert abs(float(met["xent"]) - ref["xent"]) <= TOL * abs(ref["xent"])
    assert abs(float(met["aux"]) - ref["aux"]) <= TOL * max(
        abs(ref["aux"]), 1.0)
    paths = [p for p, _ in leaves_with_paths(live)]
    assert sorted(map(keystr, paths)) == sorted(map(keystr, ref["grads"]))
    for path, g in zip(paths, grads):
        want = ref["grads"][path]
        got = np.zeros_like(want) if g is None else g.numpy()
        assert _rel(got, want) <= TOL, (keystr(path), _rel(got, want))
    if cfg.moe is not None:
        assert gaps.gaps and min(gaps.gaps) > ROUTER_TIE_MARGIN, gaps.gaps


@pytest.mark.parametrize("name", NAMES)
def test_forward_logits_and_aux_match_in_either_layout(name):
    """Logits and aux of the stacked tree and of the per-layer params
    params_from_tree makes, against the reference's forward."""
    ref = reference(name)
    cfg = ref["cfg"]
    x = torch.from_numpy(ref["batch"]["inputs"])
    stacked = _torch_tree(ref["params"])
    per_layer = params_from_tree(ref["params"], device="cpu")
    with torch.no_grad():
        for params in (stacked, per_layer):
            logits, aux = tmodel.forward(cfg, params, x)
            assert logits.shape == ref["logits"].shape
            assert _rel(logits.numpy(), ref["logits"]) <= TOL
            assert abs(float(aux) - ref["aux"]) <= TOL * max(
                abs(ref["aux"]), 1.0)
        if cfg.embed_input == "tokens":
            # calibration's forward is this forward
            assert torch.equal(forward_unrolled(cfg, per_layer, x),
                               tmodel.forward(cfg, per_layer, x,
                                              remat="none")[0])


def test_cross_entropy_masks_and_z_loss_match_the_reference():
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(-1, 50, (3, 7)).astype(np.int32)
    mask = rng.random((3, 7)) < 0.7
    for kw in ({}, {"mask": mask}, {"z_loss": 1e-3}, {"final_cap": 5.0},
               {"mask": mask, "z_loss": 1e-2, "final_cap": 3.0}):
        want = float(jlayers.cross_entropy(jnp.asarray(logits),
                                           jnp.asarray(labels), **kw))
        tkw = dict(kw)
        if "mask" in tkw:
            tkw["mask"] = torch.from_numpy(mask)
        got = float(tlayers.cross_entropy(torch.from_numpy(logits),
                                          torch.from_numpy(labels), **tkw))
        assert abs(got - want) <= 1e-6 * abs(want), (kw, got, want)
    # every label ignored: 0, not NaN
    none = tlayers.cross_entropy(torch.from_numpy(logits),
                                 torch.full((3, 7), -1))
    assert float(none) == 0.0


def test_stop_gradient_on_the_max_and_remat_refusal():
    """The max subtracted for stability carries no gradient (the softmax
    gradient comes out whole), and an unknown remat policy raises."""
    logits = torch.randn(2, 5, 11, requires_grad=True)
    labels = torch.randint(0, 11, (2, 5))
    (g,) = torch.autograd.grad(tlayers.cross_entropy(logits, labels),
                               logits)
    want = (torch.softmax(logits.detach(), -1)
            - torch.nn.functional.one_hot(labels, 11)) / 10
    assert torch.allclose(g, want, atol=1e-6)
    cfg = get_config("tiny-lm").replace(n_layers=1, dtype="float32")
    p = tmodel.init_params(cfg, device="cpu")
    x = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="remat policy"):
        tmodel.forward(cfg, p, x, remat="nope")
