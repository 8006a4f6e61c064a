"""AdamW with optional fp32 master weights (the reference's
`train/optimizer.py`).

The state mirrors the param tree: {"mu", "nu"} fp32 moments, "step"
(an int32 scalar) and, with `master_fp32`, "master", an fp32 copy of
the params. Trees are nested dicts in the reference's stacked layout
(models/model.py: {"blocks": {"L{i}": (n_groups, ...) leaves}}), so
the decay rule below sees each leaf at its stacked rank: per-layer
norms and Mamba's conv_b, dt_b and D are (n_groups, d) matrices there
and are decayed, as in the reference; only the top-level final_ln is
not. The global norm sums the leaves in the reference's flattening
order (tree.py).

On a mesh (dist/sharding.py:TrainLayout) a rank holds its block of each
leaf of the params, the moments and the master copy, and updates only
those (the update is elementwise); the global norm is the whole tree's,
each leaf's sum of squares summed over the groups that cut the block the
rank really holds (TrainLayout.axes: a Mamba per-channel leaf on the
model axis, MLA's whole latent leaves on none), a leaf a group
replicates counted once.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.dist.context import sync_grads
from repro_torch.tree import leaves, leaves_with_paths, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    master_fp32: bool = True     # keep fp32 master copy when params are bf16


def _stacked(params) -> None:
    if "layers" in params:
        raise ValueError(
            "the optimizer takes the stacked layout (its decay rule reads "
            "the stacked rank); stack per-layer params with "
            "ckpt.checkpoint.stack_params")


def adamw_init(params, cfg: AdamWConfig):
    _stacked(params)
    dev = leaves(params)[0].device

    def zeros(t):
        return tree_map(lambda a: torch.zeros(a.shape, dtype=torch.float32,
                                              device=a.device), t)
    state = {"mu": zeros(params), "nu": zeros(params),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if cfg.master_fp32:
        state["master"] = tree_map(
            lambda a: a.detach().to(torch.float32, copy=True), params)
    return state


def global_norm(tree, layout=None):
    """sqrt of the sum of squares of every leaf, in fp32, leaf by leaf in
    the reference's order; with a TrainLayout, of the whole tree whose
    blocks `tree` holds on this rank (each leaf's sum over the groups
    that cut it: one all-reduce over each axis of more than one rank)."""
    if layout is None:
        return torch.sqrt(sum(torch.sum(torch.square(a.float()))
                              for a in leaves(tree)))
    paths, flat = zip(*leaves_with_paths(tree))
    sums = torch.stack([torch.sum(torch.square(a.float())) for a in flat])
    for axis in ("data", "model"):
        cut = torch.tensor([axis in layout.axes(p) for p in paths],
                           device=sums.device)
        if cut.any():
            whole, = sync_grads([torch.where(cut, sums, 0.0)], axis,
                                layout.mesh)
            sums = torch.where(cut, whole, sums)
    return torch.sqrt(sum(sums.unbind()))


def adamw_update(grads, state, params, cfg: AdamWConfig, lr_scale=1.0,
                 layout=None):
    """Returns (new_params, new_state, metrics): global-norm clipping,
    bias-corrected moments, decoupled weight decay on leaves of stacked
    rank >= 2, all in fp32; new params in their own dtypes. With a
    TrainLayout the trees are a rank's blocks and the norm the whole
    tree's."""
    _stacked(params)
    gnorm = global_norm(grads, layout)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state["step"] + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t
    lr = cfg.lr * lr_scale

    def upd(g, m, v, p):
        g = g.float() * clip
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        mh = m / bc1
        vh = v / bc2
        pf = p.float()
        # decoupled weight decay on matrices only (ndim >= 2)
        wd = cfg.weight_decay if p.ndim >= 2 else 0.0
        pf = pf - lr * (mh / (torch.sqrt(vh) + cfg.eps) + wd * pf)
        return m, v, pf

    src = state.get("master", params)
    out = tree_map(upd, grads, state["mu"], state["nu"], src)
    new_f32 = tree_map(lambda o: o[2], out)
    new_params = tree_map(lambda a, p: a.to(p.dtype), new_f32, params)
    new_state = {"mu": tree_map(lambda o: o[0], out),
                 "nu": tree_map(lambda o: o[1], out), "step": step}
    if "master" in state:
        new_state["master"] = new_f32
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}

