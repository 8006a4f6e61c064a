"""train_step factory (the reference's `train/train_step.py`): loss ->
gradients (the activation checkpoint of cfg.remat, microbatch
accumulation, optional int8 gradient-accumulator compression) -> AdamW.

Params and optimizer state are in the reference's stacked layout
(models/model.py:layer_params unbinds them inside the forward, so each
stacked leaf receives one gradient). Microbatching splits the global
batch into `microbatches` slices along the batch axis and accumulates
their gradients in fp32; with grad_compress="int8" the accumulator is
held as int8 + one fp32 scale per stacked leaf with an error-feedback
residual, as in the reference (round half to even in both packages).

On a (data, model) mesh (`mesh=`, bound, dist/context.py) the step
computes what the reference's sharded step computes, for every family
(dense, MoE, MLA, Mamba, hybrids). Every rank takes the global batch;
microbatch i is its rows [i B/mb, (i+1) B/mb), split over the data
ranks, as the reference's reshape of a batch-sharded array gives. A rank
holds its blocks of the params and the AdamW state
(dist/sharding.py:TrainLayout) and runs the shard-local config
(models/model.py:shard_config); the forward gathers each layer's
data-cut blocks inside its activation checkpoint, and the hooks'
backward (dist/context.py) sums each block's gradient over the data
group (reduce-scatter) and each column-parallel input's over the model
group. A MoE layer routes the whole microbatch over the data ranks
(models/moe.py), so every data rank's aux loss is the global one. Each
rank's loss is scaled by 1/D. Then, a microbatch at a time: the leaves
the data axis leaves whole are all-reduced over the data group, and the
attention leaves the model axis leaves whole (TrainLayout.model_partial:
wk and wv of whole_kv_leaves, the qk-norm scales, MLA's latent
projections and norms) over the model group, where each rank's gradient
is its heads' share. The int8 scale max|g| / 127 is the whole leaf's, an
all-reduce MAX over the mesh.

A MoE config's metrics also hold "aux" (the step's aux loss, the mean
over microbatches) and "moe_dropped" (the (token, choice) pairs past
their expert's capacity, summed over the MoE layers, microbatches and
data ranks; models/moe.py:count_drops), summed over the data group with
the loss.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from repro_torch.dist.context import mesh_context, reduce_max, sync_grads
from repro_torch.dist.fsdp import fsdp_view
from repro_torch.models.model import loss_fn
from repro_torch.models.moe import count_drops
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.train.schedule import cosine_with_warmup
from repro_torch.tree import leaves, leaves_with_paths, tree_map, unflatten


def _quantize_leaf(g, amax=None):
    """(int8 codes, fp32 scale max|g| / 127) of a leaf; `amax`: the whole
    leaf's max|g| where `g` is a rank's block of it."""
    amax = torch.amax(torch.abs(g)) if amax is None else amax
    scale = amax / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _quantize(fulls, mesh=None):
    """_quantize_leaf of each fp32 leaf of `fulls`, each scale the whole
    leaf's (its maximum over the mesh: one all-reduce MAX a mesh axis
    for every leaf at once; after `sync` the ranks that hold one block
    hold one gradient, so this is the MAX over the axes that cut the
    leaf, and replicas keep one scale)."""
    amax = torch.stack([torch.amax(torch.abs(g)) for g in fulls])
    if mesh is not None:
        amax = reduce_max(amax, mesh)
    return [_quantize_leaf(g, a) for g, a in zip(fulls, amax.unbind())]


def _to_device(batch, device):
    """A batch of numpy arrays or tensors -> tensors on `device`."""
    return {k: (v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v)))
            .to(device) for k, v in batch.items()}


def make_train_step(cfg, opt_cfg: AdamWConfig, *, microbatches: int = 1,
                    warmup: int = 100, total_steps: int = 10000,
                    grad_compress: str = "none", aux_coef: float = 0.01,
                    mesh=None, fsdp: bool = True):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics). batch = {"inputs": (B, S) or (B, S, D), "labels": (B, S)},
    numpy arrays or tensors (moved to the params' device). On a bound
    `mesh` of more than one rank the params and state are this rank's
    blocks (dist/sharding.py:shard_train_state, with the same `fsdp`),
    the batch the global one, and the metrics the whole step's."""
    if grad_compress not in ("none", "int8"):
        raise ValueError(f"grad_compress {grad_compress!r}: none or int8")
    layout = None
    if mesh is not None and mesh.size > 1:
        from repro_torch.dist.sharding import TrainLayout
        layout = TrainLayout(cfg, mesh, fsdp)
    D, d = (1, 0) if layout is None else (layout.D, mesh.coords[0])
    run_cfg = cfg if layout is None else layout.rank_cfg
    data_dims = None if layout is None else layout.data_dims()
    mb = microbatches

    def sync(params, gs):
        """Each gradient of this rank's microbatch rows -> the whole
        microbatch's gradient of the rank's block."""
        if layout is None:
            return gs
        paths = [p for p, _ in leaves_with_paths(params)]
        gs = list(gs)
        for axis, pick in (
                ("data", lambda p: "data" not in layout.axes(p)),
                ("model", layout.model_partial)):
            idx = [i for i, p in enumerate(paths) if pick(p)]
            for i, g in zip(idx, sync_grads([gs[i] for i in idx], axis,
                                            mesh)):
                gs[i] = g
        return gs

    def grads_of(params, batch):
        live = tree_map(lambda a: a.detach().requires_grad_(), params)
        on_mesh = (contextlib.nullcontext() if layout is None
                   else mesh_context(mesh))
        with on_mesh:
            view = live if layout is None else fsdp_view(live, data_dims, D)
            # the forward's drops (the backward's recompute runs outside)
            with count_drops() as drops:
                loss, met = loss_fn(run_cfg, view, batch, aux_coef=aux_coef)
            flat = leaves(live)
            gs = torch.autograd.grad(loss / D, flat, allow_unused=True)
        gs = [torch.zeros_like(a) if g is None else g
              for a, g in zip(flat, gs)]
        moe = None
        if drops:
            moe = torch.stack([met["aux"].detach().float(),
                               sum(x.sum() for x in drops).float()])
        return loss.detach(), moe, unflatten(params, sync(params, gs))

    def rows(batch):
        """This rank's rows of each microbatch of the global batch."""
        B = batch["inputs"].shape[0]
        if B % (mb * D):
            raise ValueError(f"batch {B} does not split into {mb} "
                             f"microbatches of {D} data ranks' rows")
        n = B // mb // D
        return [{k: v[i * (B // mb) + d * n:i * (B // mb) + (d + 1) * n]
                 for k, v in batch.items()} for i in range(mb)]

    def accumulate(params, batch):
        """-> (the loss, [aux, dropped pairs] of a MoE config or None,
        both summed over microbatches, and the gradients)."""
        if mb == 1 and layout is None:
            return grads_of(params, batch)
        micro = rows(batch)
        if mb == 1:
            return grads_of(params, micro[0])
        loss_sum, moe_sum = 0.0, None
        add = lambda a, b: b if a is None else a + b      # noqa: E731
        if grad_compress == "int8":
            acc = tree_map(lambda a: (torch.zeros(a.shape, dtype=torch.int8,
                                                  device=a.device),
                                      torch.ones((), dtype=torch.float32,
                                                 device=a.device)), params)
            resid = tree_map(lambda a: torch.zeros(
                a.shape, dtype=torch.float32, device=a.device), params)
            for mb_batch in micro:
                loss, moe, g = grads_of(params, mb_batch)
                # dequant + add + requant with error feedback
                fulls = [q.float() * s + r + gl.float() for (q, s), r, gl
                         in zip(leaves(acc), leaves(resid), leaves(g))]
                qs = _quantize(fulls, None if layout is None else mesh)
                acc = unflatten(params, qs)
                resid = unflatten(params, [f - q.float() * s for f, (q, s)
                                           in zip(fulls, qs)])
                loss_sum = loss_sum + loss
                moe_sum = None if moe is None else add(moe_sum, moe)
            grads = tree_map(lambda a, r: (a[0].float() * a[1] + r) / mb,
                             acc, resid)
            return loss_sum / mb, moe_sum, grads

        acc = tree_map(lambda a: torch.zeros(a.shape, dtype=torch.float32,
                                             device=a.device), params)
        for mb_batch in micro:
            loss, moe, g = grads_of(params, mb_batch)
            acc = tree_map(lambda a, b: a + b.float(), acc, g)
            loss_sum = loss_sum + loss
            moe_sum = None if moe is None else add(moe_sum, moe)
        grads = tree_map(lambda a: a / mb, acc)
        return loss_sum / mb, moe_sum, grads

    def train_step(params, opt_state, batch):
        batch = _to_device(batch, leaves(params)[0].device)
        loss, moe, grads = accumulate(params, batch)
        if layout is not None:
            # the global batch's loss: the mean of the data ranks' means;
            # a MoE config's drops summed with it (its aux is the global
            # one on every data rank already)
            vals = loss.reshape(1) if moe is None else torch.cat([
                loss.reshape(1), moe[1:]])
            vals, = sync_grads([vals], "data", mesh)
            loss = vals[0] / D
            if moe is not None:
                moe = torch.stack([moe[0], vals[1]])
        lr_scale = cosine_with_warmup(opt_state["step"], warmup=warmup,
                                      total=total_steps)
        params, opt_state, om = adamw_update(grads, opt_state, params,
                                             opt_cfg, lr_scale, layout)
        metrics = {"loss": loss, **om}
        if moe is not None:
            metrics.update(aux=moe[0] / mb, moe_dropped=moe[1])
        return params, opt_state, metrics

    return train_step


def init_train_state(cfg, params, opt_cfg: AdamWConfig):
    return adamw_init(params, opt_cfg)
