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
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.model import loss_fn
from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.train.schedule import cosine_with_warmup
from repro_torch.tree import leaves, tree_map, unflatten


def _quantize_leaf(g):
    scale = torch.amax(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def _to_device(batch, device):
    """A batch of numpy arrays or tensors -> tensors on `device`."""
    return {k: (v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v)))
            .to(device) for k, v in batch.items()}


def make_train_step(cfg, opt_cfg: AdamWConfig, *, microbatches: int = 1,
                    warmup: int = 100, total_steps: int = 10000,
                    grad_compress: str = "none", aux_coef: float = 0.01):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics). batch = {"inputs": (B, S) or (B, S, D), "labels": (B, S)},
    numpy arrays or tensors (moved to the params' device)."""
    if grad_compress not in ("none", "int8"):
        raise ValueError(f"grad_compress {grad_compress!r}: none or int8")

    def grads_of(params, batch):
        live = tree_map(lambda a: a.detach().requires_grad_(), params)
        loss, met = loss_fn(cfg, live, batch, aux_coef=aux_coef)
        flat = leaves(live)
        gs = torch.autograd.grad(loss, flat, allow_unused=True)
        gs = [torch.zeros_like(a) if g is None else g
              for a, g in zip(flat, gs)]
        return loss.detach(), met, unflatten(params, gs)

    def accumulate(params, batch):
        if microbatches == 1:
            return grads_of(params, batch)
        B = batch["inputs"].shape[0]
        mb = microbatches
        if B % mb:
            raise ValueError(f"batch {B} does not split into {mb} "
                             f"microbatches")
        micro = [{k: v.reshape(mb, B // mb, *v.shape[1:])[i]
                  for k, v in batch.items()} for i in range(mb)]
        loss_sum = 0.0
        if grad_compress == "int8":
            acc = tree_map(lambda a: (torch.zeros(a.shape, dtype=torch.int8,
                                                  device=a.device),
                                      torch.ones((), dtype=torch.float32,
                                                 device=a.device)), params)
            resid = tree_map(lambda a: torch.zeros(
                a.shape, dtype=torch.float32, device=a.device), params)
            for mb_batch in micro:
                loss, _, g = grads_of(params, mb_batch)

                # dequant + add + requant with error feedback
                def upd(acc_leaf, r, gl):
                    q, s = acc_leaf
                    full = q.float() * s + r + gl.float()
                    q2, s2 = _quantize_leaf(full)
                    return (q2, s2), full - q2.float() * s2
                both = tree_map(upd, acc, resid, g)
                acc = tree_map(lambda t: t[0], both)
                resid = tree_map(lambda t: t[1], both)
                loss_sum = loss_sum + loss
            grads = tree_map(lambda a, r: (a[0].float() * a[1] + r) / mb,
                             acc, resid)
            return loss_sum / mb, {}, grads

        acc = tree_map(lambda a: torch.zeros(a.shape, dtype=torch.float32,
                                             device=a.device), params)
        for mb_batch in micro:
            loss, _, g = grads_of(params, mb_batch)
            acc = tree_map(lambda a, b: a + b.float(), acc, g)
            loss_sum = loss_sum + loss
        grads = tree_map(lambda a: a / mb, acc)
        return loss_sum / mb, {}, grads

    def train_step(params, opt_state, batch):
        batch = _to_device(batch, leaves(params)[0].device)
        loss, met, grads = accumulate(params, batch)
        lr_scale = cosine_with_warmup(opt_state["step"], warmup=warmup,
                                      total=total_steps)
        params, opt_state, om = adamw_update(grads, opt_state, params,
                                             opt_cfg, lr_scale)
        metrics = {"loss": loss, **om}
        return params, opt_state, metrics

    return train_step


def init_train_state(cfg, params, opt_cfg: AdamWConfig):
    return adamw_init(params, opt_cfg)
