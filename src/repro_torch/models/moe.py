"""Top-k routed Mixture-of-Experts with capacity-bounded sparse dispatch
(the reference's `models/moe.py`).

Gather-based dispatch: tokens are sorted by expert (stable), each expert
gets C equal capacity slots, tokens past an expert's capacity fall into
a drop bin, the experts run as (E, C, ·) batched SwiGLU, and each token
sums its top-k slots' weighted outputs. The reference scatter-adds the
slots into their tokens; the port gathers each token's k slots and sums
them in choice order instead, the same sum without atomics, so a run on
the card is deterministic. Expert weights are stacks
(E, D, F) / (E, F, D), plain or packed QuantizedTensors: a packed stack
runs the batched-expert BCQ kernel, one launch for all experts
(kernels/ops.py:bcq_apply), told each expert's filled slot count so it
skips the empty ones.

Expert parallelism (a mesh's model axis): a rank holds E / M experts,
the block at its model index. Routing and capacity stay those of all E
experts (the router replicates), so exactly the single device's tokens
are dropped; the rank runs its experts' slots, each token sums the
choices its experts served, and the caller sums over the model group
(models/model.py: reduce_model). In training the routing (logits,
probabilities, top-k weights, counts, aux loss) is replicated compute
on the plain input, with whole gradients on every model rank; only the
expert path's inputs, the tokens dispatched and the top-k weights of
the combine, go through copy_to_model, whose backward sums each rank's
share of their gradient.

A training step on a data axis routes the whole microbatch, as the
reference's global step does (dist/context.py:routes_over_data): the
capacity is that of the D ranks' tokens, a (token, choice) pair's
position in its expert counts the pairs of the data ranks before it
(one all-gather of the E counts), and the aux loss's two means are the
microbatch's (the probabilities' mean through a data-group sum with a
backward, the counts' without a gradient), so every data rank's aux is
the global one and drops exactly the single device's pairs.

`count_drops()` records, for each MoE forward run inside it, which of
this rank's (token, choice) pairs found their expert full.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.dist.context import (copy_to_model, data_coords,
                                      gather_counts, model_coords,
                                      reduce_fsdp, routes_over_data)
from repro_torch.hw import torch_dtype
from repro_torch.models import layers
from repro_torch.models.layers import init_linear, init_normal


def init_moe(cfg, gen, dtype, device):
    """Router fp32 (D, E); expert stacks wg/wu (E, D, F), wd (E, F, D)
    from `gen` (the reference's distributions; the numbers differ)."""
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.n_experts
    scale = d ** -0.5

    def ew(a, b, dt=dtype):
        return init_normal(gen, (e, a, b), scale, dt, device)

    return {"router": init_linear(gen, d, e, "float32", device),
            "wg": ew(d, f), "wu": ew(d, f),
            "wd": (ew(f, d, "float32") * (f ** -0.5) / scale).to(
                torch_dtype(dtype))}


def capacity(cfg, T: int, capacity_factor=None) -> int:
    """Slots per expert: C = min(T, max(1, int(ceil(T*k/E) * cf)))."""
    m = cfg.moe
    cf = capacity_factor or m.capacity_factor
    return min(T, max(1, int(-(-T * m.top_k // m.n_experts) * cf)))


def _expert_matmul(v, w, rows=None):
    """v (E, C, k) @ expert stack (E, k, n) -> (E, C, n). `rows` (E,)
    int32: the filled leading slots of each expert (the rest are zero
    rows), which lets the packed kernel skip empty experts."""
    if hasattr(w, "quantized_matmul"):
        return w.quantized_matmul(v, rows)
    return torch.einsum("eck,ekn->ecn", v, w.to(v.dtype))


def expert_counts(topi, E: int) -> torch.Tensor:
    """Choices routed to each expert, (E,) int64: torch.bincount's
    counts, made by a scatter-add that stays on the device (on CUDA
    bincount reads the maximum back to the host to size its output,
    which a captured CUDA graph cannot hold)."""
    flat = topi.reshape(-1)
    return torch.zeros(E, dtype=torch.long, device=topi.device).scatter_add_(
        0, flat, torch.ones_like(flat))


_DROPS: list = []


@contextlib.contextmanager
def count_drops():
    """Record the dropped pairs of every MoE forward run inside: yields
    a list that gets, a call, a (T, k) bool device tensor of this
    rank's tokens, True where the choice found its expert's capacity
    full (its slot weight is lost; the token keeps its other choices).
    A backward's recompute (the activation checkpoint), run outside,
    records nothing."""
    box: list = []
    _DROPS.append(box)
    try:
        yield box
    finally:
        _DROPS.pop()


def moe_forward(cfg, p, x, *, capacity_factor=None):
    """x: (B, S, D) -> (out, aux_loss). Capacity C = ceil(T*k/E) * cf
    slots per expert (capped at T), T the tokens routed together: x's,
    or in a training step on a data axis the microbatch's over every
    data rank."""
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    E, K = m.n_experts, m.top_k

    xf = x.reshape(T, D)
    logits = xf.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(probs, K, dim=-1)               # (T, K)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)

    # load-balancing aux loss (Switch): E * sum_e f_e * P_e
    me = torch.mean(probs, dim=0)
    counts = expert_counts(topi, E)
    if routes_over_data(xf):
        # the microbatch of every data rank routes as one
        d, n = data_coords()
        every = gather_counts(counts)                       # (D, E)
        before = every[:d].sum(0)
        C = capacity(cfg, T * n, capacity_factor)
        me = reduce_fsdp(me) / n
        ce = every.sum(0).float() / (T * n * K)
    else:
        before = None
        C = capacity(cfg, T, capacity_factor)
        ce = counts.float() / (T * K)
    aux = E * torch.sum(me * ce)
    # this rank's slots an expert (C, or its T tokens when fewer), and
    # each expert's filled ones, on the device (no host sync)
    Cl = min(C, T)
    rows = (counts.clamp(max=C) if before is None
            else torch.minimum(counts, (C - before).clamp(min=0))).int()

    # ---- sparse dispatch ----
    e_flat = topi.reshape(T * K)
    order = torch.argsort(e_flat, stable=True)
    se = e_flat[order]
    pos_in_e = (torch.arange(T * K, device=x.device)
                - torch.searchsorted(se, se, side="left"))
    keep = (pos_in_e if before is None else pos_in_e + before[se]) < C
    slot = torch.where(keep, se * Cl + pos_in_e, E * Cl)    # E*Cl: drop bin
    tok = order // K

    slot_tok = torch.full((E * Cl + 1,), T, dtype=torch.long,
                          device=x.device)
    slot_tok[slot] = tok
    tok_slot = torch.empty_like(slot)               # (token, choice) -> slot
    tok_slot[order] = slot
    if _DROPS:
        _DROPS[-1].append((tok_slot == E * Cl).reshape(T, K))

    # this rank's experts (all E outside a mesh): slots [e0*Cl, e1*Cl);
    # the expert path's inputs sum their gradients over the model group
    mi, M = model_coords()
    El = E // M
    e0 = mi * El
    rows = rows[e0:e0 + El]
    xpad = torch.cat([copy_to_model(xf),
                      torch.zeros((1, D), dtype=xf.dtype, device=x.device)])
    xe = xpad[slot_tok[e0 * Cl:(e0 + El) * Cl]].reshape(El, Cl, D)

    # ---- expert computation (SwiGLU); an empty slot's h is silu(0)*0 = 0
    layers.record(p["wg"], xe)     # calibration: per-expert inputs
    layers.record(p["wu"], xe)
    h = torch.nn.functional.silu(_expert_matmul(xe, p["wg"], rows))
    h = h * _expert_matmul(xe, p["wu"], rows)
    layers.record(p["wd"], h)
    ye = _expert_matmul(h, p["wd"], rows)

    # ---- combine: each token's k slots; the drop bin (and under a
    # model axis the slots of other ranks' experts) read the zero row ----
    ypad = torch.cat([ye.reshape(El * Cl, D),
                      torch.zeros((1, D), dtype=ye.dtype, device=x.device)])
    local = tok_slot
    if M > 1:
        local = tok_slot - e0 * Cl
        local = torch.where((local >= 0) & (local < El * Cl), local,
                            El * Cl)
    contrib = (ypad[local].reshape(T, K, D)
               * copy_to_model(topv)[..., None].to(ye.dtype))
    return contrib.sum(dim=1).reshape(B, S, D), aux
