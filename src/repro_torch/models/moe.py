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
"""
from __future__ import annotations

import torch

from repro_torch.hw import torch_dtype
from repro_torch.models.layers import init_linear


def init_moe(cfg, gen, dtype, device):
    """Router fp32 (D, E); expert stacks wg/wu (E, D, F), wd (E, F, D)
    from `gen` (the reference's distributions; the numbers differ)."""
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.n_experts
    scale = d ** -0.5

    def ew(a, b):
        return torch.randn((e, a, b), generator=gen, dtype=torch.float32,
                           device=device) * scale

    dt = torch_dtype(dtype)
    return {"router": init_linear(gen, d, e, "float32", device),
            "wg": ew(d, f).to(dt), "wu": ew(d, f).to(dt),
            "wd": (ew(f, d) * (f ** -0.5) / scale).to(dt)}


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


def moe_forward(cfg, p, x, *, capacity_factor=None):
    """x: (B, S, D) -> (out, aux_loss). Capacity C = ceil(T*k/E) * cf
    slots per expert (capped at T)."""
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    E, K = m.n_experts, m.top_k
    C = capacity(cfg, T, capacity_factor)

    xf = x.reshape(T, D)
    logits = xf.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    topv, topi = torch.topk(probs, K, dim=-1)               # (T, K)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)

    # load-balancing aux loss (Switch): E * sum_e f_e * P_e
    me = torch.mean(probs, dim=0)
    counts = torch.bincount(topi.reshape(-1), minlength=E)
    ce = counts.float() / (T * K)
    aux = E * torch.sum(me * ce)
    # filled slots of each expert, on the device (no host sync)
    rows = counts.clamp(max=C).int()

    # ---- sparse dispatch ----
    e_flat = topi.reshape(T * K)
    order = torch.argsort(e_flat, stable=True)
    se = e_flat[order]
    pos_in_e = (torch.arange(T * K, device=x.device)
                - torch.searchsorted(se, se, side="left"))
    keep = pos_in_e < C
    slot = torch.where(keep, se * C + pos_in_e, E * C)      # E*C = drop bin
    tok = order // K

    slot_tok = torch.full((E * C + 1,), T, dtype=torch.long, device=x.device)
    slot_tok[slot] = tok
    tok_slot = torch.empty_like(slot)               # (token, choice) -> slot
    tok_slot[order] = slot

    xpad = torch.cat([xf, torch.zeros((1, D), dtype=xf.dtype,
                                      device=x.device)])
    xe = xpad[slot_tok[:E * C]].reshape(E, C, D)

    # ---- expert computation (SwiGLU); an empty slot's h is silu(0)*0 = 0
    h = torch.nn.functional.silu(_expert_matmul(xe, p["wg"], rows))
    h = h * _expert_matmul(xe, p["wu"], rows)
    ye = _expert_matmul(h, p["wd"], rows)

    # ---- combine: each token's k slots (the drop bin is a zero row) ----
    ypad = torch.cat([ye.reshape(E * C, D),
                      torch.zeros((1, D), dtype=ye.dtype, device=x.device)])
    contrib = ypad[tok_slot].reshape(T, K, D) * topv[..., None].to(ye.dtype)
    return contrib.sum(dim=1).reshape(B, S, D), aux
