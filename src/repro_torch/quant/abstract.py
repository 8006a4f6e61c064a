"""Packed stand-ins on the meta device for the dry run (the reference's
`quant/abstract.py`): every eligible weight leaf becomes a
QuantizedTensor of meta tensors in the port's layout (int32 code words
(..., bits, ceil(K/32), N), fp32 alphas (..., G, N, bits) and betas
(..., G, N)), so a packed model's serving steps trace at full size with
nothing allocated.

Eligibility and each leaf's bit-width and group size come from the same
QuantSpec resolver the quantizer uses (quant/spec.py), with the
reference's dotted paths: layer j of the port's per-layer params is
slot "blocks.L{j % len(pattern)}" (core/api.py), so a spec with override
rules sizes each stand-in at its resolved bits, as the concrete
quantizer would emit it.
"""
from __future__ import annotations

import torch

from repro_torch.hw import WORD
from repro_torch.quant.qlinear import QuantizedTensor, tree_tensors
from repro_torch.quant.spec import QuantSpec, n_groups_for


def quantized_leaf_abstract(leaf, bits: int, group_size: int = 0):
    """leaf of shape (..., K, N) -> a QuantizedTensor of meta tensors:
    `bits` code planes, G = K / group_size scale groups (one when
    group_size is 0)."""
    *lead, K, N = leaf.shape
    G = n_groups_for(K, group_size)
    meta = dict(device="meta")
    return QuantizedTensor(
        torch.empty((*lead, bits, -(-K // WORD), N), dtype=torch.int32,
                    **meta),
        torch.empty((*lead, G, N, bits), dtype=torch.float32, **meta),
        torch.empty((*lead, G, N), dtype=torch.float32, **meta),
        K, str(leaf.dtype).removeprefix("torch."))


def quantize_params_abstract(cfg, params, bits=None, include_head=False,
                             spec=None):
    """params (per-layer {"layers": [...]} or the stacked {"blocks":
    ...} layout, any device) with every leaf the spec resolves replaced
    by its packed stand-in. Pass `bits` (uniform, over the config's
    quant defaults) or a whole `spec`."""
    if spec is None:
        spec = QuantSpec.from_config(cfg.quant, mode="packed",
                                     include_head=include_head)
        if bits is not None:
            spec = spec.replace(bits=bits)
    P = len(cfg.pattern)

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, (*path, k)) for k, v in tree.items()}
        if isinstance(tree, list):       # the per-layer list
            return [walk(v, ("blocks", f"L{j % P}"))
                    for j, v in enumerate(tree)]
        plan = spec.resolve(".".join(path), path[-1], tree.dim())
        return (quantized_leaf_abstract(tree, plan.bits, plan.group_size)
                if plan else tree)

    return walk(params, ())


def packed_param_bytes(params) -> int:
    """Bytes of every tensor of a tree of dicts and lists (packed
    QuantizedTensors counted by their codes and scales)."""
    return sum(t.numel() * t.element_size() for t in tree_tensors(params))
