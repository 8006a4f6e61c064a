"""Weights sharded over the data axis (FSDP) on a serving mesh.

`load_packed(mesh=, fsdp=True)` and `shard_params(..., fsdp=True)` keep
the reference's data-axis placement on every weight leaf the rule puts
it on (dist/sharding.py:data_dims): a rank holds 1/D of each such leaf
beside its model-axis cut. Such a leaf is an `FsdpLeaf`: this rank's
block of each field (a plain weight's one tensor, or a QuantizedTensor's
codes, alphas and betas) and the dim the data axis cuts it along (None
for a field it leaves whole, like an expand leaf's scales).

Training keeps a rank's blocks as plain tensors (the optimizer and the
checkpoints walk them) and wraps the data-cut ones as FsdpLeafs for the
forward (`fsdp_view`); while autograd records, the gather's backward
reduce-scatters each block's gradient over the data group
(dist/context.py).

Serving runs the unchanged layer code and kernels on whole (model-
slice) weights: models/model.py gathers each layer's leaves over the
data group just before the layer runs (`gather_tree`), and the gathered
copy goes when the next layer's replaces it, so a rank holds its FSDP
slice plus one layer's weights at a time. Every data rank must therefore
run the same passes in the same order (serve/engine.py keeps them in
lockstep: a rank with no rows of its own joins each pass with masked
rows).
"""
from __future__ import annotations

import torch

from repro_torch.dist.context import gather_fsdp
from repro_torch.quant.qlinear import QuantizedTensor

_QT_FIELDS = ("codes", "alphas", "betas")


class FsdpLeaf:
    """This rank's FSDP block of one weight leaf: `fields` ({"w": t} for a
    plain weight, {"codes", "alphas", "betas"} for a QuantizedTensor of
    `k_in` input rows), each cut over the `parts`-way data axis along
    `dims[field]` (counted from the end; None: whole)."""

    def __init__(self, fields, dims, parts, k_in=None, orig_dtype=None):
        self.fields = dict(fields)
        self.dims = {f: dims.get(f) for f in self.fields}
        self.parts = int(parts)
        self.k_in = k_in
        self.orig_dtype = orig_dtype

    @property
    def quantized(self) -> bool:
        return "codes" in self.fields

    def _whole(self, field) -> tuple:
        t, dim = self.fields[field], self.dims[field]
        shape = list(t.shape)
        if dim is not None:
            shape[dim] *= self.parts
        return tuple(shape)

    @property
    def shape(self) -> tuple:
        """The gathered leaf's shape (a QuantizedTensor's (..., k_in,
        n_out))."""
        if not self.quantized:
            return self._whole("w")
        codes = self._whole("codes")
        return (*codes[:-3], self.k_in, codes[-1])

    @property
    def bits(self) -> int:
        return self.fields["alphas"].shape[-1]

    @property
    def device(self):
        return next(iter(self.fields.values())).device

    def tensors(self):
        return list(self.fields.values())

    def to(self, device) -> "FsdpLeaf":
        return FsdpLeaf({f: t.to(device) for f, t in self.fields.items()},
                        self.dims, self.parts, self.k_in, self.orig_dtype)

    def gather(self, mesh=None):
        """The whole leaf (this rank's model-axis slice of it): every
        cut field all-gathered over the data group. A QuantizedTensor
        gathers only the code planes its scales weight (a draft's
        leading planes)."""
        out = {}
        for f, t in self.fields.items():
            if f == "codes" and t.shape[-3] > self.bits:
                t = t[..., :self.bits, :, :].contiguous()
            dim = self.dims[f]
            out[f] = t if dim is None else gather_fsdp(t, dim, mesh)
        if not self.quantized:
            return out["w"]
        return QuantizedTensor(out["codes"], out["alphas"], out["betas"],
                               self.k_in, self.orig_dtype)

    def unbind(self, dim: int = 0) -> list:
        """A stacked leaf's blocks, one FsdpLeaf a group (dim 0 is the
        stack's group axis, which no cut dim, counted from the end,
        names)."""
        parts = {f: t.unbind(dim) for f, t in self.fields.items()}
        n = len(next(iter(parts.values())))
        return [FsdpLeaf({f: p[g] for f, p in parts.items()}, self.dims,
                         self.parts, self.k_in, self.orig_dtype)
                for g in range(n)]

    def draft_view(self, scales):
        """The draft of this leaf (quant/draft.py): the same code block,
        the draft's `scales` (alphas, betas), already cut as this leaf's
        scales are (a refit needs the gathered leaf: the engine makes
        them, serve/engine.py:_whole_row_scales)."""
        if scales is None:
            raise ValueError(
                "an FSDP block's draft takes its scales (a v4 draft "
                "block, or ServeEngine(speculate=)'s refit of the gathered "
                "leaf)")
        dt = self.fields["alphas"].dtype
        alphas, betas = (s.to(device=self.device, dtype=dt).contiguous()
                         for s in scales)
        return FsdpLeaf({"codes": self.fields["codes"], "alphas": alphas,
                         "betas": betas}, self.dims, self.parts, self.k_in,
                        self.orig_dtype)


def fsdp_leaf(fields, dims, parts, k_in=None, orig_dtype=None):
    """An FsdpLeaf of the cut `fields`, or the plain leaf (a tensor or a
    QuantizedTensor) where the data axis cuts none of them."""
    if any(dims.get(f) is not None for f in fields):
        return FsdpLeaf(fields, dims, parts, k_in, orig_dtype)
    if "w" in fields:
        return fields["w"]
    return QuantizedTensor(*(fields[f] for f in _QT_FIELDS), k_in,
                           orig_dtype)


def fsdp_view(tree, dims, parts: int):
    """A tree of plain tensors (a rank's blocks of the training state's
    params, dist/sharding.py:TrainLayout) with each leaf that `dims` (a
    tree of the same keys: the dim, from the end, the data axis cuts, or
    None) marks cut wrapped as an FsdpLeaf, for the forward to gather;
    the others are the same tensors."""
    if isinstance(tree, dict):
        return {k: fsdp_view(v, dims[k], parts) for k, v in tree.items()}
    return tree if dims is None else FsdpLeaf({"w": tree}, {"w": dims},
                                              parts)


def gather_tree(tree, mesh=None):
    """A tree of dicts and lists with every FsdpLeaf gathered; the other
    leaves are the same objects."""
    if isinstance(tree, FsdpLeaf):
        return tree.gather(mesh)
    if isinstance(tree, dict):
        return {k: gather_tree(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_tree(v, mesh) for v in tree)
    return tree


def is_fsdp(tree) -> bool:
    """Whether any leaf of the tree is an FsdpLeaf."""
    if isinstance(tree, FsdpLeaf):
        return True
    if isinstance(tree, dict):
        return any(is_fsdp(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(is_fsdp(v) for v in tree)
    return False
