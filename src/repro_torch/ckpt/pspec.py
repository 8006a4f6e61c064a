"""The symbolic spec that packed manifests record: dist/sharding.py's
rule (`named_pspec`, `_qt_pspec`) at the symbolic mesh, where every axis
divides every dim, so the guard keeps each axis. It holds no rule of its
own; the names below are the ones ckpt/packed.py writes manifests with.
"""
from __future__ import annotations

from types import SimpleNamespace

from repro_torch.dist import sharding
from repro_torch.dist.sharding import SYMBOLIC_AXES, pspec_to_json

__all__ = ["SYMBOLIC_AXES", "named_pspec", "pspec_to_json"]


def named_pspec(names, shape, *, fsdp: bool = True) -> tuple:
    """The symbolic spec of the leaf at string path `names` (the
    reference's stacked layout) with `shape`; QuantizedTensor children
    are addressed by appending ".codes" / ".alphas" / ".betas"."""
    return sharding.named_pspec(None, list(names),
                                SimpleNamespace(shape=tuple(shape)),
                                sharding.symbolic_mesh(), fsdp=fsdp)
