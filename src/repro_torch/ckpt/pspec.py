"""The symbolic PartitionSpec rule that packed manifests record (the
port's copy of the reference's `dist/sharding.py:named_pspec` and
`_qt_pspec`, evaluated only at the symbolic mesh).

A manifest (format v3+) stores, per leaf, the mesh axes each dim would
shard over under the reference's GSPMD rules, with no axis sizes: at
the symbolic mesh every axis divides every dim, so `_guard` keeps each
axis. Specs are plain tuples here (entries None | axis name | tuple of
names); `pspec_to_json` writes them as the reference does. The port
itself runs on one card and reads none of this back yet (multi-GPU is
ROADMAP Queue 1 item 6); it writes the block so that its artifacts load
onto a mesh in the reference.

Conventions (2-axis mesh ("data", "model")):
  - "expand" projections (wq/wk/wv/wg/wu/...):  K on data, N on model
  - "contract" projections (wo/wd/out_proj):    K on model, N on data
  - embed (V, D): vocab on model, d_model on data; lm_head (D, V)
  - MoE expert stacks (G, E, K, N): experts on model
  - QuantizedTensor children shard like the dense weight they replace
    (codes: K on data / N on model; alphas/betas: N on model)
"""
from __future__ import annotations

SYMBOLIC_AXES = ("data", "model")
# projections whose *input* dim carries the model axis
_CONTRACT = {"wo", "wd", "out_proj"}
# matmul-weight leaves: any name starting with "w" plus these
_MATMUL_EXTRA = {"in_proj", "x_proj", "dt_w", "out_proj", "router",
                 "embed", "lm_head"}
_QT_LEAVES = {".codes", ".alphas", ".betas"}


def _is_matmul(name: str) -> bool:
    return name.startswith("w") or name in _MATMUL_EXTRA


def _guard(shape, spec, sizes):
    """Drop an axis whose size does not divide its dim (never at the
    symbolic mesh, where every size is 1)."""
    def div(n, axis):
        if axis is None:
            return True
        total = 1
        for a in (axis if isinstance(axis, tuple) else (axis,)):
            total *= sizes[a]
        return n % total == 0
    return tuple(a if div(d, a) else None for d, a in zip(shape, spec))


def named_pspec(names, shape, sizes=None, *, fsdp: bool = True) -> tuple:
    """The spec of the leaf at string path `names` with `shape`;
    QuantizedTensor children are addressed by appending ".codes" /
    ".alphas" / ".betas" to the weight's path. `sizes` maps axis ->
    size (default: the symbolic mesh)."""
    sizes = sizes or {a: 1 for a in SYMBOLIC_AXES}
    name = names[-1]
    shape = tuple(shape)
    data_ax = "data" if (fsdp and "data" in sizes) else None
    model_ax = "model" if "model" in sizes else None

    if name in _QT_LEAVES:
        return _qt_pspec(name, names[-2] if len(names) > 1 else "", shape,
                         sizes, data_ax, model_ax,
                         is_expert=any(n == "moe" for n in names))

    if len(shape) < 2 or not _is_matmul(name):
        return (None,) * len(shape)

    if name == "embed" and len(shape) == 2:
        return _guard(shape, (model_ax, data_ax), sizes)
    if name == "lm_head":
        return _guard(shape, (None,) * (len(shape) - 2) + (data_ax, model_ax),
                      sizes)

    is_expert = any(n == "moe" for n in names) and len(shape) >= 3 \
        and name != "router"
    if is_expert:
        lead = (None,) * (len(shape) - 3)
        E = shape[-3]
        if model_ax is not None and sizes[model_ax] and E % sizes[model_ax] == 0:
            # expert parallelism: E on model, FSDP on K, N replicated
            return _guard(shape, lead + (model_ax, data_ax, None), sizes)
        if name in _CONTRACT:
            return _guard(shape, lead + (None, model_ax, data_ax), sizes)
        return _guard(shape, lead + (None, data_ax, model_ax), sizes)

    lead = (None,) * (len(shape) - 2)
    if name in _CONTRACT:
        return _guard(shape, lead + (model_ax, data_ax), sizes)
    return _guard(shape, lead + (data_ax, model_ax), sizes)


def _qt_pspec(leaf_name, base_name, shape, sizes, data_ax, model_ax,
              is_expert=False):
    """QuantizedTensor children: codes (..., bits, K/32, N), alphas
    (..., G, N, bits), betas (..., G, N). Expert stacks (a leading E dim
    under a "moe" path) put E on the model axis; codes keep FSDP on the
    packed-K dim and scales replicate within an expert."""
    if base_name in _CONTRACT:
        k_ax, n_ax = model_ax, data_ax
    else:
        k_ax, n_ax = data_ax, model_ax
    base_rank = {".codes": 3, ".alphas": 3, ".betas": 2}[leaf_name]
    if (is_expert and base_name != "router" and len(shape) > base_rank
            and model_ax is not None and shape[0] % sizes[model_ax] == 0):
        mid = (None,) * (len(shape) - base_rank - 1)
        if leaf_name == ".codes":
            spec = (model_ax,) + mid + (None, data_ax, None)
        elif leaf_name == ".alphas":
            spec = (model_ax,) + mid + (None, None, None)
        else:  # .betas
            spec = (model_ax,) + mid + (None, None)
        return _guard(shape, spec, sizes)
    if leaf_name == ".codes":
        spec = (None,) * (len(shape) - 2) + (k_ax, n_ax)
    elif leaf_name == ".alphas":
        spec = (None,) * (len(shape) - 2) + (n_ax, None)
    else:  # .betas
        spec = (None,) * (len(shape) - 1) + (n_ax,)
    return _guard(shape, spec, sizes)


def pspec_to_json(spec) -> list:
    """Spec -> JSON-safe list (entries: None | str | [str])."""
    return [list(a) if isinstance(a, tuple) else a for a in spec]
