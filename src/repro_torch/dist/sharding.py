"""Sharding rules for params and caches over a ("data", "model") mesh
(the port's copy of the reference's `dist/sharding.py`).

One rule set, two consumers: the packed-artifact manifest writer
(ckpt/packed.py, at the symbolic mesh) and mesh serving (each rank
keeps its own slice of every leaf: ckpt/packed.py:load_packed(mesh=),
shard_params below, and the engine's shard-local page pools). Rules are
total functions of (config, path, leaf shape, mesh) with a divisibility
guard: an axis is applied only when the dim is divisible by the mesh
axis size, otherwise it is dropped (the dim replicates).

Specs are plain tuples, one entry a dim: None (replicated), an axis name
or a tuple of axis names. A mesh is anything with `.axis_names` and a
`.devices` array whose shape gives the axis sizes: the port's ServeMesh
(dist/context.py), the symbolic mesh below, or a shape-only stand-in.

Conventions (2-axis mesh ("data", "model")):
  - "expand" projections (wq/wk/wv/wg/wu/...):  K on data (FSDP), N on model
  - "contract" projections (wo/wd/out_proj):    K on model, N on data
  - embed (V, D): vocab on model, d_model on data; lm_head transposed
  - MoE expert stacks (G, E, K, N): experts on model when E % model == 0
    (expert parallelism), else TP inside each expert
  - KV caches (G, B, H, S, hd): batch on data; heads on model when
    divisible, else *sequence* on model; B=1 shards sequence over both
  - paged KV pools (G, P, page, H, hd): pages on data, heads on model
  - QuantizedTensor leaves shard like the dense weight they replace
    (codes: K on data / N on model; alphas/betas: N on model)

Shapes are the reference's stacked ones (a leading n_groups axis on
block leaves); `local_slices` cuts one rank's block of a leaf by a spec.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

# projections whose *input* dim carries the model axis (the output of a
# model-sharded matmul feeds them, so no reshard between the pair)
_CONTRACT = {"wo", "wd", "out_proj"}
# matmul-weight leaves (everything else replicates): any name starting
# with "w" plus these
_MATMUL_EXTRA = {"in_proj", "x_proj", "dt_w", "out_proj", "router",
                 "embed", "lm_head"}
_QT_LEAVES = {".codes", ".alphas", ".betas"}
# Leaves models/ constructs that intentionally replicate (norm scales,
# per-channel vectors, SSM decay params): a new leaf either matches a
# placement rule below or is declared here, so replication is always a
# decision, never a silent default.
REPLICATED_LEAVES = frozenset({
    "ln", "ln2", "post_ln", "post_ln2", "final_ln",   # rmsnorm scales
    "qn", "kn", "q_a_norm", "kv_a_norm",              # qk / latent norms
    "conv_w", "conv_b", "dt_b", "A_log", "D",         # mamba per-channel
})


def _is_matmul(name: str) -> bool:
    return name.startswith("w") or name in _MATMUL_EXTRA


# --------------------------------------------------------------------------
# mesh helpers
# --------------------------------------------------------------------------

def mesh_axis_sizes(mesh) -> dict:
    """axis name -> size, for a ServeMesh or any shape-only stand-in
    with .axis_names and .devices. The one derivation: engine and
    launcher shard counts read it."""
    return dict(zip(tuple(mesh.axis_names), np.shape(mesh.devices)))


def _div(n: int, axis, sizes) -> bool:
    if axis is None:
        return True
    total = 1
    for a in (axis if isinstance(axis, tuple) else (axis,)):
        total *= sizes[a]
    return n % total == 0


def _guard(shape, spec, sizes) -> tuple:
    return tuple(a if _div(d, a, sizes) else None
                 for d, a in zip(shape, spec))


def batch_pspec(mesh, batch: int, rest=(None,)) -> tuple:
    """Batch-dim spec: all data-ish axes when divisible, the plain data
    axis as fallback, replicated otherwise. `rest` fills trailing dims."""
    sizes = mesh_axis_sizes(mesh)
    combo = tuple(a for a in ("pod", "data") if a in sizes)
    ax = None
    if combo and _div(batch, combo, sizes):
        ax = combo if len(combo) > 1 else combo[0]
    elif "data" in sizes and _div(batch, "data", sizes):
        ax = "data"
    return (ax, *rest)


# --------------------------------------------------------------------------
# params
# --------------------------------------------------------------------------

def named_pspec(cfg, names, leaf, mesh, *, fsdp: bool = True) -> tuple:
    """The spec of the parameter leaf at string path `names` (the
    reference's stacked layout: "blocks", "L{i}", ...). QuantizedTensor
    children are addressed by appending ".codes" / ".alphas" / ".betas"
    to the weight's path. `leaf` needs only a .shape."""
    sizes = mesh_axis_sizes(mesh)
    name = names[-1]
    shape = tuple(leaf.shape)
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
        if (model_ax is not None and sizes[model_ax]
                and E % sizes[model_ax] == 0):
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
    """QuantizedTensor children shard like the dense weight they stand
    in for: codes (..., bits, K/32, N), alphas (..., G, N, bits), betas
    (..., G, N). Batched-expert stacks (a leading E dim under a "moe"
    path) put E on the model axis when divisible; codes keep FSDP on the
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


# --------------------------------------------------------------------------
# caches
# --------------------------------------------------------------------------

def cache_pspec(cfg, names, leaf, mesh) -> tuple:
    """The spec of the cache leaf at string path `names` with the
    reference's stacked shape (G, ...)."""
    sizes = mesh_axis_sizes(mesh)
    name = names[-1]
    shape = tuple(leaf.shape)
    data_ax = "data" if "data" in sizes else None
    model_ax = "model" if "model" in sizes else None

    if name in ("k_pages", "v_pages") and len(shape) == 5:
        # (G, P, page, H, hd): pages across data, kv heads across model
        return _guard(shape, (None, data_ax, None, model_ax, None), sizes)

    if name in ("ckv_pages", "kpe_pages") and len(shape) == 5:
        # MLA latent pages (G, P, page, 1, r): pages across data; the
        # per-token latent and rope vectors replicate
        return _guard(shape, (None, data_ax, None, None, None), sizes)

    # binary-coded pool leaves (quant/kv.py): pages on data, kv heads on
    # model, for the codes and both scale leaves, so a page's codes and
    # scales always land on the same devices
    if name in ("k_codes", "v_codes", "k_alphas", "v_alphas") \
            and len(shape) == 6:
        # (G, P, page, H, bits, hd/32) / (G, P, page, H, Gk, bits)
        return _guard(shape, (None, data_ax, None, model_ax, None, None),
                      sizes)
    if name in ("k_betas", "v_betas") and len(shape) == 5:
        # (G, P, page, H, Gk)
        return _guard(shape, (None, data_ax, None, model_ax, None), sizes)

    if name in ("k", "v") and len(shape) == 5:
        G, B, H, S, hd = shape
        batch_ax = data_ax if _div(B, data_ax, sizes) else None
        head_ax = model_ax if _div(H, model_ax, sizes) else None
        seq_ax = None
        if head_ax is None and model_ax is not None:
            both = tuple(a for a in (data_ax, model_ax) if a)
            if batch_ax is None and len(both) > 1 and _div(S, both, sizes):
                seq_ax = both
            elif _div(S, model_ax, sizes):
                seq_ax = model_ax
        return (None, batch_ax, head_ax, seq_ax, None)

    if name in ("c_kv", "k_pe") and len(shape) == 4:   # MLA latent cache
        G, B, S, r = shape
        batch_ax = data_ax if _div(B, data_ax, sizes) else None
        seq_ax = model_ax if _div(S, model_ax, sizes) else None
        return (None, batch_ax, seq_ax, None)

    if name in ("ssm", "conv") and len(shape) >= 3:    # mamba state
        batch_ax = data_ax if _div(shape[1], data_ax, sizes) else None
        spec = [None, batch_ax] + [None] * (len(shape) - 2)
        # d_inner rides the model axis when divisible (last dim for conv,
        # dim 2 for ssm)
        di_dim = 2 if name == "ssm" else len(shape) - 1
        if _div(shape[di_dim], model_ax, sizes):
            spec[di_dim] = model_ax
        return tuple(spec)

    # unknown cache leaf: batch on data when it looks batched, else repl.
    if len(shape) >= 2 and _div(shape[1], data_ax, sizes):
        return (None, data_ax, *([None] * (len(shape) - 2)))
    return (None,) * len(shape)


# --------------------------------------------------------------------------
# symbolic specs (packed-artifact manifests)
# --------------------------------------------------------------------------
# A packed artifact records each leaf's *symbolic* spec (axis names
# without sizes), so any later mesh can place the leaf directly
# (ckpt/packed.py). The symbolic mesh has size-1 axes, which makes the
# divisibility guard vacuous: the rule's full intent survives into the
# manifest, and `guard_pspec` re-applies the guard against the real mesh
# at load time.

SYMBOLIC_AXES = ("data", "model")


class _SymbolicMesh:
    def __init__(self, axes):
        self.axis_names = tuple(axes)
        self.devices = np.empty((1,) * len(self.axis_names))


def symbolic_mesh(axes=SYMBOLIC_AXES):
    """Shape-only stand-in whose every axis divides everything: rules
    evaluated against it return the unguarded symbolic spec."""
    return _SymbolicMesh(axes)


def pspec_to_json(spec) -> list:
    """Spec -> JSON-safe list (entries: None | str | [str])."""
    return [list(a) if isinstance(a, tuple) else a for a in tuple(spec)]


def pspec_from_json(entries) -> tuple:
    return tuple(tuple(a) if isinstance(a, list) else a for a in entries)


def drop_axes(spec, axes) -> tuple:
    """Remove the named mesh axes from a spec (replicating those dims):
    serving loads drop "data" by default (weights replicate over the
    data-parallel shards; gathering them FSDP-style is training's
    concern)."""
    axes = set(axes)

    def keep(entry):
        if entry is None:
            return None
        if isinstance(entry, tuple):
            left = tuple(a for a in entry if a not in axes)
            return left if len(left) > 1 else (left[0] if left else None)
        return None if entry in axes else entry
    return tuple(keep(a) for a in tuple(spec))


def guard_pspec(shape, spec, mesh) -> tuple:
    """Re-apply the divisibility guard of a symbolic spec against a real
    mesh: an axis is dropped (dim replicated) when the mesh lacks it or
    the dim does not divide its size. Short specs are padded with None
    to the leaf's rank."""
    sizes = mesh_axis_sizes(mesh)
    entries = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))

    def ok(dim, ax):
        if ax is None:
            return True
        axes = ax if isinstance(ax, tuple) else (ax,)
        if any(a not in sizes for a in axes):
            return False
        return _div(dim, ax, sizes)

    return tuple(a if ok(d, a) else None for d, a in zip(shape, entries))


# --------------------------------------------------------------------------
# one rank's block of a leaf
# --------------------------------------------------------------------------

def local_slices(shape, spec, mesh, coords: dict) -> tuple:
    """The index (a slice a dim) of the block of a `shape` leaf that the
    rank at `coords` ({axis: index}) holds under the guarded `spec`. A
    dim over several axes splits major-to-minor in the order named."""
    sizes = mesh_axis_sizes(mesh)
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * len(shape)):
        if ax is None:
            out.append(slice(None))
            continue
        n, i = 1, 0
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            n, i = n * sizes[a], i * sizes[a] + coords[a]
        step = dim // n
        out.append(slice(i * step, (i + 1) * step))
    return tuple(out)


def local_shape(shape, spec, mesh) -> tuple:
    """The shape of one rank's block of a `shape` leaf under `spec`."""
    sizes = mesh_axis_sizes(mesh)
    out = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * len(shape)):
        n = 1
        for a in (() if ax is None else ax if isinstance(ax, tuple)
                  else (ax,)):
            n *= sizes[a]
        out.append(dim // n)
    return tuple(out)


# --------------------------------------------------------------------------
# a rank's slice of the weights
# --------------------------------------------------------------------------
# The serving steps run the layer code on each rank's slice of every
# leaf, so where the rule puts the model axis on a dim the slice must
# really be cut there: a dim the axis does not divide raises (the
# reference's guard would replicate it and let GSPMD gather). Two
# exceptions: the router replicates (every rank routes every token over
# all E experts, models/moe.py), and a vocabulary the axis does not
# divide replicates (models/model.py looks up and unembeds either way).
#
# The specs are GSPMD's, which keeps a leaf's global meaning however it
# is cut. The port computes on each rank's block, so a few leaves are
# cut otherwise than their spec says (`_local_spec`; manifests keep the
# spec):
#   - Mamba's in_proj (d, 2 di) holds [x | z]: a rank takes its d_inner
#     columns of each half (a contiguous cut would hand one rank all of
#     x and the other all of z);
#   - Mamba's per-channel leaves, which the rule replicates, are cut on
#     d_inner with the state they act on;
#   - Mamba's x_proj (di, dt_rank + 2 d_state) contracts over d_inner:
#     its rows are cut (the spec cuts its columns), and the model group
#     sums its features (models/mamba.py);
#   - MLA's wq_a and wkv_a stay whole: every rank needs the whole latent
#     and its norm, as the reference's replicated latent pages hold it;
#   - wk and wv stay whole where the model axis does not divide the KV
#     heads (`whole_kv_leaves`): every rank computes every KV head into
#     its replica of the pool (or of the dense cache), which the rule
#     replicates over the model axis, and its query heads read theirs;
#   - a frame-input config's input projection "embed" stays whole
#     (`_frame_embed`).
#
# With fsdp=True a rank also keeps only its block of the dim the rule
# puts the data axis on (`data_dims`, `cut_data`), as the reference's
# spec does with fsdp=True: dist/fsdp.py gathers it before use.

_VOCAB = {"embed", "lm_head"}
# Mamba's per-channel leaves: the dim, from the end, that holds d_inner
_MAMBA_CHANNELS = {"conv_w": -1, "conv_b": -1, "dt_b": -1, "D": -1,
                   "A_log": -2}
_MLA_WHOLE = {"wq_a", "wkv_a"}


def _axes(spec) -> set:
    out = set()
    for a in spec:
        out |= set(a) if isinstance(a, tuple) else {a}
    return out - {None}


def _contiguous(a):
    return a.contiguous() if hasattr(a, "contiguous") \
        else np.ascontiguousarray(a)


def cuts_k(names) -> bool:
    """Whether a rank holds the rows of the weight at `names` (its
    contracted dim split over the model axis; the model group sums the
    partial products): wo, wd, out_proj and Mamba's x_proj, but no
    expert stack (those split E)."""
    if "moe" in names:
        return False
    return names[-1] in _CONTRACT or (names[-1] == "x_proj"
                                      and "mamba" in names)


def whole_kv_leaves(cfg, mesh) -> frozenset:
    """The leaves a rank of `mesh` keeps whole for `cfg`: wk and wv where
    the model axis does not divide n_kv_heads (none without a config)."""
    M = mesh_axis_sizes(mesh).get("model", 1)
    if cfg is None or cfg.mla is not None or M == 1 \
            or cfg.n_kv_heads % M == 0:
        return frozenset()
    return frozenset({"wk", "wv"})


def _frame_embed(cfg) -> frozenset:
    """{"embed"} for a frame-input config: its "embed" is the (D, D)
    input projection, which the rule cuts as a vocabulary (rows on the
    model axis); every rank needs its whole output, so it stays whole on
    the model axis."""
    return frozenset({"embed"}) if cfg.embed_input != "tokens" \
        else frozenset()


def _local_spec(names, ndim, symbolic, field=None, whole=()) -> tuple:
    """(the spec the port cuts the leaf at `names`, or that
    QuantizedTensor's `field`, by; the number of equal parts its
    model-axis dim is split into first, each cut on its own). Leaves
    named in `whole` (whole_kv_leaves) stay whole on the model axis."""
    leaf, mamba = names[-1], "mamba" in names
    if mamba and leaf in _MAMBA_CHANNELS:
        spec = [None] * ndim
        spec[_MAMBA_CHANNELS[leaf]] = "model"
        return tuple(spec), 1
    if mamba and leaf == "x_proj":
        if field in ("alphas", "betas"):
            return (None,) * ndim, 1
        return (None,) * (ndim - 2) + ("model", None), 1
    if leaf in _MLA_WHOLE or leaf in whole:
        return (None,) * ndim, 1
    return tuple(symbolic), 2 if mamba and leaf == "in_proj" else 1


def _serving_spec(names, shape, symbolic, mesh) -> tuple:
    """The symbolic spec without the data axis (weights replicate over
    data ranks), guarded against `mesh`; raises where the guard drops
    the model axis of a leaf the steps need split."""
    want = drop_axes(symbolic, ("data",))
    spec = guard_pspec(shape, want, mesh)
    if ("model" in _axes(want) and "model" not in _axes(spec)
            and names[-1] not in _VOCAB):
        raise ValueError(
            f"{'/'.join(names)} {tuple(shape)}: the "
            f"{mesh_axis_sizes(mesh)['model']}-way model axis does not "
            f"divide the dim the rule {tuple(want)} splits")
    return spec


def _cut(a, spec, mesh, parts, where):
    """This rank's block of `a` (numpy or torch) under the guarded
    `spec`, contiguous. With `parts` > 1 the model-axis dim is first
    split into `parts` equal segments and the rank takes its block of
    each, in order."""
    d, m = mesh.coords
    if parts == 1:
        return _contiguous(a[local_slices(a.shape, spec, mesh,
                                          {"data": d, "model": m})])
    dim = next(i for i, ax in enumerate(spec) if ax == "model")
    n, M = a.shape[dim], mesh_axis_sizes(mesh)["model"]
    if n % (parts * M):
        raise ValueError(f"{where} {tuple(a.shape)}: the {M}-way model "
                         f"axis does not divide each of its {parts} parts "
                         f"of {n}")
    piece = n // parts // M
    lead, rest = tuple(a.shape[:dim]), tuple(a.shape[dim + 1:])
    idx = (slice(None),) * (dim + 1) + (slice(m * piece, (m + 1) * piece),)
    out = a.reshape(lead + (parts, n // parts) + rest)[idx]
    return _contiguous(out.reshape(lead + (parts * piece,) + rest))


def data_dims(names, specs) -> dict:
    """field -> the dim (counted from the end) fsdp cuts over the data
    axis, or None: where the field's symbolic spec names the data axis;
    an expert stack's codes on their packed K, its scales whole (the
    rule for expert parallelism). `specs`: {field: symbolic spec}."""
    out = {}
    for f, spec in specs.items():
        spec = tuple(spec)
        out[f] = next((i - len(spec) for i, a in enumerate(spec)
                       if a == "data" or (isinstance(a, tuple)
                                          and "data" in a)), None)
    if "moe" in names and "codes" in specs and names[-1] != "router":
        out = {f: -2 if f == "codes" else None for f in out}
    return out


def cut_data(a, dim, mesh):
    """(this rank's block of `a` (numpy or torch) along `dim` over the
    data axis, contiguous; dim), or (a, None) where the axis has size 1
    or does not divide the dim (which then replicates, as the guard
    does)."""
    D = mesh_axis_sizes(mesh)["data"]
    if dim is None or D == 1 or a.shape[dim] % D:
        return a, None
    n, d = a.shape[dim] // D, mesh.coords[0]
    idx = [slice(None)] * a.ndim
    idx[dim] = slice(d * n, (d + 1) * n)
    return _contiguous(a[tuple(idx)]), dim


def shard_array(names, arr, symbolic, mesh, whole=()):
    """This rank's block of the dense leaf `arr` (numpy or torch) at
    `names` under its symbolic spec (as `_local_spec` reads it for the
    port's steps) on the model axis, contiguous; the data axis is
    `cut_data`'s."""
    if names[-1] == "router":
        return arr
    local, parts = _local_spec(names, arr.ndim, symbolic, whole=whole)
    spec = _serving_spec(names, arr.shape, local, mesh)
    return _cut(arr, spec, mesh, parts, "/".join(names))


def _qt_plan(names, shapes, k_in, specs, mesh, whole=()):
    """How a QuantizedTensor's fields of `shapes` ({"codes", "alphas",
    "betas"}) are cut under their symbolic `specs`: -> (guarded spec a
    field, parts of the model dim, this rank's K)."""
    M = mesh_axis_sizes(mesh)["model"]
    parts = 1
    if "moe" in names and len(shapes["codes"]) == 5:
        # a stacked expert stack (G, E, ...): the reference's _qt_pspec
        # puts the model axis on dim 0, the stack's layer-group axis;
        # the port's expert parallelism splits E (dim 1), as the rule
        # for a dense expert stack does
        if shapes["codes"][1] % M:
            raise ValueError(f"{'/'.join(names)}: a {M}-way model axis "
                             f"does not divide {shapes['codes'][1]} "
                             f"experts")
        specs = {f: (None, "model") + (None,) * (len(s) - 2)
                 for f, s in shapes.items()}
    else:
        local = {f: _local_spec(names, len(s), specs[f], f, whole)
                 for f, s in shapes.items()}
        specs = {f: sp for f, (sp, _) in local.items()}
        parts = local["codes"][1]
    spec = {f: _serving_spec(names + (f".{f}",), s, specs[f], mesh)
            for f, s in shapes.items()}
    if spec["codes"][-2] == "model":
        where = "/".join(names)
        if k_in % (32 * M):
            raise ValueError(f"{where}: K={k_in} does not split into "
                             f"{M} whole blocks of 32-bit code words")
        G = shapes["alphas"][-3]
        if G > 1:
            if (k_in // M) % (k_in // G):
                raise ValueError(
                    f"{where}: {G} scale groups of {k_in // G} rows "
                    f"straddle the {M} shards of K={k_in}")
            spec["alphas"] = spec["alphas"][:-3] + ("model",) \
                + spec["alphas"][-2:]
            spec["betas"] = spec["betas"][:-2] + ("model",) \
                + spec["betas"][-1:]
        k_in //= M
    return spec, parts, k_in


def shard_qt(names, codes, alphas, betas, k_in, specs, mesh, whole=()):
    """This rank's block of a QuantizedTensor's fields (numpy or torch)
    under their symbolic specs {"codes", "alphas", "betas"}: -> (codes,
    alphas, betas, k_in). A column (or expert) split cuts the scales
    with the codes. A K split (wo, wd, out_proj, x_proj: codes on model
    along the packed K words) keeps a per-channel leaf's one group for
    every shard's rows and cuts group-wise scales with the rows when a
    group never straddles two shards; otherwise it raises naming the
    leaf."""
    fields = {"codes": codes, "alphas": alphas, "betas": betas}
    spec, parts, k_in = _qt_plan(
        names, {f: tuple(a.shape) for f, a in fields.items()}, k_in, specs,
        mesh, whole)
    where = "/".join(names)
    return (*(_cut(a, spec[f], mesh, parts, where)
              for f, a in fields.items()), k_in)


def shard_draft_scales(names, alphas, betas, k_in, specs, mesh, whole=(),
                       fsdp=False):
    """A draft block's (alphas, betas) (quant/draft.py: fewer planes than
    the leaf's own scales) cut as shard_qt (and with `fsdp`, cut_data)
    cuts the scales of the QuantizedTensor at `names` (K rows `k_in`,
    symbolic `specs`)."""
    lead = tuple(alphas.shape[:-3])
    shapes = {"codes": lead + (1, -(-k_in // 32), alphas.shape[-2]),
              "alphas": tuple(alphas.shape), "betas": tuple(betas.shape)}
    spec, parts, _ = _qt_plan(names, shapes, k_in, specs, mesh, whole)
    where = "/".join(names)
    out = (_cut(alphas, spec["alphas"], mesh, parts, where),
           _cut(betas, spec["betas"], mesh, parts, where))
    if fsdp:
        dims = data_dims(names, specs)
        out = tuple(cut_data(a, dims[f], mesh)[0]
                    for a, f in zip(out, ("alphas", "betas")))
    return out


def shard_params(cfg, params, mesh, fsdp: bool = False):
    """An unsharded tree in the port's per-layer layout -> this rank's
    slice of it (the same cut load_packed(mesh=, fsdp=) makes from a
    manifest's specs: each leaf's spec is the rule at the symbolic mesh,
    its layer addressed as the reference's stacked "blocks"/"L{i}").
    With `fsdp` a leaf the data axis cuts is a dist/fsdp.py FsdpLeaf of
    this rank's block."""
    from repro_torch.dist.fsdp import fsdp_leaf
    from repro_torch.quant.qlinear import QuantizedTensor

    sym = symbolic_mesh()
    P = len(cfg.pattern)
    whole = whole_kv_leaves(cfg, mesh) | _frame_embed(cfg)
    D = mesh_axis_sizes(mesh)["data"]

    def data_cut(names, fields, specs):
        """-> (fields, dims) after the data cut (none without fsdp)."""
        if not fsdp:
            return fields, {}
        dims = data_dims(names, specs)
        out = {f: cut_data(a, dims[f], mesh) for f, a in fields.items()}
        return ({f: a for f, (a, _) in out.items()},
                {f: d for f, (_, d) in out.items()})

    def walk(node, names, stacked):
        if isinstance(node, dict):
            return {k: walk(v, names + (k,), stacked)
                    for k, v in node.items()}
        lead = (lambda t: t[None]) if stacked else (lambda t: t)
        cut = (lambda t: t[0]) if stacked else (lambda t: t)
        if isinstance(node, QuantizedTensor):
            f = {k: lead(getattr(node, k))
                 for k in ("codes", "alphas", "betas")}
            specs = {k: named_pspec(cfg, names + (f".{k}",), a, sym)
                     for k, a in f.items()}
            c, a, b, k_in = shard_qt(names, f["codes"], f["alphas"],
                                     f["betas"], node.k_in, specs, mesh,
                                     whole)
            fields, dims = data_cut(names, {"codes": c, "alphas": a,
                                            "betas": b}, specs)
            return fsdp_leaf({k: cut(t) for k, t in fields.items()}, dims,
                             D, k_in, node.orig_dtype)
        arr = lead(node)
        spec = named_pspec(cfg, names, arr, sym)
        fields, dims = data_cut(names, {"w": shard_array(
            names, arr, spec, mesh, whole)}, {"w": spec})
        return fsdp_leaf({"w": cut(fields["w"])}, dims, D)

    out = {k: walk(v, (k,), False) for k, v in params.items()
           if k != "layers"}
    out["layers"] = [walk(lp, ("blocks", f"L{i % P}"), True)
                     for i, lp in enumerate(params["layers"])]
    return out


# --------------------------------------------------------------------------
# the training state on a mesh
# --------------------------------------------------------------------------
# Training keeps the reference's stacked layout ({"blocks": {"L{i}":
# (n_groups, ...) leaves}}, models/model.py) and cuts each params leaf as
# shard_params cuts it for serving: on the model axis as `_local_spec`
# reads the reference's spec (the router, MLA's wq_a / wkv_a and, where
# the axis does not divide the KV heads, wk / wv whole; Mamba's in_proj
# by halves, x_proj by rows, the per-channel leaves on d_inner), on the
# data axis (with fsdp) where the reference's spec puts it (`data_dims`),
# inside the model block where both cut one dim (x_proj's rows). Each
# AdamW moment and the fp32 master copy is cut as the param it mirrors,
# the step replicated. A rank holds plain tensors, its block of every
# leaf; the forward gathers the data-cut ones layer by layer
# (dist/fsdp.py:fsdp_view). `axes`, the gradient sums, the global norm
# and the int8 scale read the cut a rank really holds; `gather` rebuilds
# the reference's whole leaf (in_proj's [x | z] order).

def require_expert_parallel(cfg, M: int) -> None:
    """A training mesh splits a MoE config's experts over its model axis
    (expert parallelism); where the `M`-way axis does not divide them,
    the reference cuts inside each expert (TP-in-expert), which the port
    does not: ValueError naming the ROADMAP item that takes it."""
    if (M > 1 and cfg.moe is not None
            and any(s.mlp == "moe" for s in cfg.pattern)
            and cfg.moe.n_experts % M):
        raise ValueError(
            f"{cfg.name}: a {M}-way model axis does not divide its "
            f"{cfg.moe.n_experts} experts; training with the model axis "
            f"inside each expert is ROADMAP Queue 1 item 6.5, still to do")


class _Cut(NamedTuple):
    """How TrainLayout cuts a params leaf: its whole shape, the guarded
    model-axis spec (no data axis) and the parts its model dim splits
    into first (shard_params' `_cut`), and the dim, from the end, the
    data axis then cuts (or None)."""
    shape: tuple
    model: tuple
    parts: int
    data: Optional[int]


class TrainLayout:
    """How the training state of `cfg` is cut over the bound `mesh`, with
    or without the data axis on the weights (`fsdp`). Paths are key
    tuples of the state {"params": ..., "opt": {"mu", "nu", ["master"],
    "step"}} or of the params tree alone. Every family: dense, MoE (with
    its experts on the model axis), MLA, Mamba and hybrids."""

    def __init__(self, cfg, mesh, fsdp: bool = True):
        from repro_torch.ckpt.checkpoint import stack_params
        from repro_torch.models.model import init_params, shard_config
        from repro_torch.tree import leaves_with_paths
        sizes = mesh_axis_sizes(mesh)
        self.cfg, self.mesh, self.fsdp = cfg, mesh, bool(fsdp)
        self.D, self.M = sizes["data"], sizes["model"]
        require_expert_parallel(cfg, self.M)
        self.rank_cfg = shard_config(cfg, self.M, train=True)
        whole = whole_kv_leaves(cfg, mesh) | _frame_embed(cfg)
        sym = symbolic_mesh()
        # params path -> _Cut
        self.cuts = {}
        meta = stack_params(cfg, init_params(cfg, device="meta"))
        for path, leaf in leaves_with_paths(meta):
            shape = tuple(leaf.shape)
            want = named_pspec(cfg, path, leaf, sym)
            local, parts = ((None,) * len(shape), 1) \
                if path[-1] == "router" else \
                _local_spec(path, len(shape), want, whole=whole)
            spec = _serving_spec(path, shape, local, mesh)
            if self.M == 1 or "model" not in spec:
                spec, parts = (None,) * len(shape), 1
            dim = data_dims(path, {"w": want})["w"] if self.fsdp else None
            if dim is not None and (self.D == 1 or local_shape(
                    shape, spec, mesh)[dim] % self.D):
                dim = None
            self.cuts[path] = _Cut(shape, spec, parts, dim)

    @staticmethod
    def param_path(path) -> tuple:
        """The params path a state path mirrors; None for the step."""
        path = tuple(path)
        if path[:1] == ("params",):
            return path[1:]
        if path[:1] == ("opt",):
            return None if path[1:2] == ("step",) else path[2:]
        return path

    def axes(self, path) -> set:
        """The mesh axes that cut the leaf at `path`."""
        p = self.param_path(path)
        if p is None:
            return set()
        c = self.cuts[p]
        return _axes(c.model) | ({"data"} if c.data is not None else set())

    def data_dim(self, path):
        """The dim, counted from the end, the data axis cuts, or None."""
        p = self.param_path(path)
        return None if p is None else self.cuts[p].data

    def model_partial(self, path) -> bool:
        """Whether a rank's gradient of the leaf at `path` is its share of
        a sum over the model group: an attention leaf the model axis
        leaves whole feeds only the rank's heads (wk and wv of
        `whole_kv_leaves`, the qk-norm scales, MLA's latent projections
        wq_a and wkv_a and their norms). Norm scales on the residual
        stream and a MoE router (replicated compute, models/moe.py) are
        whole and equal on every model rank."""
        p = self.param_path(path)
        return (self.M > 1 and p is not None and "attn" in p
                and "model" not in self.axes(p))

    def data_dims(self) -> dict:
        """The params tree of `data_dim`s (dist/fsdp.py:fsdp_view)."""
        out: dict = {}
        for path in self.cuts:
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = self.data_dim(path)
        return out

    def cut(self, path, a):
        """This rank's block (numpy or torch, contiguous) of the whole
        leaf `a` at `path`."""
        p = self.param_path(path)
        if p is None:
            return a
        c = self.cuts[p]
        if tuple(a.shape) != c.shape:
            raise ValueError(f"{'/'.join(path)}: shape {tuple(a.shape)}, "
                             f"the config's {c.shape}")
        a = _cut(a, c.model, self.mesh, c.parts, "/".join(p))
        return cut_data(a, c.data, self.mesh)[0]

    def gather(self, path, t):
        """The whole leaf at `path` from each rank's block `t` (every rank
        of the mesh calls it, in one order; no autograd): the data
        blocks, then the model blocks, each part of a leaf cut by parts
        put back in order."""
        import torch
        from repro_torch.dist.context import gather_fsdp, gather_model
        p = self.param_path(path)
        if p is None:
            return t
        c = self.cuts[p]
        with torch.no_grad():
            if c.data is not None:
                t = gather_fsdp(t, c.data % t.dim(), self.mesh)
            if "model" in c.model:
                dim = c.model.index("model")
                t = gather_model(t, dim, self.mesh)
                if c.parts > 1:
                    # [rank 0: part 0, part 1 | rank 1: ...] -> by part
                    lead, rest = t.shape[:dim], t.shape[dim + 1:]
                    t = t.reshape(*lead, self.M, c.parts, -1, *rest) \
                        .transpose(dim, dim + 1).reshape(
                            *lead, -1, *rest).contiguous()
        return t

    def shard(self, params, opt_state) -> tuple:
        """(params, opt_state) whole -> this rank's blocks of them."""
        state = _map_state(self.cut, {"params": params, "opt": opt_state})
        return state["params"], state["opt"]

    def gather_state(self, params, opt_state) -> tuple:
        """This rank's blocks -> the whole (params, opt_state)."""
        state = _map_state(self.gather, {"params": params,
                                         "opt": opt_state})
        return state["params"], state["opt"]


def _map_state(fn, tree, prefix=()):
    """fn(path, leaf) over a nested dict, keys sorted at every level (the
    order every rank calls a collective in)."""
    if isinstance(tree, dict):
        return {k: _map_state(fn, tree[k], prefix + (k,))
                for k in sorted(tree)}
    return fn(prefix, tree)


def shard_train_state(cfg, params, opt_state, mesh, fsdp: bool = True):
    """(params, opt_state) whole, in the stacked layout -> this rank's
    blocks of them (TrainLayout: the reference's params_shardings /
    opt_state_shardings)."""
    return TrainLayout(cfg, mesh, fsdp).shard(params, opt_state)


def gather_train_state(cfg, params, opt_state, mesh, fsdp: bool = True):
    """The inverse of shard_train_state: each rank's blocks -> the whole
    (params, opt_state) on every rank (every rank calls it)."""
    return TrainLayout(cfg, mesh, fsdp).gather_state(params, opt_state)
