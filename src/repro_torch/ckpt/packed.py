"""Packed-quantized model artifacts (the reference's `ckpt/packed.py`:
`save_packed` and `load_packed`), and the function that carries a
reference parameter tree across into the port.

Layout: <dir>/arrays.npz + manifest.json + COMMITTED. The manifest
mirrors the reference's nested param tree; each leaf entry is either
{"kind": "array", "key", "dtype"} or {"kind": "qt", codes/alphas/betas
keys, k_in, orig_dtype, groups/group_size}, keys indexing arrays.npz.
Formats v1-v4 are read as written: bf16 arrays (dense leaves, and
scales flagged `scale_dtype="bfloat16"`) are stored as uint16 bits and
load as torch.bfloat16 tensors that STAY bf16 in memory (the kernels
expand scales in fp32); codes load bit-exact as int32 words
(quant/packing.py).

Both `load_packed` and `params_from_tree` end in the same port layout
(`models/model.py`): the reference's (n_groups, ...) stacked block
leaves are unstacked into one weight dict per layer,

    {"embed", "final_ln", ["lm_head"],
     "layers": [{"ln", "attn": {...}, "ln2", "mlp" | "moe": {...}}, ...]}

with layer g * len(pattern) + i taken from block "L{i}", group g. A
packed MoE expert stack, (G, E, bits, K/32, N) codes in the reference's
stacked tree, becomes one QuantizedTensor of shape (E, K, N) per layer,
which the batched-expert kernel serves in one launch. `load_packed`
returns the manifest's spec as a dict (`QuantSpec.from_dict` reads it).
`load_packed(mesh=)` loads one rank's slice of every leaf: each leaf's
manifest spec without the data axis (serving replicates weights over
the data ranks), guarded against the real mesh and cut by
dist/sharding.py (shard_array, shard_qt), contiguous, so no rank ever
holds another rank's block on its device. `fsdp=True` keeps the data
axis too: a leaf the rule cuts over it loads as this rank's block, a
dist/fsdp.py FsdpLeaf that serving gathers layer by layer.

`save_packed` is the inverse: it restacks the per-layer list into the
reference's {"blocks": {"L{i}": (n_groups, ...) leaves}} with the keys
below "blocks" sorted (the order the reference's stacked tree has), and
writes format v4 as the reference does — the same array keys a0, a1, ...
in tree order, codes as uint32 words, bf16 (dense leaves, and scales
under `scale_dtype="bfloat16"`) as raw uint16 bits, the symbolic
sharding block and per-leaf PartitionSpecs (ckpt/pspec.py) — into
<dir>.tmp, renamed into place, with a fsynced COMMITTED marker last.
`save_packed(draft_bits=d)` adds the optional v4 draft block: on every
quantized leaf with more than d active bits, a "draft" entry {"bits",
"alphas", "betas"} holding the LS re-fit scales of its leading d code
planes (quant/draft.py), stored as the leaf's own scales are, and
`manifest["draft_bits"]`. `load_draft_scales` reads the block back in
the port's per-layer layout for quant.draft.make_draft_params.
"""
from __future__ import annotations

import json
import os
import shutil
import warnings
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.ckpt.pspec import SYMBOLIC_AXES, named_pspec, pspec_to_json
from repro_torch.dist.fsdp import FsdpLeaf, fsdp_leaf
from repro_torch.dist.sharding import (cut_data, data_dims, mesh_axis_sizes,
                                      pspec_from_json, shard_array,
                                      shard_draft_scales, shard_qt,
                                      whole_kv_leaves)
from repro_torch.hw import dtype_name, resolve_device
from repro_torch.quant.draft import refit_draft_scales
from repro_torch.quant.packing import codes_from_numpy, codes_to_numpy
from repro_torch.quant.qlinear import QuantizedTensor, stack_leaves

FORMAT_VERSION = 4
SCALE_DTYPES = (None, "float32", "bfloat16")
# the rule the manifest names for its per-leaf specs (the reference's)
PSPEC_RULE = "repro.dist.sharding.named_pspec"


def _host(arr) -> np.ndarray:
    """A contiguous, writable numpy copy-if-needed (jax arrays expose
    read-only views)."""
    arr = np.ascontiguousarray(arr)
    return arr if arr.flags.writeable else arr.copy()


def _tensor(arr) -> torch.Tensor:
    """numpy array (incl. ml_dtypes bfloat16) -> CPU tensor, same bits."""
    arr = _host(np.asarray(arr))
    if arr.dtype.name == "bfloat16":
        return _bf16_from_bits(arr)
    return torch.from_numpy(arr)


def _bf16_from_bits(arr) -> torch.Tensor:
    return torch.from_numpy(_host(arr).view(np.uint16)).view(torch.bfloat16)


def _is_qt(leaf) -> bool:
    return all(hasattr(leaf, f) for f in
               ("codes", "alphas", "betas", "k_in", "orig_dtype"))


def _leaf(leaf, device):
    """One reference leaf -> port leaf on `device` (QuantizedTensor-like
    objects by their attributes, everything else as an array)."""
    if isinstance(leaf, (torch.Tensor, QuantizedTensor)):
        return leaf.to(device)
    if _is_qt(leaf):
        return QuantizedTensor(
            codes_from_numpy(np.asarray(leaf.codes)).to(device),
            _tensor(leaf.alphas).to(device), _tensor(leaf.betas).to(device),
            k_in=leaf.k_in, orig_dtype=leaf.orig_dtype)
    return _tensor(leaf).to(device)


class _DraftScales(NamedTuple):
    """One leaf's draft block (a leaf, so tree maps do not recurse into
    it as they would into its dict form)."""
    bits: int
    alphas: torch.Tensor
    betas: torch.Tensor


def _group_slice(leaf, g: int):
    """Group g of a stacked leaf (tensor, QuantizedTensor, FSDP block,
    draft block or None)."""
    if leaf is None:
        return None
    if isinstance(leaf, FsdpLeaf):
        return FsdpLeaf({f: t[g].contiguous()
                         for f, t in leaf.fields.items()}, leaf.dims,
                        leaf.parts, leaf.k_in, leaf.orig_dtype)
    if isinstance(leaf, QuantizedTensor):
        return QuantizedTensor(leaf.codes[g].contiguous(),
                               leaf.alphas[g].contiguous(),
                               leaf.betas[g].contiguous(), leaf.k_in,
                               leaf.orig_dtype)
    if isinstance(leaf, _DraftScales):
        return _DraftScales(leaf.bits, leaf.alphas[g].contiguous(),
                            leaf.betas[g].contiguous())
    return leaf[g].contiguous()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def unstack_blocks(tree: dict) -> dict:
    """Reference layout {"blocks": {"L{i}": stacked}} -> the port's
    {"layers": [per-layer dict]} (all other keys kept as they are)."""
    if "blocks" not in tree:
        return tree
    out = {k: v for k, v in tree.items() if k != "blocks"}
    blocks = tree["blocks"]
    P = len(blocks)
    probe = next(leaf for leaf in _leaves(blocks) if leaf is not None)
    if isinstance(probe, FsdpLeaf):
        probe = next(iter(probe.fields.values()))
    n_groups = (probe.alphas.shape[0] if isinstance(
        probe, (QuantizedTensor, _DraftScales)) else probe.shape[0])
    out["layers"] = [
        _map(blocks[f"L{i}"], lambda leaf, g=g: _group_slice(leaf, g))
        for g in range(n_groups) for i in range(P)]
    return out


def params_from_tree(tree, device=None) -> dict:
    """A reference param tree (nested dicts whose leaves are numpy or
    jax arrays, or objects with codes/alphas/betas/k_in/orig_dtype) ->
    the port's per-layer params on `device` (default cuda)."""
    dev = resolve_device(device)
    return unstack_blocks(_map(tree, lambda leaf: _leaf(leaf, dev)))


def _leaf_spec(node, names, shape, field=None):
    """A leaf's symbolic spec: the manifest's (v3+), else the rule's."""
    if "pspec" in node:
        entries = node["pspec"][field] if field else node["pspec"]
        return pspec_from_json(entries)
    return named_pspec(names + ((f".{field}",) if field else ()), shape)


def _decode(node, arrays, device, mesh=None, names=(), fsdp=False,
            whole=()):
    """A manifest node -> port leaves on `device`; with `mesh`, this
    rank's slice of each (cut in host memory, before the copy; with
    `fsdp` its data-axis block too, an FsdpLeaf)."""
    if "kind" not in node or not isinstance(node.get("kind"), str):
        return {k: _decode(v, arrays, device, mesh, names + (k,), fsdp,
                           whole)
                for k, v in node.items()}
    dims, parts = {}, mesh_axis_sizes(mesh)["data"] if mesh else 1
    if node["kind"] == "qt":
        codes = arrays[node["codes"]]
        alphas, betas = arrays[node["alphas"]], arrays[node["betas"]]
        if "groups" in node and alphas.shape[-3] != node["groups"]:
            raise ValueError(
                f"corrupt packed artifact: manifest says {node['groups']} "
                f"scale groups but alphas have shape {tuple(alphas.shape)}")
        k_in = node["k_in"]
        if mesh is not None:
            specs = {f: _leaf_spec(node, names, a.shape, f) for f, a in
                     (("codes", codes), ("alphas", alphas),
                      ("betas", betas))}
            codes, alphas, betas, k_in = shard_qt(
                names, codes, alphas, betas, k_in, specs, mesh, whole)
            if fsdp:
                dims = data_dims(names, specs)
                codes, dims["codes"] = cut_data(codes, dims["codes"], mesh)
                alphas, dims["alphas"] = cut_data(alphas, dims["alphas"],
                                                  mesh)
                betas, dims["betas"] = cut_data(betas, dims["betas"], mesh)

        def scales(a):
            t = (_bf16_from_bits(a) if node.get("scale_dtype") == "bfloat16"
                 else torch.from_numpy(_host(a)))
            return t.to(device)
        return fsdp_leaf({"codes": codes_from_numpy(codes).to(device),
                          "alphas": scales(alphas), "betas": scales(betas)},
                         dims, parts, k_in, node["orig_dtype"])
    arr = arrays[node["key"]]
    if mesh is not None:
        spec = _leaf_spec(node, names, arr.shape)
        arr = shard_array(names, arr, spec, mesh, whole)
        if fsdp:
            arr, dims["w"] = cut_data(arr, data_dims(names, {"w": spec})["w"],
                                      mesh)
    if node["dtype"] == "bfloat16":
        t = _bf16_from_bits(arr).to(device)
    else:
        t = torch.from_numpy(_host(arr)).to(device)
    return fsdp_leaf({"w": t}, dims, parts)


def _manifest(d: Path) -> dict:
    if not (d / "COMMITTED").exists():
        raise FileNotFoundError(
            f"{d} is not a committed packed artifact (missing COMMITTED)")
    return json.loads((d / "manifest.json").read_text())


def packed_meta(directory) -> dict:
    """The artifact's meta block ({"arch", "n_layers", ...}): what a
    caller reads to build the config before a mesh load."""
    return _manifest(Path(directory)).get("meta", {})


def load_packed(directory, *, mesh=None, fsdp: bool = False, device=None,
                cfg=None):
    """-> (params, spec dict or None, meta dict), params in the port's
    per-layer layout on `device` (default cuda; on a mesh, the rank's
    device). Refuses uncommitted (crashed mid-save) and too-new
    artifacts.

    With `mesh` (a bound ServeMesh: call it in each rank) every leaf is
    this rank's slice under its manifest spec, the guard re-applied
    against the mesh (dist/sharding.py). `fsdp=False` (the reference's
    default) drops the data axis: weights replicate over data ranks;
    `fsdp=True` keeps it, and a leaf it cuts loads as this rank's block
    (dist/fsdp.py FsdpLeaf, gathered layer by layer as the engine
    serves). A pre-v3 artifact records no specs: the reference
    replicates every leaf onto its mesh and warns once; the port warns
    the same and cuts the leaves by the rule itself (the specs a v3
    manifest would hold), since its steps need their slices. Where the
    model axis does not divide the KV heads, wk and wv stay whole on
    every rank (dist/sharding.py:whole_kv_leaves): that needs the model
    config `cfg` (its head counts are not in the manifest)."""
    if mesh is not None:
        if mesh.rank is None:
            raise ValueError("load_packed(mesh=) takes a bound mesh: call "
                             "it in each rank (dist.context.spawn)")
        if device is None:
            device = mesh.device
    dev = resolve_device(device)
    d = Path(directory)
    manifest = _manifest(d)
    if manifest["format_version"] > FORMAT_VERSION:
        raise ValueError(
            f"packed artifact format {manifest['format_version']} is newer "
            f"than this code ({FORMAT_VERSION})")
    if mesh is not None and manifest["format_version"] < 3:
        _warn_no_pspec(d, manifest["format_version"])
    with np.load(d / "arrays.npz") as arrays:
        tree = _decode(manifest["tree"], arrays, dev, mesh, (),
                       fsdp and mesh is not None,
                       whole_kv_leaves(cfg, mesh) if mesh else ())
    return unstack_blocks(tree), manifest.get("spec"), manifest.get("meta", {})


_WARNED_NO_PSPEC = []


def _warn_no_pspec(d, version) -> None:
    """One warning a process: a pre-v3 artifact has no per-leaf specs."""
    if _WARNED_NO_PSPEC:
        return
    _WARNED_NO_PSPEC.append(True)
    warnings.warn(
        f"packed artifact {d} is format v{version} (pre-sharding-"
        f"metadata): it records no per-leaf PartitionSpecs, so its leaves "
        f"are cut by the sharding rule's specs; re-save with this code to "
        f"record them", UserWarning, stacklevel=3)


def load_draft_scales(directory, *, mesh=None, fsdp=False, device=None,
                      cfg=None):
    """The v4 draft block as a tree in the port's per-layer layout
    ({"layers": [...]}, as load_packed returns the params) with
    {"bits", "alphas", "betas"} dicts at quantized-leaf positions and
    None at the others, ready for quant.draft.make_draft_params(
    scales_tree=...); scales flagged bf16 load as bf16 tensors. With
    `mesh` (bound, as load_packed's) each block is this rank's, cut as
    its leaf's own scales are (dist/sharding.py:shard_draft_scales; with
    `fsdp` and `cfg` as load_packed takes them).
    Returns None when the artifact has no block (pre-v4, or saved
    without `draft_bits`); callers then refit."""
    if mesh is not None:
        if mesh.rank is None:
            raise ValueError("load_draft_scales(mesh=) takes a bound mesh: "
                             "call it in each rank (dist.context.spawn)")
        if device is None:
            device = mesh.device
    dev = resolve_device(device)
    d = Path(directory)
    manifest = _manifest(d)
    found = [False]

    def walk(node, arrays, names):
        if "kind" not in node or not isinstance(node.get("kind"), str):
            return {k: walk(v, arrays, names + (k,))
                    for k, v in node.items()}
        blk = node.get("draft") if node["kind"] == "qt" else None
        if blk is None:
            return None
        found[0] = True
        da, db = arrays[blk["alphas"]], arrays[blk["betas"]]
        if mesh is not None:
            # a draft block is v4: its leaf records its specs
            specs = {f: pspec_from_json(node["pspec"][f])
                     for f in ("codes", "alphas", "betas")}
            da, db = shard_draft_scales(names, da, db, node["k_in"], specs,
                                        mesh, whole_kv_leaves(cfg, mesh),
                                        fsdp)

        def scale(a):
            t = (_bf16_from_bits(a) if blk.get("scale_dtype") == "bfloat16"
                 else torch.from_numpy(_host(a)))
            return t.to(dev)
        return _DraftScales(int(blk["bits"]), scale(da), scale(db))

    with np.load(d / "arrays.npz") as arrays:
        tree = walk(manifest["tree"], arrays, ())
    if not found[0]:
        return None
    return _as_dicts(unstack_blocks(tree))


def _as_dicts(node):
    """Draft blocks -> {"bits", "alphas", "betas"} dicts, throughout a
    tree of dicts and lists."""
    if isinstance(node, dict):
        return {k: _as_dicts(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_as_dicts(v) for v in node]
    return node if node is None else node._asdict()


# --------------------------------------------------------------------------
# save side
# --------------------------------------------------------------------------

def _sorted_tree(tree):
    if isinstance(tree, dict):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


def _zip_map(trees, fn):
    """fn over the leaves of equally shaped nested dicts, in the first
    tree's order."""
    if isinstance(trees[0], dict):
        return {k: _zip_map([t[k] for t in trees], fn) for k in trees[0]}
    return fn(trees)


def _restack(params: dict, P: int) -> dict:
    """The port's {"layers": [...]} -> the reference's {"blocks":
    {"L{i}": stacked}}, "blocks" where "layers" stood: layer g * P + i
    becomes group g of slot "L{i}"."""
    layers = params["layers"]
    blocks = {f"L{i}": _sorted_tree(_zip_map(layers[i::P], stack_leaves))
              for i in range(P)}
    return {("blocks" if k == "layers" else k):
            (blocks if k == "layers" else v) for k, v in params.items()}


def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().to(torch.bfloat16).view(torch.int16).cpu().numpy() \
        .view(np.uint16)


def _store_scale(t, arrays: dict, scale_dtype):
    """Collect one alpha/beta tensor; returns (key, flagged_bf16). bf16
    is stored as raw uint16 bits (npz has no bfloat16); scales that are
    already bf16 take this path whatever scale_dtype says."""
    key = f"a{len(arrays)}"
    bf16 = scale_dtype == "bfloat16" or t.dtype == torch.bfloat16
    arrays[key] = (_bf16_bits(t) if bf16
                   else np.ascontiguousarray(t.detach().cpu().numpy()))
    return key, bf16


def _encode(tree, arrays: dict, path=(), scale_dtype=None,
            draft_bits=None):
    """Nested dict tree -> manifest node; arrays collected by key."""
    if isinstance(tree, dict):
        return {k: _encode(v, arrays, path + (k,), scale_dtype, draft_bits)
                for k, v in tree.items()}
    if isinstance(tree, QuantizedTensor):
        ent = {"kind": "qt", "k_in": tree.k_in,
               "orig_dtype": tree.orig_dtype,
               "groups": int(tree.n_groups),
               "group_size": int(tree.group_size),
               "pspec": {f: pspec_to_json(named_pspec(
                   path + ("." + f,), getattr(tree, f).shape))
                   for f in ("codes", "alphas", "betas")}}
        key = f"a{len(arrays)}"
        arrays[key] = codes_to_numpy(tree.codes)
        ent["codes"] = key
        for field in ("alphas", "betas"):
            key, bf16 = _store_scale(getattr(tree, field), arrays,
                                     scale_dtype)
            if bf16:
                ent["scale_dtype"] = "bfloat16"
            ent[field] = key
        if draft_bits is not None and draft_bits < tree.bits:
            # the v4 optional block: re-fit scales of the leading
            # draft_bits planes (quant/draft.py), the draft's whole
            # footprint (its codes are the target's)
            da, db = refit_draft_scales(tree, draft_bits)
            ka, bf16 = _store_scale(da, arrays, scale_dtype)
            kb, _ = _store_scale(db, arrays, scale_dtype)
            ent["draft"] = {"bits": int(draft_bits), "alphas": ka,
                            "betas": kb}
            if bf16:
                ent["draft"]["scale_dtype"] = "bfloat16"
        return ent
    key = f"a{len(arrays)}"
    dt = dtype_name(tree.dtype)
    arrays[key] = (_bf16_bits(tree) if dt == "bfloat16"
                   else np.ascontiguousarray(tree.detach().cpu().numpy()))
    return {"kind": "array", "key": key, "dtype": dt,
            "pspec": pspec_to_json(named_pspec(path, tree.shape))}


def save_packed(directory, params, *, cfg, spec=None,
                meta: dict | None = None, scale_dtype: str | None = None,
                draft_bits: int | None = None) -> Path:
    """Write a packed model artifact from the port's params, whose
    config `cfg` says how the layers restack into pattern slots; returns
    the final directory. `spec` is a QuantSpec (or its dict).
    `scale_dtype="bfloat16"` stores alphas/betas as bf16 (rounded once,
    half the scale bytes). `draft_bits=d` also stores LS re-fit scales
    for the leading d code planes of every quantized leaf with more
    than d active bits (the v4 draft block), so a speculative boot
    (`launch/serve.py --speculate k --draft-bits d`) skips the refit."""
    if scale_dtype not in SCALE_DTYPES:
        raise ValueError(f"scale_dtype={scale_dtype!r}; "
                         f"expected one of {SCALE_DTYPES}")
    if draft_bits is not None and draft_bits < 1:
        raise ValueError(f"draft_bits must be >= 1, got {draft_bits}")
    if len(params["layers"]) != cfg.n_layers:
        raise ValueError(f"params hold {len(params['layers'])} layers, "
                         f"{cfg.name} {cfg.n_layers}")
    tree = _restack(params, len(cfg.pattern))
    final = Path(directory)
    tmp = final.with_name(final.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    arrays: dict = {}
    manifest = {
        "format_version": FORMAT_VERSION,
        "spec": (spec.to_dict() if hasattr(spec, "to_dict") else spec),
        "meta": meta or {},
        "sharding": {"axes": list(SYMBOLIC_AXES), "rule": PSPEC_RULE},
        "tree": _encode(tree, arrays, scale_dtype=None
                        if scale_dtype == "float32" else scale_dtype,
                        draft_bits=draft_bits),
    }
    if draft_bits is not None:
        manifest["draft_bits"] = int(draft_bits)
    np.savez(tmp / "arrays.npz", **arrays)
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    with open(final / "COMMITTED", "w") as f:
        f.write(str(FORMAT_VERSION))
        f.flush()
        os.fsync(f.fileno())
    return final
