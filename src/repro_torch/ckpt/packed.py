"""Packed-quantized model artifacts, load side (the reference's
`ckpt/packed.py:load_packed`), and the function that carries a
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
which the batched-expert kernel serves in one launch. The
spec stays the manifest's dict for now (the quantizer's QuantSpec
arrives with the quantizer slice).
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from repro_torch.hw import resolve_device
from repro_torch.quant.packing import codes_from_numpy
from repro_torch.quant.qlinear import QuantizedTensor

FORMAT_VERSION = 4


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


def _group_slice(leaf, g: int):
    """Group g of a stacked leaf (tensor or QuantizedTensor)."""
    if isinstance(leaf, QuantizedTensor):
        return QuantizedTensor(leaf.codes[g].contiguous(),
                               leaf.alphas[g].contiguous(),
                               leaf.betas[g].contiguous(), leaf.k_in,
                               leaf.orig_dtype)
    return leaf[g].contiguous()


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
    probe = blocks["L0"]
    while isinstance(probe, dict):
        probe = next(iter(probe.values()))
    n_groups = (probe.codes.shape[0] if isinstance(probe, QuantizedTensor)
                else probe.shape[0])
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


def _decode(node, arrays, device):
    if "kind" not in node or not isinstance(node.get("kind"), str):
        return {k: _decode(v, arrays, device) for k, v in node.items()}
    if node["kind"] == "qt":
        def scales(field):
            a = arrays[node[field]]
            t = (_bf16_from_bits(a) if node.get("scale_dtype") == "bfloat16"
                 else torch.from_numpy(_host(a)))
            return t.to(device)
        alphas = scales("alphas")
        if "groups" in node and alphas.shape[-3] != node["groups"]:
            raise ValueError(
                f"corrupt packed artifact: manifest says {node['groups']} "
                f"scale groups but alphas have shape {tuple(alphas.shape)}")
        return QuantizedTensor(
            codes=codes_from_numpy(arrays[node["codes"]]).to(device),
            alphas=alphas, betas=scales("betas"),
            k_in=node["k_in"], orig_dtype=node["orig_dtype"])
    arr = arrays[node["key"]]
    if node["dtype"] == "bfloat16":
        return _bf16_from_bits(arr).to(device)
    return torch.from_numpy(_host(arr)).to(device)


def load_packed(directory, *, device=None):
    """-> (params, spec dict or None, meta dict), params in the port's
    per-layer layout on `device` (default cuda). Refuses uncommitted
    (crashed mid-save) and too-new artifacts."""
    dev = resolve_device(device)
    d = Path(directory)
    if not (d / "COMMITTED").exists():
        raise FileNotFoundError(
            f"{d} is not a committed packed artifact (missing COMMITTED)")
    manifest = json.loads((d / "manifest.json").read_text())
    if manifest["format_version"] > FORMAT_VERSION:
        raise ValueError(
            f"packed artifact format {manifest['format_version']} is newer "
            f"than this code ({FORMAT_VERSION})")
    with np.load(d / "arrays.npz") as arrays:
        tree = _decode(manifest["tree"], arrays, dev)
    return unstack_blocks(tree), manifest.get("spec"), manifest.get("meta", {})
