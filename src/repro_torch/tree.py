"""Nested-dict parameter trees in the reference's flattening order.

The training state (params, optimizer moments, checkpoints) keeps the
reference's layout: nested dicts of tensors whose leaves are visited
with the keys of every dict sorted, as `jax.tree_util` flattens dicts,
and named by `keystr` of their key path ("['params']['blocks']['L0']
['attn']['wq']"), the keys of the reference's checkpoints.
"""
from __future__ import annotations


def keystr(path) -> str:
    """("L0", "attn", "wq") -> "['L0']['attn']['wq']" (jax.tree_util.
    keystr of a path of dict keys)."""
    return "".join(f"[{k!r}]" for k in path)


def leaves_with_paths(tree, prefix=()):
    """[(key path, leaf)] of a nested dict, keys sorted at every level."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out.extend(leaves_with_paths(tree[k], prefix + (k,)))
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn, tree, *rest):
    """fn over the leaves of equally shaped nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def unflatten(template, flat) -> dict:
    """The leaves `flat` (in `leaves(template)` order) in template's
    structure."""
    it = iter(flat)
    return tree_map(lambda _: next(it), _sorted(template))


def _sorted(tree):
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    return tree
