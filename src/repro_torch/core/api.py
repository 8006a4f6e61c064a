"""quantize_model(): calibrate per-weight Hessians by tapping linear()
inputs on the training forward, and quantize every eligible weight
through the quantizer registry (the reference's `core/api.py`, over the
port's per-layer params).

    spec = QuantSpec.from_config(cfg.quant, method="gptqt", mode="packed",
                                 overrides=(OverrideRule("wv", bits=4),))
    qparams, report = quantize_model(cfg, params, calib_batches, spec=spec)
    save_packed(out_dir, qparams, cfg=cfg, spec=spec)      # ckpt/packed.py

`mode="fake"` replaces weights with dequantized fp tensors;
`mode="packed"` installs QuantizedTensor leaves (fused binary coding,
the serving kernels' path) and needs a method whose quantizer sets
`supports_packed` (gptqt, bcq).

Paths are the reference's: layer j of the port is slot i = j %
len(cfg.pattern) of group g = j // len(cfg.pattern), and its weights
answer to the dotted path "blocks.L{i}.attn.wq" (override rules match
a slot, as in the reference) and to the report key "['L{i}']['attn']
['wq']" (its errors averaged over groups and experts). Every captured
activation batch folds into a per-weight `HessianAccumulator` at once,
so calibration holds O(K^2) per tracked weight. The reference's
deprecated keyword form (method=, qcfg=, mode=, include_head=,
exact_search=) is not ported: pass a spec.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.gptq import output_error
from repro_torch.core.hessian import HessianAccumulator
from repro_torch.core.stages import stage
from repro_torch.hw import dtype_name, resolve_device
from repro_torch.models import layers as L
from repro_torch.models.model import forward
from repro_torch.quant.qlinear import stack_leaves
from repro_torch.quant.registry import get_quantizer
from repro_torch.quant.spec import (LeafPlan, QuantSpec, dotted_path,
                                    is_quantizable, leaf_name)
from repro_torch.tree import keystr


def _leaves(tree, prefix=()):
    """(path, leaf) of a nested dict, in its order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _slot_path(cfg, j: int, path):
    """Layer j's path -> (group, path in the reference's pattern slot)."""
    P = len(cfg.pattern)
    return j // P, (f"L{j % P}",) + tuple(path)


def eligible_paths(cfg, params, include_head=False):
    """-> list of (path, leaf) for quantizable weights; path is the
    leaf's place in the port's params, ("layers", j, "attn", "wq") or
    ("lm_head",)."""
    out = []
    for j, lp in enumerate(params["layers"]):
        for path, leaf in _leaves(lp):
            if is_quantizable(leaf_name(path), include_head=include_head,
                              exclude=cfg.quant.exclude,
                              ndim=getattr(leaf, "ndim", 0)):
                out.append((("layers", j) + path, leaf))
    head = params.get("lm_head")
    if head is not None and is_quantizable(
            "lm_head", include_head=include_head, exclude=cfg.quant.exclude,
            ndim=getattr(head, "ndim", 0)):
        out.append((("lm_head",), head))
    return out


# --------------------------------------------------------------------------
# calibration: unrolled forward with activation taps
# --------------------------------------------------------------------------

def forward_unrolled(cfg, params, inputs):
    """Calibration's forward: the training forward (models/model.py:
    forward, MoE layers at the train-time capacity factor, as the
    reference calibrates) with no activation checkpoint, so every
    linear() of a plain weight reaches the open tap once. -> logits
    (B, S, V)."""
    return forward(cfg, params, inputs, remat="none")[0]


def _fold(ent, xs):
    """Stream captured activations into the entry's accumulator(s)."""
    leaf = ent["leaf"]
    if leaf.dim() == 3:                  # expert stack: per-expert H
        E, K = leaf.shape[0], leaf.shape[1]
        if ent["acc"] is None:
            ent["acc"] = [HessianAccumulator(K) for _ in range(E)]
        for x in xs:
            for e in range(E):
                ent["acc"][e].update(x[e])
    else:
        if ent["acc"] is None:
            ent["acc"] = HessianAccumulator(leaf.shape[0])
        for x in xs:
            ent["acc"].update(x)


def collect_hessians(cfg, params, calib_batches, include_head=False, *,
                     spec=None, device=None):
    """Run the calibration batches on `device` (default cuda), return
    {(g, keystr): (path, g, leaf, H or [H_e])} with path the leaf's
    pattern-slot path (("L0", "attn", "wq"); ("lm_head",) with g = -1).

    calib_batches: iterable of token (B, S) arrays. Activations fold
    into streaming HessianAccumulators batch by batch; with a spec,
    only the leaves it resolves to a plan are tracked."""
    dev = resolve_device(device)
    if params["embed"].device.type != dev.type:
        raise ValueError(f"the params live on {params['embed'].device} and "
                         f"calibration runs on {dev}: pass device= or move "
                         f"the params")
    if spec is None:
        spec = QuantSpec.from_config(cfg.quant, include_head=include_head)
    id2path = {}
    for j, lp in enumerate(params["layers"]):
        for sub, leaf in _leaves(lp):
            g, path = _slot_path(cfg, j, sub)
            if spec.resolve("blocks." + dotted_path(path), leaf_name(path),
                            getattr(leaf, "ndim", 0)):
                id2path[id(leaf)] = (g, path, leaf)
    head = params.get("lm_head")
    if head is not None and spec.resolve("lm_head", "lm_head",
                                         getattr(head, "ndim", 0)):
        id2path[id(head)] = (-1, ("lm_head",), head)

    acc: dict = {}
    with torch.no_grad(), L.tap_activations() as rec:
        for batch in calib_batches:
            if not torch.is_tensor(batch):
                batch = torch.from_numpy(np.array(batch))
            with stage("calibration_forward"):
                forward_unrolled(cfg, params, batch.to(dev))
            with stage("hessian"):
                for wid, xs in rec.items():
                    if wid not in id2path:
                        continue
                    g, path, leaf = id2path[wid]
                    ent = acc.setdefault((g, keystr(path)), {
                        "leaf": leaf, "g": g, "path": path, "acc": None})
                    _fold(ent, xs)
            rec.clear()

    if not acc:
        raise RuntimeError(
            "calibration captured no activations for any quantizable "
            "weight — are the param leaves plain tensors?")
    out = {}
    for key, ent in acc.items():
        if isinstance(ent["acc"], list):
            H = [a.finalize()[0] for a in ent["acc"]]
        else:
            H = ent["acc"].finalize()[0]
        out[key] = (ent["path"], ent["g"], ent["leaf"], H)
    return out


# --------------------------------------------------------------------------
# per-matrix dispatch (registry)
# --------------------------------------------------------------------------

def quantize_matrix(W, H, *, plan: LeafPlan):
    """W: layer layout (K, N); H: (K, K), on one device. Returns (new
    leaf, stats), dispatched through the quantizer registry."""
    q = get_quantizer(plan.method)
    if plan.mode == "packed" and not q.supports_packed:
        raise ValueError(
            f"method {plan.method!r} has no packed (binary-coding) "
            f"representation; use mode='fake' or a packable method "
            f"(e.g. 'gptqt', 'bcq')")
    plan.n_groups(W.shape[-2])   # group_size must divide K_in (clear error)
    Wt = W.float().T                                     # (N, K)
    res = q.quantize(Wt, H, plan, orig_dtype=dtype_name(W.dtype))
    stats = {"err": output_error(Wt, res.wq_t, H),
             "method": plan.method, "bits": plan.bits}
    if plan.mode == "packed":
        return res.qt, stats
    return res.wq_t.T.to(W.dtype), stats


# --------------------------------------------------------------------------
# whole-model quantization
# --------------------------------------------------------------------------

def _with_leaf(tree: dict, path, value) -> dict:
    """A copy of the nested dict with the leaf at `path` replaced."""
    new = dict(tree)
    new[path[0]] = (value if len(path) == 1
                    else _with_leaf(tree[path[0]], path[1:], value))
    return new


def quantize_model(cfg, params, calib_batches, *, spec: QuantSpec = None,
                   verbose=False, device=None):
    """Returns (new params, report dict). See module docstring. The
    calibration runs on `device` (default cuda); each weight quantizes
    where it lives. The input params are left as they are."""
    if spec is None:
        spec = QuantSpec.from_config(cfg.quant)
    # validate every method the spec can name before any heavy work
    for m in {spec.method} | {r.method for r in spec.overrides if r.method}:
        q = get_quantizer(m)
        if spec.mode == "packed" and not q.supports_packed:
            raise ValueError(
                f"method {m!r} has no packed representation; spec mode "
                f"is 'packed'")

    hs = collect_hessians(cfg, params, calib_batches, spec=spec,
                          device=device)
    P = len(cfg.pattern)
    by_path: dict = {}
    for (g, pstr), (path, _, leaf, H) in hs.items():
        by_path.setdefault(pstr, []).append((g, path, leaf, H))

    report = {}
    new_params = dict(params)
    layers = list(params["layers"])
    for pstr, entries in sorted(by_path.items()):
        entries.sort(key=lambda e: e[0])
        g0, path0, leaf0, _ = entries[0]
        dotted = ("blocks." if g0 != -1 else "") + dotted_path(path0)
        plan = spec.resolve(dotted, leaf_name(path0),
                            getattr(leaf0, "ndim", 0))
        try:
            plan.n_groups(leaf0.shape[-2])
        except ValueError as e:
            raise ValueError(f"{dotted}: {e}") from None
        if g0 == -1:    # top-level (lm_head)
            new_leaf, st = quantize_matrix(leaf0, entries[0][3], plan=plan)
            new_params["lm_head"] = new_leaf
            report[pstr] = st
            continue
        errs = []
        for g, path, leaf, H in entries:
            with stage(f"leaf {pstr}"):
                if leaf.dim() == 3:                      # expert stack
                    per_e = [quantize_matrix(leaf[e], H[e], plan=plan)
                             for e in range(leaf.shape[0])]
                    errs.extend(s["err"] for _, s in per_e)
                    new = stack_leaves([p for p, _ in per_e])
                else:
                    new, st = quantize_matrix(leaf, H, plan=plan)
                    errs.append(st["err"])
            j = g * P + int(path[0][1:])
            layers[j] = _with_leaf(layers[j], path[1:], new)
        report[pstr] = {"err": float(np.mean(errs)), "method": plan.method,
                        "bits": plan.bits}
        if verbose:
            print(f"  quantized {pstr} [{plan.method} w{plan.bits}]: "
                  f"mean tr-err {report[pstr]['err']:.4g}")
    new_params["layers"] = layers
    return new_params, report
