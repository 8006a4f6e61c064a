"""Dry run of every (architecture x input shape) cell on the meta device,
sized against one NVIDIA H100 (the reference's `launch/dryrun.py`, which
lowers and compiles each cell for a TPU pod mesh).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k
  python -m repro_torch.launch.dryrun --all
  python -m repro_torch.launch.dryrun --all --quant 3

Artifacts: artifacts/dryrun_torch/{arch}__{shape}__h100[__w{bits}].json

A cell's step runs on tensors of the meta device, which carry shapes and
dtypes and no data: the train step (loss, gradients under the config's
remat policy, microbatches, AdamW), the prefill, or one dense decode
step, as the reference lowers them, at bf16 (w`bits` packed stand-ins
of quant/abstract.py with --quant). Under roofline/op_profile.py's
counters it records the step's FLOPs (torch.utils.flop_counter plus the
hand-written kernels' own counts), the bytes its ops move, the bytes of
its arguments and outputs, and the peak of the tensor storages alive
during the step (`peak_live_bytes_est`), against the card's 80 GB. The
costs of the roofline come, as in the reference, from probes of the
same cell cut to 2 and 3 groups of its pattern, extrapolated linearly to
the config's depth (`_extrapolate`); the full-depth trace validates the
cell and sizes its memory, and its own count stands beside the
extrapolation. On one device there are no collectives; the pod meshes
(--multipod, and the reference's FSDP switch --no-fsdp) and their
collective term are still to do (ROADMAP Queue 1 item 6.3).
"""
from __future__ import annotations

import argparse
import json
import math
import multiprocessing
import time
import traceback
from pathlib import Path

import torch

from repro_torch.ckpt import stack_params
from repro_torch.hw import torch_dtype
from repro_torch.configs import ASSIGNED, SHAPES, get_config, runnable_shapes
from repro_torch.models.model import (decode_step, init_cache, init_params,
                                      prefill)
from repro_torch.quant.abstract import (packed_param_bytes,
                                        quantize_params_abstract)
from repro_torch.quant.qlinear import tree_tensors
from repro_torch.roofline.analysis import (BF16_FLOPS, HBM_BYTES,
                                           CollectiveStats, model_flops,
                                           roofline_terms)
from repro_torch.roofline.op_profile import count_step
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import init_train_state, make_train_step

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"
DEVICE_NAME = "h100"
N_DEVICES = 1
META = torch.device("meta")


def _refuse_meshes(multi_pod: bool, fsdp: bool) -> None:
    if multi_pod or not fsdp:
        raise NotImplementedError(
            f"{'--multipod' if multi_pod else '--no-fsdp'}: the pod meshes' "
            f"sharded cells are still to do (ROADMAP Queue 1 item 6.3); the "
            f"port's dry run sizes one device")


# --------------------------------------------------------------------------
# abstract inputs
# --------------------------------------------------------------------------

def input_specs(cfg, shape_spec, dtype="bfloat16") -> dict:
    """Meta-tensor stand-ins for every model input of this cell (frames
    in the activation dtype)."""
    B, S = shape_spec.global_batch, shape_spec.seq_len
    if cfg.embed_input == "tokens":
        inputs = torch.empty((B, S), dtype=torch.int32, device=META)
    else:
        inputs = torch.empty((B, S, cfg.d_model), dtype=torch_dtype(dtype),
                             device=META)
    if shape_spec.kind == "train":
        return {"inputs": inputs,
                "labels": torch.empty((B, S), dtype=torch.int32,
                                      device=META)}
    if shape_spec.kind == "prefill":
        return {"inputs": inputs}
    # decode: one new token against a cache of length S
    return {"tokens": torch.empty((B, 1), dtype=torch.int32, device=META),
            "pos": torch.empty((B,), dtype=torch.int32, device=META)}


def abstract_params(cfg, device=META, dtype="bfloat16"):
    """The params on meta (bf16, as the reference's dry run), one weight
    dict a layer."""
    return init_params(cfg, dtype=dtype, device=device)


def abstract_cache(cfg, B, S, device=META, dtype="bfloat16"):
    return init_cache(cfg, B, S, dtype=dtype, device=device)


def _storages(tree) -> dict:
    """{storage key: bytes} of the distinct storages of a tree."""
    out = {}
    for t in tree_tensors(tree):
        st = t.untyped_storage()
        out[st._cdata] = st.nbytes()
    return out


# --------------------------------------------------------------------------
# cell lowering
# --------------------------------------------------------------------------

def lower_cell(cfg, shape_spec, quant_bits=None, microbatches=1,
               remat=None, device=META, inputs=None, dtype="bfloat16",
               opt_cfg=None):
    """-> (step, arguments, meta): `step()` runs the cell's step on meta
    tensors and returns its outputs; `arguments` is the tree of tensors
    it takes; meta the reference's byte counts (params at bf16, packed,
    cache, train state). Nothing is allocated. The cells are bf16 with
    AdamW's defaults (fp32 moments and master weights), as the
    reference's; `dtype` and `opt_cfg` size a run of other settings. With
    another `device` (and `inputs` of input_specs' keys there) the same
    step runs on real tensors, seeded params and zero caches: what the
    meta trace is tested against."""
    if remat is not None:
        cfg = cfg.replace(remat=remat)
    p_abs = abstract_params(cfg, device, dtype)
    meta = {"params_bytes_bf16" if dtype == "bfloat16" else
            f"params_bytes_{dtype}": packed_param_bytes(p_abs)}
    specs = (inputs if inputs is not None
             else input_specs(cfg, shape_spec, dtype))

    if shape_spec.kind == "train":
        params = stack_params(cfg, p_abs)
        opt_cfg = opt_cfg or AdamWConfig()
        opt = init_train_state(cfg, params, opt_cfg)
        step_fn = make_train_step(cfg, opt_cfg, microbatches=microbatches)
        meta["state_bytes"] = packed_param_bytes(opt)
        args = (params, opt, specs)
        return (lambda: step_fn(params, opt, specs)), args, meta

    if quant_bits:
        p_abs = quantize_params_abstract(cfg, p_abs, quant_bits)
        meta["params_bytes_packed"] = packed_param_bytes(p_abs)
    B, S = shape_spec.global_batch, shape_spec.seq_len
    cache = abstract_cache(cfg, B, S, device, dtype)
    meta["cache_bytes"] = packed_param_bytes(cache)

    if shape_spec.kind == "prefill":
        args = (p_abs, specs)
        return (lambda: prefill(cfg, p_abs, specs["inputs"], S)), args, meta

    args = (p_abs, cache, specs)
    return (lambda: decode_step(cfg, p_abs, cache, specs["tokens"],
                                specs["pos"])), args, meta


def trace_cell(step, args) -> dict:
    """Run a lowered cell under the counters: its costs, and the bytes
    of its arguments, outputs, outputs that are arguments (in-place
    caches), and the peak of live storages."""
    arg_st = _storages(args)
    out, cost = count_step(step, tree_tensors(args))
    out_st = _storages(out)
    alias = sum(n for k, n in out_st.items() if k in arg_st)
    argument = sum(arg_st.values())
    output = sum(out_st.values())
    peak = cost["peak_live_bytes"]
    return {"cost": cost, "memory": {
        "argument_bytes": argument, "output_bytes": output,
        "temp_bytes": peak - argument - output + alias,
        "alias_bytes": alias, "peak_live_bytes_est": peak}}


def _probe_costs(cfg, shape_spec, groups, **kw):
    """Trace the cell cut to `groups` groups of its pattern and return
    flat metrics; per-step cost is then base + n_groups * delta over the
    2- and 3-group probes (no collectives on one device)."""
    pcfg = cfg.replace(n_layers=groups * len(cfg.pattern))
    step, args, _ = lower_cell(pcfg, shape_spec, **kw)
    _, cost = count_step(step, tree_tensors(args))
    return {"flops": cost["flops"], "bytes": cost["bytes"],
            "wire_bytes": 0, "coll_count": 0, "by_op": {}, "top": []}


def _extrapolate(c2, c3, n_groups):
    """Probes at 2 and 3 groups (the reference's choice: its partitioner
    puts the 1-group point outside the linear region). delta = c3 - c2;
    base = c2 - 2*delta; total = base + n_groups*delta. On the meta
    device every group traces the same ops, so the total equals the
    full-depth count."""
    out = {}
    for k in ("flops", "bytes", "wire_bytes"):
        delta = max(c3[k] - c2[k], 0)
        base = max(c2[k] - 2 * delta, 0)
        out[k] = base + n_groups * delta
    out["coll_count_per_group"] = max(c3["coll_count"] - c2["coll_count"], 0)
    return out


def _artifact(arch, shape_name, quant_bits, tag) -> Path:
    q = f"__w{quant_bits}" if quant_bits else ""
    tg = f"__{tag}" if tag else ""
    return ARTIFACTS / f"{arch}__{shape_name}__{DEVICE_NAME}{q}{tg}.json"


def run_cell(arch, shape_name, *, multi_pod=False, quant_bits=None,
             microbatches=1, remat=None, fsdp=True, save=True, tag="",
             probe=True):
    _refuse_meshes(multi_pod, fsdp)
    cfg = get_config(arch)
    shape_spec = SHAPES[shape_name]
    t0 = time.time()
    result = {
        "arch": arch, "shape": shape_name, "mesh": DEVICE_NAME,
        "quant_bits": quant_bits, "microbatches": microbatches,
        "n_devices": N_DEVICES, "ok": False,
    }
    kw = dict(quant_bits=quant_bits, microbatches=microbatches, remat=remat)
    try:
        # (a) the full-depth step: the validation and memory artifact
        step, args, meta = lower_cell(cfg, shape_spec, **kw)
        t_lower = time.time() - t0
        traced = trace_cell(step, args)
        del step, args
        t_trace = time.time() - t0 - t_lower
        full = traced["cost"]
        cost = {"flops": full["flops"], "bytes accessed": full["bytes"]}
        # (b, c) probes at 2 and 3 groups, extrapolated to the depth
        if probe:
            c2 = _probe_costs(cfg, shape_spec, 2, **kw)
            c3 = _probe_costs(cfg, shape_spec, 3, **kw)
            ex = _extrapolate(c2, c3, cfg.n_groups)
            cost = {"flops": ex["flops"], "bytes accessed": ex["bytes"]}
        coll = CollectiveStats()
        result.update(meta)
        mem = traced["memory"]
        result.update({
            "ok": True,
            "t_lower_s": round(t_lower, 2),
            "t_trace_s": round(t_trace, 2),
            "t_probe_s": round(time.time() - t0 - t_lower - t_trace, 2),
            "probe": probe,
            "memory": {**mem, "device_bytes": HBM_BYTES,
                       "fits_device": mem["peak_live_bytes_est"] <= HBM_BYTES,
                       "devices_for_peak": max(1, math.ceil(
                           mem["peak_live_bytes_est"] / HBM_BYTES))},
            "full_depth": {"flops": full["flops"], "bytes": full["bytes"],
                           "n_ops": full["n_ops"],
                           "kernels": full["kernels"]},
            "op_profile": {"by_kind": full["profile"]["by_kind"][:12],
                           "top_ops": full["profile"]["top_ops"][:8]},
            "collectives": {"wire_bytes": coll.total_wire_bytes,
                            "count": coll.count, "by_op": coll.by_op,
                            "top": coll.top},
            "roofline": roofline_terms(cost, coll, BF16_FLOPS),
            "model_flops_global": model_flops(cfg, shape_spec),
        })
        r = result["roofline"]
        mf_dev = result["model_flops_global"] / N_DEVICES
        r["model_flops_per_device"] = mf_dev
        r["useful_flops_ratio"] = (mf_dev / r["flops_per_device"]
                                   if r["flops_per_device"] else 0.0)
    except Exception as e:  # noqa: BLE001 — a failing cell is a bug report
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-4000:]
    if save:
        ARTIFACTS.mkdir(parents=True, exist_ok=True)
        out = _artifact(arch, shape_name, quant_bits, tag)
        out.write_text(json.dumps(result, indent=1, default=str))
    return result


def _run_cell_task(task):
    """One cell in a worker process (spawned: a fresh interpreter that
    imports this module); one torch thread, the cells run side by
    side."""
    torch.set_num_threads(1)
    arch, shape, kw = task
    return run_cell(arch, shape, **kw)


def _trace_weight(task) -> int:
    """A rough count of a cell's traced ops: a Mamba layer scans a
    full-sequence step in chunks (its ops grow with the length), any
    other layer's ops do not; a decode step is one token."""
    arch, shape, _ = task
    cfg, s = get_config(arch), SHAPES[shape]
    if s.kind == "decode":
        return cfg.n_layers
    mamba = sum(spec.kind == "mamba" for spec in cfg.layer_specs())
    return cfg.n_layers * 64 + mamba * s.seq_len // 32


def run_cells(tasks, jobs=1) -> list:
    """run_cell over `tasks`, (arch, shape, run_cell's keyword
    arguments) each, in `jobs` worker processes at once (in this
    process for 1), the cells with the most ops handed out first.
    Results in the tasks' order."""
    if jobs <= 1:
        return [run_cell(arch, shape, **kw) for arch, shape, kw in tasks]
    order = sorted(range(len(tasks)), key=lambda i: -_trace_weight(tasks[i]))
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(min(jobs, len(tasks))) as pool:
        done = pool.map(_run_cell_task, [tasks[i] for i in order],
                        chunksize=1)
    out = [None] * len(tasks)
    for i, r in zip(order, done):
        out[i] = r
    return out


def cells(quant_bits=None) -> list:
    """(arch, shape) of every runnable cell: the 32 of the ten pool
    architectures, or with `quant_bits` the inference ones (training
    is not packed)."""
    return [(arch, s.name) for arch, cfg in ASSIGNED.items()
            for s in runnable_shapes(cfg)
            if not (quant_bits and s.kind == "train")]


def summary_line(r) -> str:
    status = "OK " if r["ok"] else "FAIL"
    if r["ok"]:
        rf, mem = r["roofline"], r["memory"]
        extra = (f"bound={rf['bound']:10s} "
                 f"tC={rf['t_compute_s']:.3e} tM={rf['t_memory_s']:.3e} "
                 f"tX={rf['t_collective_s']:.3e} "
                 f"peak={mem['peak_live_bytes_est'] / 1e9:.1f}GB "
                 f"trace={r['t_trace_s']:.1f}s")
    else:
        extra = r["error"][:160]
    return (f"[{status}] {r['arch']:26s} {r['shape']:12s} {r['mesh']:8s} "
            f"{extra}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--quant", type=int, default=None,
                    help="GPTQT weight bits for inference cells")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--no-probe", action="store_true",
                    help="skip the 2/3-group cost probes (the full-depth "
                         "trace's own count gives the roofline)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in its own process")
    args = ap.parse_args(argv)
    _refuse_meshes(args.multipod, not args.no_fsdp)

    if args.all:
        todo = cells(args.quant)
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        todo = [(args.arch, args.shape)]

    kw = dict(quant_bits=args.quant, microbatches=args.microbatches,
              remat=args.remat, tag=args.tag, probe=not args.no_probe)
    results = run_cells([(arch, shape, kw) for arch, shape in todo],
                        args.jobs)
    n_ok = 0
    for r in results:
        n_ok += r["ok"]
        print(summary_line(r), flush=True)
    print(f"{n_ok}/{len(todo)} cells OK")
    return 0 if n_ok == len(todo) else 1


if __name__ == "__main__":
    raise SystemExit(main())
