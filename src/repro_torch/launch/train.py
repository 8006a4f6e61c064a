"""Training launcher: a train loop with checkpoints and auto-resume, on
one device or over a mesh of ranks (the reference's `launch/train.py`).

  PYTHONPATH=src python -m repro_torch.launch.train --arch tiny-lm \\
      --steps 50 [--batch 8] [--seq 128] [--microbatches 1] \\
      [--grad-compress none|int8] [--ckpt-dir DIR] [--ckpt-every 25] \\
      [--dtype float32|bfloat16] [--device cuda|cpu] \\
      [--mesh host|pod|D,M [--devices DEV,...] [--no-fsdp]]

Params start from init_params (seed 0) and train on the wiki corpus
(data/corpus.py:batches, seed 0) with AdamW (lr 1e-3; fp32 master
weights for bf16 params) under the cosine schedule over --steps. A
committed checkpoint in --ckpt-dir (either package's, written on any
mesh) resumes the run at its step; checkpoints land every --ckpt-every
steps and at the end, whole, in the reference's format.

`--mesh D,M` trains over a (data, model) mesh of D x M ranks, one
process each (dist/context.py:spawn): every rank keeps its blocks of the
params and the AdamW state by the reference's rules (FSDP on the data
axis unless --no-fsdp; dist/sharding.py:TrainLayout) and takes its rows
of each global batch. `--devices` names each rank's device (default one
card a rank; "cuda:0,cuda:0" rehearses two ranks on one card, "cpu,cpu"
on the CPU); `--mesh pod` is make_production_mesh over the visible cards
(or --devices), all on the data axis. Every family trains on a mesh
(dense, MoE with its experts on the model axis, MLA, Mamba, hybrids);
a model axis that does not divide a MoE config's experts is ROADMAP
Queue 1 item 6.5, `--mesh multipod` item 6.2. Rank 0 prints.
"""
from __future__ import annotations

import argparse
import time


def _parser():
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", default="tiny-lm")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh", default="host", metavar="host|pod|multipod|D,M")
    ap.add_argument("--devices", default=None, metavar="DEV,DEV,...",
                    help="with --mesh pod|D,M: each rank's device in rank "
                         "order (default one card a rank)")
    ap.add_argument("--no-fsdp", action="store_true",
                    help="on a mesh, keep the weights whole on the data "
                         "axis (the reference's fsdp=False)")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compress", default="none",
                    choices=["none", "int8"])
    ap.add_argument("--ckpt-dir", default="artifacts/launch_train")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the device without --mesh (with it, --devices)")
    return ap


def _train(args, mesh=None):
    """The loop on one device, or on this rank of a bound `mesh`: ->
    (params, optimizer state: the rank's blocks on a mesh; the loss of
    every step run; the TrainLayout, None on one device)."""
    from repro_torch.ckpt import CheckpointManager, stack_params
    from repro_torch.configs import get_config
    from repro_torch.data import batches, token_stream
    from repro_torch.models import init_params
    from repro_torch.train import (AdamWConfig, init_train_state,
                                   make_train_step)

    lead = mesh is None or mesh.rank == 0
    cfg = get_config(args.arch).replace(dtype=args.dtype)
    opt_cfg = AdamWConfig(lr=1e-3, master_fp32=args.dtype == "bfloat16")
    data = batches(token_stream("wiki", 400_000), args.batch, args.seq,
                   seed=0)
    device = args.device if mesh is None else mesh.device
    params = stack_params(cfg, init_params(cfg, seed=0, device=device))
    layout = None
    if mesh is not None:
        from repro_torch.dist.sharding import TrainLayout
        layout = TrainLayout(cfg, mesh, fsdp=not args.no_fsdp)
        params, _ = layout.shard(params, {})
    opt_state = init_train_state(cfg, params, opt_cfg)
    ckpt = CheckpointManager(args.ckpt_dir)
    start = 0
    if ckpt.latest_step() is not None:
        state, meta = ckpt.restore({"params": params, "opt": opt_state},
                                   layout=layout)
        params, opt_state = state["params"], state["opt"]
        start = meta["step"]
        if lead:
            print(f"resumed from step {start}")
    step_fn = make_train_step(cfg, opt_cfg, microbatches=args.microbatches,
                              grad_compress=args.grad_compress,
                              total_steps=args.steps, mesh=mesh,
                              fsdp=not args.no_fsdp)
    losses = []
    for step in range(start, args.steps):
        batch = next(data)
        t0 = time.time()
        params, opt_state, m = step_fn(params, opt_state, batch)
        losses.append(float(m["loss"]))
        if (step + 1) % 10 == 0 and lead:
            print(f"step {step + 1:5d} loss {losses[-1]:.4f} "
                  f"({time.time() - t0:.2f}s)", flush=True)
        if (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, {"params": params, "opt": opt_state},
                      layout=layout)
    ckpt.save(args.steps, {"params": params, "opt": opt_state}, block=True,
              layout=layout)
    if lead:
        print("training complete")
    return params, opt_state, losses, layout


def train_rank(mesh, argv):
    """One rank of `--mesh`: train, then gather the whole state. -> on
    rank 0 {"params", "opt" (numpy trees), "losses"}; None elsewhere."""
    from repro_torch.tree import tree_map
    params, opt_state, losses, layout = _train(_parser().parse_args(argv),
                                               mesh)
    params, opt_state = layout.gather_state(params, opt_state)
    if mesh.rank:
        return None
    host = lambda t: t.detach().cpu().numpy()      # noqa: E731
    return {"params": tree_map(host, params), "opt": tree_map(host, opt_state),
            "losses": losses}


def main(argv=None):
    """Parse `argv`, train; returns (params in the stacked layout,
    optimizer state, the loss of every step run): on a mesh rank 0's
    losses and the whole trained state (on the CPU)."""
    import sys
    ap = _parser()
    args = ap.parse_args(argv)
    if args.mesh == "host":
        if args.devices:
            ap.error("--devices names a mesh's devices: it needs --mesh "
                     "pod or D,M")
        return _train(args)[:3]

    import torch
    from repro_torch.dist.context import spawn
    from repro_torch.launch.mesh import make_production_mesh, make_serve_mesh
    from repro_torch.tree import tree_map
    if args.mesh in ("pod", "multipod"):
        mesh = make_production_mesh(multi_pod=args.mesh == "multipod",
                                    devices=args.devices)
    else:
        try:
            d, m = (int(x) for x in args.mesh.replace("x", ",").split(","))
        except ValueError:
            ap.error(f"--mesh {args.mesh!r}: host, pod, multipod or D,M")
        mesh = make_serve_mesh(d, m, args.devices)
    print(f"training over {mesh.describe()}"
          f"{' (no fsdp)' if args.no_fsdp else ''}", flush=True)
    out = spawn(train_rank, mesh, (list(sys.argv[1:] if argv is None
                                        else argv),))[0]
    back = lambda a: torch.from_numpy(a)           # noqa: E731
    return (tree_map(back, out["params"]), tree_map(back, out["opt"]),
            out["losses"])


if __name__ == "__main__":
    main()
