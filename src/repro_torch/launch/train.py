"""Training launcher: a train loop with checkpoints and auto-resume on
one device (the reference's `launch/train.py`).

  PYTHONPATH=src python -m repro_torch.launch.train --arch tiny-lm \\
      --steps 50 [--batch 8] [--seq 128] [--microbatches 1] \\
      [--grad-compress none|int8] [--ckpt-dir DIR] [--ckpt-every 25] \\
      [--dtype float32|bfloat16] [--device cuda|cpu]

Params start from init_params (seed 0) and train on the wiki corpus
(data/corpus.py:batches, seed 0) with AdamW (lr 1e-3; fp32 master
weights for bf16 params) under the cosine schedule over --steps. A
committed checkpoint in --ckpt-dir (either package's) resumes the run
at its step; checkpoints land every --ckpt-every steps and at the end.
`--mesh pod|multipod` (the reference's TPU meshes) is refused: FSDP
training over a mesh is still to do (ROADMAP Queue 1 item 6; meshes
serve through launch/serve.py --mesh).
"""
from __future__ import annotations

import argparse
import time


def main(argv=None):
    """Parse `argv`, train; returns (params in the stacked layout,
    optimizer state, the loss of every step run)."""
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", default="tiny-lm")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh", choices=["host", "pod", "multipod"],
                    default="host")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compress", default="none",
                    choices=["none", "int8"])
    ap.add_argument("--ckpt-dir", default="artifacts/launch_train")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.mesh != "host":
        raise NotImplementedError(
            f"--mesh {args.mesh}: FSDP training over a mesh is still to "
            f"do (ROADMAP Queue 1 item 6); the port trains on one device "
            f"and serves on meshes (launch/serve.py --mesh)")

    from repro_torch.ckpt import CheckpointManager, stack_params
    from repro_torch.configs import get_config
    from repro_torch.data import batches, token_stream
    from repro_torch.models import init_params
    from repro_torch.train import (AdamWConfig, init_train_state,
                                   make_train_step)

    cfg = get_config(args.arch).replace(dtype=args.dtype)
    opt_cfg = AdamWConfig(lr=1e-3, master_fp32=args.dtype == "bfloat16")
    data = batches(token_stream("wiki", 400_000), args.batch, args.seq,
                   seed=0)
    params = stack_params(cfg, init_params(cfg, seed=0, device=args.device))
    opt_state = init_train_state(cfg, params, opt_cfg)
    ckpt = CheckpointManager(args.ckpt_dir)
    start = 0
    if ckpt.latest_step() is not None:
        state, meta = ckpt.restore({"params": params, "opt": opt_state})
        params, opt_state = state["params"], state["opt"]
        start = meta["step"]
        print(f"resumed from step {start}")
    step_fn = make_train_step(cfg, opt_cfg, microbatches=args.microbatches,
                              grad_compress=args.grad_compress,
                              total_steps=args.steps)
    losses = []
    for step in range(start, args.steps):
        batch = next(data)
        t0 = time.time()
        params, opt_state, m = step_fn(params, opt_state, batch)
        losses.append(float(m["loss"]))
        if (step + 1) % 10 == 0:
            print(f"step {step + 1:5d} loss {losses[-1]:.4f} "
                  f"({time.time() - t0:.2f}s)", flush=True)
        if (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, {"params": params, "opt": opt_state})
    ckpt.save(args.steps, {"params": params, "opt": opt_state}, block=True)
    print("training complete")
    return params, opt_state, losses


if __name__ == "__main__":
    main()
