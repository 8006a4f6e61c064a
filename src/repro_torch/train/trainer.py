"""Training loop with fault tolerance (the reference's
`train/trainer.py`): auto-resume from the latest committed checkpoint,
periodic async saves, preemption handling (SIGTERM -> checkpoint and a
clean exit) and straggler detection (per-step wall-time EWMA; steps
slower than `straggler_factor` x EWMA are logged).

Initial params come from models.init_params (a torch.Generator seeded
with `seed`) on `device` (default cuda), stacked into the reference's
layout, the layout the state keeps and the checkpoints hold. A run
started from a reference checkpoint (its step-0 state, say) resumes
from it like any other.

With a bound `mesh` (dist/context.py; every rank of it runs a Trainer,
as launch/train.py's ranks do) each rank keeps its blocks of the state
(dist/sharding.py:shard_train_state of the seeded whole init), steps on
the mesh (make_train_step(mesh=)), and checkpoints whole: a checkpoint
written on any mesh resumes on any other or on one device. The ranks
agree at each step whether any of them was sent SIGTERM (a barrier), so
all save and stop at the same step; each logs its own stragglers.
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field

from repro_torch.ckpt.checkpoint import CheckpointManager, stack_params
from repro_torch.dist.context import mesh_any
from repro_torch.hw import resolve_device
from repro_torch.models.model import init_params
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import init_train_state, make_train_step


@dataclass
class TrainerConfig:
    steps: int = 200
    ckpt_every: int = 50
    ckpt_dir: str = "artifacts/ckpt"
    keep_n: int = 3
    log_every: int = 10
    microbatches: int = 1
    grad_compress: str = "none"
    warmup: int = 20
    straggler_factor: float = 3.0
    seed: int = 0
    opt: AdamWConfig = field(default_factory=AdamWConfig)


class Trainer:
    def __init__(self, cfg, tcfg: TrainerConfig, data_iter, *, dtype=None,
                 device=None, mesh=None, fsdp: bool = True):
        self.cfg = cfg
        self.tcfg = tcfg
        self.data = data_iter
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.device = (self.mesh.device if self.mesh is not None
                       else resolve_device(device))
        self.ckpt = CheckpointManager(tcfg.ckpt_dir, keep_n=tcfg.keep_n)
        self.params = stack_params(cfg, init_params(
            cfg, seed=tcfg.seed, dtype=dtype, device=self.device))
        self.layout = None
        if self.mesh is not None:
            from repro_torch.dist.sharding import TrainLayout
            self.layout = TrainLayout(cfg, self.mesh, fsdp)
            # the moments and the master copy of the blocks are the
            # blocks of the whole init's
            self.params, _ = self.layout.shard(self.params, {})
        self.opt_state = init_train_state(cfg, self.params, tcfg.opt)
        self.step = 0
        self.metrics_log: list = []
        self._preempted = False
        self._step_fn = make_train_step(
            cfg, tcfg.opt, microbatches=tcfg.microbatches,
            grad_compress=tcfg.grad_compress, warmup=tcfg.warmup,
            total_steps=tcfg.steps, mesh=self.mesh, fsdp=fsdp)

    # ---- fault tolerance ----
    def try_resume(self):
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        state, meta = self.ckpt.restore(
            {"params": self.params, "opt": self.opt_state},
            layout=self.layout)
        self.params, self.opt_state = state["params"], state["opt"]
        self.step = meta["step"]
        return True

    def _save(self, block=False):
        self.ckpt.save(self.step, {"params": self.params,
                                   "opt": self.opt_state}, block=block,
                       layout=self.layout)

    def _on_preempt(self, *_):
        self._preempted = True

    def _stop(self) -> bool:
        """Whether this rank, or on a mesh any rank, was preempted."""
        if self.mesh is None:
            return self._preempted
        return mesh_any(self._preempted, self.mesh)

    # ---- loop ----
    def run(self):
        resumed = self.try_resume()
        old = signal.signal(signal.SIGTERM, self._on_preempt)
        ewma = None
        stragglers = 0
        try:
            while self.step < self.tcfg.steps and not self._stop():
                batch = next(self.data)
                t0 = time.time()
                self.params, self.opt_state, m = self._step_fn(
                    self.params, self.opt_state, batch)
                loss = float(m["loss"])  # also waits for the step
                dt = time.time() - t0
                ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
                if dt > self.tcfg.straggler_factor * ewma and self.step > 5:
                    stragglers += 1
                    rank = "" if self.mesh is None else \
                        f" rank {self.mesh.rank}"
                    print(f"[straggler]{rank} step {self.step}: {dt:.2f}s "
                          f"vs EWMA {ewma:.2f}s")
                self.step += 1
                self.metrics_log.append(
                    {"step": self.step, "loss": loss, "sec": dt})
                if (self.step % self.tcfg.log_every == 0
                        and (self.mesh is None or self.mesh.rank == 0)):
                    print(f"step {self.step:5d} loss {loss:.4f} "
                          f"({dt:.2f}s/step)", flush=True)
                if self.step % self.tcfg.ckpt_every == 0:
                    self._save()
            self._save(block=True)
        finally:
            signal.signal(signal.SIGTERM, old)
            self.ckpt.wait()
        return {"resumed": resumed, "final_step": self.step,
                "stragglers": stragglers,
                "final_loss": self.metrics_log[-1]["loss"]
                if self.metrics_log else float("nan")}
