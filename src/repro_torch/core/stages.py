"""Seconds per quantizer stage, for whoever asks.

The quantizer's stages (calibration forward, Hessian accumulation,
BCchoice search, re-explore, solve, pack) run inside `stage(name)`
blocks. They cost nothing unless a `StageTimer` is installed around the
call (`with StageTimer(sync) as t: quantize_model(...)`); then each
block is timed on the host clock between two calls of `sync` (pass
`torch.cuda.synchronize` on the card, so a stage's device work lands in
it) and summed into `t.seconds[name]`.
"""
from __future__ import annotations

import contextvars
import time
from contextlib import contextmanager

_CURRENT = contextvars.ContextVar("repro_torch_stage_timer", default=None)


class StageTimer:
    def __init__(self, sync=None):
        self.sync = sync or (lambda: None)
        self.seconds: dict = {}

    def __enter__(self):
        self._token = _CURRENT.set(self)
        return self

    def __exit__(self, *exc):
        _CURRENT.reset(self._token)
        return False


@contextmanager
def stage(name: str):
    timer = _CURRENT.get()
    if timer is None:
        yield
        return
    timer.sync()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        timer.sync()
        timer.seconds[name] = (timer.seconds.get(name, 0.0)
                               + time.perf_counter() - t0)
