"""Continuous-batching scheduler: FCFS admission gated on free KV pages,
preemption by eviction, and per-request TTFT/TPOT metrics (the
reference's `serve/scheduler.py` without a prefix index or chunked
prefill).

The scheduler owns the queue and the page accounting; the engine owns
the model calls.

  - admission: FCFS. A request is admitted when a sequence slot is free
    AND the pool can hold its prompt pages, one decode token and
    `watermark` spare pages.
  - preemption: when decode growth runs out of pages, the *youngest*
    running sequence is evicted: its pages are released and it is
    re-queued at the front with prompt := prompt + tokens generated so
    far (recompute on resume, exact under greedy decoding).
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from repro_torch.serve.kv_cache import OutOfPages


@dataclass
class RequestMetrics:
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0
    n_prompt: int = 0
    n_generated: int = 0
    n_preemptions: int = 0

    @property
    def ttft_s(self) -> float:
        return (self.t_first_token - self.t_submit) if self.t_first_token else 0.0

    @property
    def tpot_s(self) -> float:
        """Time per output token after the first."""
        if self.n_generated <= 1 or not self.t_done:
            return 0.0
        return (self.t_done - self.t_first_token) / (self.n_generated - 1)


@dataclass
class _Entry:
    req: object                       # engine Request
    prompt: np.ndarray                # current (possibly extended) prompt
    metrics: RequestMetrics = field(default_factory=RequestMetrics)
    slot: int = -1
    prefilled: int = 0                # prompt tokens already in the cache


class Scheduler:
    """FCFS continuous batching over a PagedKVCache (or the dense
    engine's DenseSlotPool, which speaks the same allocator protocol)."""

    def __init__(self, kv, *, watermark: int = 1):
        self.kv = kv
        self.watermark = int(watermark)
        self.waiting: deque[_Entry] = deque()
        self.running: dict[int, _Entry] = {}   # slot -> entry
        self.preemptions = 0

    # ---------------- queue ----------------
    def submit(self, req) -> None:
        e = _Entry(req=req, prompt=np.asarray(req.prompt, np.int32))
        e.metrics.t_submit = time.time()
        e.metrics.n_prompt = len(e.prompt)
        self.waiting.append(e)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # ---------------- admission ----------------
    def admission_need(self, prompt_len: int, *, resumed: bool = False) -> int:
        """Free pages required to admit a prompt: its pages + one decode
        token + the watermark (resumed, preempted entries skip the
        watermark so they can get back in and finish)."""
        wm = 0 if resumed else self.watermark
        return self.kv.pages_for(prompt_len + 1) + wm

    def try_admit(self) -> _Entry | None:
        """Admit the queue head if a slot and its prompt pages fit."""
        if not self.waiting or len(self.running) >= self.kv.max_seqs:
            return None
        e = self.waiting[0]
        need = self.admission_need(len(e.prompt),
                                   resumed=e.metrics.n_preemptions > 0)
        if need > self.kv.usable_pages:
            raise ValueError(
                f"request needs {need} pages but the pool only has "
                f"{self.kv.usable_pages}; it can never be admitted")
        if need > self.kv.free_page_count:
            return None
        slot = self.kv.alloc_slot()
        if slot is None:
            return None
        self.waiting.popleft()
        e.slot = slot
        e.prefilled = 0
        e.metrics.t_admit = time.time()
        self.running[slot] = e
        return e

    # ---------------- preemption ----------------
    def _preempt_slot(self, slot: int) -> _Entry:
        """Evict one running sequence and requeue it at the front with
        prompt := prompt + generated-so-far."""
        e = self.running.pop(slot)
        self.kv.release(slot)
        if e.req.out:
            e.prompt = np.concatenate([np.asarray(e.req.prompt, np.int32),
                                       np.asarray(e.req.out, np.int32)])
        e.slot = -1
        e.prefilled = 0
        e.metrics.n_preemptions += 1
        self.preemptions += 1
        self.waiting.appendleft(e)
        return e

    def preempt_one(self) -> _Entry | None:
        """Evict the youngest running sequence that owns pages (LIFO
        victim policy)."""
        if not self.running:
            return None
        owners = [s for s in self.running if self.kv.owned_pages(s)]
        slot = max(owners or self.running,
                   key=lambda s: self.running[s].metrics.t_admit)
        return self._preempt_slot(slot)

    def ensure_write_capacity(self, slot: int, start_tok: int,
                              end_tok: int):
        """Grow `slot` to hold end_tok tokens and fork shared pages in
        [start_tok, end_tok), evicting other sequences while the pool is
        dry. Returns (ok, copies): ok is False if `slot` itself got
        evicted; copies are the (src, dst) page forks to apply."""
        while True:
            try:
                self.kv.ensure(slot, end_tok)
                return True, self.kv.cow_for_write(slot, start_tok, end_tok)
            except OutOfPages:
                if any(s != slot for s in self.running):
                    self.preempt_one()
                else:
                    self._preempt_slot(slot)
                if slot not in self.running:
                    return False, []

    # ---------------- completion ----------------
    def finish(self, slot: int) -> None:
        e = self.running.pop(slot)
        self.kv.release(slot)
        e.metrics.t_done = time.time()
        e.metrics.n_generated = len(e.req.out)
        e.req.done = True

    def metrics_summary(self, entries) -> dict:
        """Aggregate per-request metrics, with the raw TTFT/TPOT sample
        lists for percentiles."""
        ms = [e.metrics for e in entries]
        done = [m for m in ms if m.t_done]
        ttft = [m.ttft_s for m in done]
        tpot = [m.tpot_s for m in done if m.n_generated > 1]
        return {
            "n_done": len(done),
            "preemptions": self.preemptions,
            "ttft_avg_s": float(np.mean(ttft)) if ttft else 0.0,
            "tpot_avg_s": float(np.mean(tpot)) if tpot else 0.0,
            "ttft_samples_s": ttft,
            "tpot_samples_s": tpot,
            "kv_high_water_pages": self.kv.high_water,
            "kv_usable_pages": self.kv.usable_pages,
            "pages_allocated": getattr(self.kv, "pages_allocated", 0),
            "cow_forks": getattr(self.kv, "cow_forks", 0),
        }
