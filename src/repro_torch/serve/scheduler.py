"""Continuous-batching scheduler: FCFS admission gated on free KV pages,
prefix-sharing-aware accounting, chunked prefill, preemption by
eviction, and per-request TTFT/TPOT metrics (the reference's
`serve/scheduler.py`).

The scheduler owns the queue and the page accounting; the engine owns
the model calls.

  - admission: FCFS. A request is admitted when a sequence slot is free
    AND the pool can hold its prompt pages, one decode token and
    `watermark` spare pages. With a prefix index, admission charges only
    the unshared suffix: matched pages are attached by reference, plus
    one fork page when the match ends mid-page (copy-on-write).
  - prefill: optionally chunked (`prefill_chunk`): at most one chunk of
    one admitted request runs per engine tick, so a long prompt cannot
    stall the decode ticks of running sequences.
  - preemption: when growth runs out of pages, the allocator first
    reclaims the index's unused pages; only then is the *youngest*
    running sequence evicted: its references are dropped and it is
    re-queued at the front with prompt := prompt + tokens generated so
    far (recompute on resume, exact under greedy decoding; the index
    usually still holds its prompt pages, so the resumed prompt
    re-matches them).
  - recurrent state: with a StateSlabPool (`slab=`, Mamba layers),
    admission also claims one state slab; slab exhaustion declines the
    admission like page exhaustion, and the slab returns at finish and
    at preemption.
  - shards: over a sharded pool (a serving mesh's data axis) admission
    first picks the shard (the most free pages among shards with a free
    slot), and the prefix match, the page accounting, the reclaim and
    the preemption victim all stay within the shard its slot lives on.

Every decision is a function of the queue and the allocator alone (the
victim and the chunk to prefill go by admission order, never by a
clock), so the ranks of a mesh, each running this scheduler over the
whole batch, make the same decisions.
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
    n_prefix_tokens: int = 0          # prompt tokens served from the index

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
    prefilled: int = 0                # prompt tokens already in pages
    shared_tokens: int = 0            # prefix tokens matched at admission
    shared_pages: list = field(default_factory=list)
    admitted: int = -1                # admission order (last admission)


class Scheduler:
    """FCFS continuous batching over a PagedKVCache (or the dense
    engine's DenseSlotPool, which speaks the same allocator protocol)."""

    def __init__(self, kv, *, watermark: int = 1,
                 prefill_chunk: int | None = None, prefix=None,
                 slab=None):
        self.kv = kv
        self.watermark = int(watermark)
        self.prefill_chunk = prefill_chunk
        self.prefix = prefix              # RadixPrefixCache or None
        self.slab = slab                  # StateSlabPool or None
        self.waiting: deque[_Entry] = deque()
        self.running: dict[int, _Entry] = {}   # slot -> entry
        self.preemptions = 0
        self._admissions = 0

    # ---------------- queue ----------------
    def submit(self, req) -> None:
        e = _Entry(req=req, prompt=np.asarray(req.prompt, np.int32))
        e.metrics.t_submit = time.time()
        e.metrics.n_prompt = len(e.prompt)
        self.waiting.append(e)

    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    # ---------------- admission ----------------
    def admission_need(self, prompt_len: int, *, resumed: bool = False,
                       shared_tokens: int = 0) -> int:
        """Free pages required to admit a prompt: its pages + one decode
        token + the watermark, minus the pages covering the shared
        prefix (attached by reference), plus one fork page when the
        match ends mid-page. Resumed (preempted) entries skip the
        watermark so they can get back in and finish. The engine's
        run()-time validation uses shared_tokens=0 (sharing is
        best-effort)."""
        wm = 0 if resumed else self.watermark
        need = self.kv.pages_for(prompt_len + 1) + wm
        if shared_tokens:
            need -= self.kv.pages_for(shared_tokens)
            if shared_tokens % self.kv.page_size:
                need += 1
        return need

    def try_admit(self) -> _Entry | None:
        """Admit the queue head if a slot and its unshared prompt pages
        fit, reclaiming the index's unused pages when that is what
        stands in the way. The prefix match is re-run after every
        reclaim round (an eviction may have dropped pages it matched),
        and counts as one lookup however many rounds it takes. The
        match, the accounting and the reclaim run against the shard
        picked first: an admitted sequence's pages come from the shard
        its slot lives on."""
        if not self.waiting or len(self.running) >= self.kv.max_seqs:
            return None
        e = self.waiting[0]
        resumed = e.metrics.n_preemptions > 0
        shard = self.kv.pick_shard()
        if shard is None:
            return None
        usable = self.kv.usable_in_shard(shard)
        count = True
        while True:
            shared_tokens, shared_pages = 0, []
            if self.prefix is not None and len(e.prompt) > 1:
                shared_tokens, shared_pages = self.prefix.lookup(
                    e.prompt, max_tokens=len(e.prompt) - 1, shard=shard,
                    count=count)
                count = False
            need = self.admission_need(len(e.prompt), resumed=resumed,
                                       shared_tokens=shared_tokens)
            if need > usable:
                raise ValueError(
                    f"request needs {need} pages but a pool shard only "
                    f"has {usable}; it can never be admitted")
            free = self.kv.free_in_shard(shard)
            if need <= free:
                break
            if (self.prefix is None
                    or self.prefix.evict(need - free, shard=shard) == 0):
                return None
        slot = self.kv.alloc_slot(shard=shard)
        if slot is None:
            return None
        if self.slab is not None:
            try:
                self.slab.alloc(slot)
            except OutOfPages:
                # no free slab: give the slot back (nothing was
                # allocated) and wait for a running sequence's slab
                self.kv.release(slot)
                return None
        self.waiting.popleft()
        e.slot = slot
        e.prefilled = 0
        e.shared_tokens = shared_tokens
        e.shared_pages = list(shared_pages)
        if shared_tokens:
            self.prefix.hits += 1
            self.prefix.tokens_saved += shared_tokens
            e.metrics.n_prefix_tokens += shared_tokens
        e.metrics.t_admit = time.time()
        e.admitted = self._admissions
        self._admissions += 1
        self.running[slot] = e
        return e

    # ---------------- preemption ----------------
    def _preempt_slot(self, slot: int) -> _Entry:
        """Evict one running sequence and requeue it at the front with
        prompt := prompt + generated-so-far."""
        e = self.running.pop(slot)
        self.kv.release(slot)
        if self.slab is not None:
            self.slab.release(slot)
        if e.req.out:
            e.prompt = np.concatenate([np.asarray(e.req.prompt, np.int32),
                                       np.asarray(e.req.out, np.int32)])
        e.slot = -1
        e.prefilled = 0
        e.shared_tokens = 0
        e.shared_pages = []
        e.metrics.n_preemptions += 1
        self.preemptions += 1
        self.waiting.appendleft(e)
        return e

    def preempt_one(self, shard: int | None = None) -> _Entry | None:
        """Evict the youngest running sequence that owns pages (LIFO
        victim policy): evicting a freshly admitted page-less entry
        (chunked mode reserves the slot before any page) frees
        nothing. With `shard`, only that shard's sequences are
        candidates (pages freed elsewhere cannot relieve it)."""
        cands = [s for s in self.running
                 if shard is None or self.kv.shard_of_slot(s) == shard]
        if not cands:
            return None
        owners = [s for s in cands if self.kv.owned_pages(s)]
        slot = max(owners or cands, key=lambda s: self.running[s].admitted)
        return self._preempt_slot(slot)

    def ensure_write_capacity(self, slot: int, start_tok: int,
                              end_tok: int):
        """Grow `slot` to hold end_tok tokens and fork shared pages in
        [start_tok, end_tok), evicting other sequences while the pool is
        dry, within the slot's shard (the allocator reclaims that
        shard's unused index pages first). Returns (ok, copies): ok is
        False if `slot` itself got evicted; copies are the (src, dst)
        page forks to apply."""
        shard = self.kv.shard_of_slot(slot)
        while True:
            try:
                self.kv.ensure(slot, end_tok)
                return True, self.kv.cow_for_write(slot, start_tok, end_tok)
            except OutOfPages:
                if any(s != slot and self.kv.shard_of_slot(s) == shard
                       for s in self.running):
                    self.preempt_one(shard=shard)
                else:
                    self._preempt_slot(slot)
                if slot not in self.running:
                    return False, []

    # ---------------- completion ----------------
    def finish(self, slot: int, cached_tokens=None) -> None:
        """Complete a request. `cached_tokens` (given by the engine when
        a prefix index is attached) are the tokens whose KV the slot's
        pages hold, prompt + generated-minus-last; they are inserted
        into the index before the slot's references are dropped, so the
        pages outlive the request and seed later prefix hits."""
        e = self.running.pop(slot)
        if (self.prefix is not None and cached_tokens is not None
                and len(cached_tokens)):
            n = self.kv.pages_for(len(cached_tokens))
            self.prefix.insert(cached_tokens, self.kv.owned_pages(slot)[:n])
        self.kv.release(slot)
        if self.slab is not None:
            self.slab.release(slot)
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
        out = {
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
            "prefix_hits": 0,
            "prefix_lookups": 0,
            "prefix_hit_rate": 0.0,
            "prefix_tokens_saved": 0,
            "prefix_cached_pages": 0,
            "prefix_evictions": 0,
            "slab_usable_slabs": 0,
            "slab_high_water": 0,
            "slabs_allocated": 0,
        }
        if self.slab is not None:
            out.update({
                "slab_usable_slabs": self.slab.usable_slabs,
                "slab_high_water": self.slab.high_water,
                "slabs_allocated": self.slab.slabs_allocated})
        if self.prefix is not None:
            out.update({
                "prefix_hits": self.prefix.hits,
                "prefix_lookups": self.prefix.lookups,
                "prefix_hit_rate": self.prefix.hit_rate,
                "prefix_tokens_saved": self.prefix.tokens_saved,
                "prefix_cached_pages": self.prefix.cached_pages(),
                "prefix_evictions": self.prefix.evictions})
        return out
