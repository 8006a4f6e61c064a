"""Batched serving engine: continuous batching over prefill and greedy
decode with two cache backends behind one switch (the reference's
`serve/engine.py`).

  cache_kind="dense"  — `batch_size` sequences, each owning a dense
    max_len KV slab.
  cache_kind="paged"  — block-table paged KV (serve/kv_cache.py): all
    sequences share one page pool and admission is gated on free pages.
    Prefill runs on the bucket-padded prompt and its K/V is scattered
    into the sequence's pages; every decode step runs the paged-attention
    kernel over the pool. `kv_bits > 0` binary-codes the pool
    (quant/kv.py): K/V are quantized on write and the fused-dequant
    kernel reads the codes.

Both run on the FCFS Scheduler (serve/scheduler.py). Works with plain
weights or GPTQT-packed QuantizedTensor weights (dense or MoE expert
stacks): `layers.linear` and `models/moe.py` dispatch per leaf. Prompt lengths are padded to power-of-two buckets
(attention-only, no-window configs), as the reference does to bound its
compilations; the port keeps the buckets so that both run the same
shapes.

Decode always runs the full (batch_size,) row batch: rows without a
ready sequence are routed to the null page 0 through their block-table
row and keep an arbitrary position, so their K/V writes land in the
null page (the reference's live-row / null-row trick,
`serve/compile_cache.py` "decode_paged").

PyTorch runs eagerly, so there is no compile cache to share; timing
synchronizes the CUDA device where the reference blocks on its result.
Prefix sharing, chunked prefill, speculative decoding and meshes belong
to later slices and raise NotImplementedError.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.hw import resolve_device
from repro_torch.models.model import (decode_step, decode_step_paged,
                                      init_cache, prefill,
                                      require_attention_only,
                                      scatter_prefill_cache)
from repro_torch.serve.kv_cache import PagedKVCache
from repro_torch.serve.scheduler import Scheduler

MIN_BUCKET = 8


def bucket_len(n: int, cap: int) -> int:
    """Smallest power-of-two >= n (floor MIN_BUCKET), clamped to cap."""
    b = MIN_BUCKET
    while b < n:
        b *= 2
    return min(b, cap)


def params_to(params, device):
    """The param tree (dicts, lists, tensors, QuantizedTensors) on
    `device`; leaves already there are not copied."""
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to(v, device) for v in params]
    return params.to(device)


@dataclass
class Request:
    prompt: np.ndarray
    max_new_tokens: int = 32
    eos: int | None = None
    out: list = field(default_factory=list)
    done: bool = False


class DenseSlotPool:
    """Slot accounting so the Scheduler drives the dense engine too: one
    fixed max_len 'page' per sequence."""

    def __init__(self, n_slots: int):
        self.max_seqs = n_slots
        self._active = np.zeros((n_slots,), bool)
        self.high_water = 0
        self.usable_pages = n_slots

    def pages_for(self, n_tokens: int) -> int:
        return 1

    @property
    def free_page_count(self) -> int:
        return int((~self._active).sum())

    @property
    def used_pages(self) -> int:
        return int(self._active.sum())

    def alloc_slot(self):
        for i in range(self.max_seqs):
            if not self._active[i]:
                self._active[i] = True
                self.high_water = max(self.high_water, self.used_pages)
                return i
        return None

    def owned_pages(self, slot: int):
        return [slot] if self._active[slot] else []

    def release(self, slot: int) -> None:
        self._active[slot] = False


class ServeEngine:
    def __init__(self, cfg, params, *, batch_size=4, max_len=512,
                 dtype=None, cache_kind="dense",
                 page_size=64, n_pages=None, prefill_chunk=None,
                 prefix_sharing=False,
                 mesh=None, kv_bits=0, kv_group_size=0, speculate=0,
                 device=None):
        if cache_kind not in ("dense", "paged"):
            raise ValueError(f"cache_kind={cache_kind!r}")
        if kv_bits and cache_kind != "paged":
            raise ValueError(
                "kv_bits requires cache_kind='paged': the binary-coded "
                "KV layout lives in the page pool (quantize-on-write "
                "needs page-granular scatter)")
        if prefix_sharing:
            raise NotImplementedError(
                "prefix_sharing=True comes with the prefix-cache slice "
                "(ROADMAP Queue 1 item 1: prefix cache, extend path, COW "
                "copies)")
        if prefill_chunk:
            raise NotImplementedError(
                "prefill_chunk comes with the chunked-prefill slice "
                "(ROADMAP Queue 1 item 2)")
        if speculate:
            raise NotImplementedError(
                "speculate > 0 comes with the speculative-decoding slice "
                "(ROADMAP Queue 1 item 4)")
        if mesh is not None:
            raise NotImplementedError(
                "mesh serving comes with the multi-GPU slice (ROADMAP "
                "Queue 1 item 6)")
        require_attention_only(cfg)
        if cache_kind == "paged" and any(s.window is not None
                                         for s in cfg.pattern):
            raise NotImplementedError(
                "paged sliding-window layers prefill through the extend "
                "path, which comes with the prefix-cache slice (ROADMAP "
                "Queue 1 item 1)")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params_to(params, self.device)
        self.B = batch_size
        self.max_len = max_len
        self.cache_kind = cache_kind
        self.kv_bits = int(kv_bits)
        dtype = dtype or cfg.dtype
        self._bucket = all(s.window is None for s in cfg.pattern)
        if cache_kind == "paged":
            pages_per_seq = -(-max_len // page_size)
            if n_pages is None:
                # the dense engine's byte budget + the null page
                n_pages = batch_size * pages_per_seq + 1
            self.kv = PagedKVCache(cfg, n_pages=n_pages, page_size=page_size,
                                   max_seqs=batch_size,
                                   max_pages_per_seq=pages_per_seq,
                                   dtype=dtype, kv_bits=kv_bits,
                                   kv_group_size=kv_group_size,
                                   device=self.device)
            self.page_size = page_size
            self.cache = self.kv.take_pool()
            # device mirror of the block tables: rows are pushed only when
            # the allocator bumps their version
            self._bt_dev = torch.zeros((batch_size, pages_per_seq),
                                       dtype=torch.int32, device=self.device)
            self._bt_applied = np.full((batch_size,), -1, np.int64)
        else:
            self.kv = DenseSlotPool(batch_size)
            self.cache = init_cache(cfg, batch_size, max_len, dtype,
                                    device=self.device)
        # one spare page keeps a decode tick's growth from starving at once
        self.sched = Scheduler(self.kv,
                               watermark=1 if cache_kind == "paged" else 0)
        self.pos = np.zeros((batch_size,), np.int32)
        self.cur = np.zeros((batch_size,), np.int32)
        self.stats = {"prefill_s": 0.0, "decode_s": 0.0, "tokens": 0,
                      "ticks": 0, "prefill_tokens": 0}
        self._entries = []

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _ints(self, arr) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr, np.int32), device=self.device)

    # ---------------- device block-table mirror ----------------
    def _sync_block_tables(self) -> None:
        dirty = [s for s in range(self.B)
                 if self._bt_applied[s] != self.kv.bt_version[s]]
        if not dirty:
            return
        self._bt_dev[self._ints(dirty).long()] = self._ints(
            self.kv.block_tables[dirty])
        for s in dirty:
            self._bt_applied[s] = self.kv.bt_version[s]

    # ---------------- admission ----------------
    def _padded_prompt(self, prompt):
        L = len(prompt)
        S = bucket_len(L, self.max_len) if self._bucket else L
        padded = np.zeros((S,), np.int32)
        padded[:L] = prompt
        return padded, L

    def _admit(self, e):
        t0 = time.time()
        padded, L = self._padded_prompt(e.prompt)
        tokens = self._ints(padded[None, :])
        last = self._ints([L - 1])
        self.stats["prefill_tokens"] += L
        if self.cache_kind == "paged":
            self.kv.ensure(e.slot, L)
            last_logits, row_cache = prefill(self.cfg, self.params, tokens,
                                             len(padded), last_pos=last)
            npg = -(-len(padded) // self.page_size)
            ids = self.kv.owned_pages(e.slot)
            ids = (ids + [0] * npg)[:npg]       # null-page pad: never written
            scatter_prefill_cache(self.cfg, self.cache, row_cache, e.slot,
                                  ids, L)
        else:
            last_logits, row_cache = prefill(self.cfg, self.params, tokens,
                                             self.max_len, last_pos=last)
            for layer, one in zip(self.cache, row_cache):
                for side in ("k", "v"):
                    layer[side][e.slot] = one[side][0]
        self._emit_first_token(e, last_logits, L)
        self._sync()
        self.stats["prefill_s"] += time.time() - t0

    def _emit_first_token(self, e, last_logits, prompt_len):
        tok = int(torch.argmax(last_logits[0]))
        e.req.out.append(tok)
        if not e.metrics.t_first_token:
            e.metrics.t_first_token = time.time()
        self.pos[e.slot] = prompt_len
        self.cur[e.slot] = tok
        e.prefilled = prompt_len
        if (len(e.req.out) >= e.req.max_new_tokens
                or (e.req.eos is not None and tok == e.req.eos)):
            self.sched.finish(e.slot)

    # ---------------- decode ----------------
    def _decode_tick(self):
        ready = [s for s, e in self.sched.running.items()
                 if e.prefilled >= len(e.prompt)]
        if not ready:
            return
        if self.cache_kind == "paged":
            grown = []
            for slot in ready:
                if slot not in self.sched.running:
                    continue    # evicted while growing an earlier slot
                p = int(self.pos[slot])
                ok, copies = self.sched.ensure_write_capacity(slot, p, p + 1)
                if copies:
                    raise NotImplementedError(
                        "COW page copies come with the prefix-cache slice "
                        "(ROADMAP Queue 1 item 1)")
                if ok:
                    grown.append(slot)
            ready = [s for s in grown if s in self.sched.running]
            if not ready:
                return
        t0 = time.time()
        toks = self._ints(self.cur[:, None])
        pos = self._ints(self.pos)
        if self.cache_kind == "paged":
            self._sync_block_tables()
            live = np.zeros((self.B,), bool)
            live[ready] = True
            # inactive rows read and write the null page 0
            bt = torch.where(torch.as_tensor(live, device=self.device)[:, None],
                             self._bt_dev, 0)
            logits, self.cache = decode_step_paged(
                self.cfg, self.params, self.cache, toks, pos, bt.contiguous())
        else:
            logits, self.cache = decode_step(self.cfg, self.params,
                                             self.cache, toks, pos)
        nxt = torch.argmax(logits, dim=-1).cpu().numpy()
        self._sync()
        self.stats["decode_s"] += time.time() - t0
        self.stats["ticks"] += 1
        for slot in ready:
            e = self.sched.running[slot]
            self.stats["tokens"] += 1
            tok = int(nxt[slot])
            e.req.out.append(tok)
            self.pos[slot] += 1
            self.cur[slot] = tok
            hit_eos = e.req.eos is not None and tok == e.req.eos
            if (len(e.req.out) >= e.req.max_new_tokens or hit_eos
                    or self.pos[slot] >= self._seq_cap() - 1):
                self.sched.finish(slot)

    # ---------------- engine ----------------
    def _seq_cap(self) -> int:
        """Per-sequence token capacity: max_len, further bounded by what
        the page pool can hold for one sequence."""
        if self.cache_kind == "dense":
            return self.max_len
        return min(self.max_len, self.kv.usable_pages * self.page_size)

    def run(self, requests: list[Request]):
        cap = self._seq_cap()
        # validate the whole batch before submitting anything
        for r in requests:
            if len(r.prompt) >= cap:
                raise ValueError(
                    f"prompt of {len(r.prompt)} tokens cannot fit the "
                    f"engine capacity of {cap} tokens")
            if self.cache_kind == "paged":
                need = self.sched.admission_need(len(r.prompt))
                if need > self.kv.usable_pages:
                    raise ValueError(
                        f"prompt of {len(r.prompt)} tokens needs {need} "
                        f"pages (incl. watermark) but the pool only has "
                        f"{self.kv.usable_pages}")
        for r in requests:
            self.sched.submit(r)
        self._entries = list(self.sched.waiting)
        while self.sched.has_work():
            while True:
                e = self.sched.try_admit()
                if e is None:
                    break
                self._admit(e)
            self._decode_tick()
        self.stats.update(self.sched.metrics_summary(self._entries))
        return requests
