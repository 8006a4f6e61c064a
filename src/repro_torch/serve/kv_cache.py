"""Block-table paged KV cache: the host-side page allocator over the
device pool built by models.model.init_paged_cache (the reference's
`serve/kv_cache.py`, single shard, fp or binary-coded pages).

Layout:
  - device pool, per attention layer: k/v pages (n_pages, page_size,
    Hkv, hd), or with kv_bits > 0 their binary-coded codes, alphas and
    betas (quant/kv.py); per MLA layer latent pages (n_pages,
    page_size, 1, kv_lora_rank | qk_rope_head_dim); per Mamba layer
    max_seqs state rows, which are not pages (serve/state_slab.py
    accounts for them). Page 0 is the *null page*, never allocated:
    inactive batch rows write there, so the decode step's scatter needs
    no branch.
  - block table: (max_seqs, max_pages_per_seq) int32, row = sequence
    slot, entry = page id (0 for unused entries, always a valid page).

Pages are refcounted so completed prefill pages can be shared between
sequences through the radix prefix index (serve/prefix_cache.py): a
page may appear in several block-table rows and be retained by the
index. A shared page is immutable: any writer forks it first
(`cow_for_write`), so a page is only ever written while its refcount is
exactly 1. COW forks return (src, dst) page pairs; the engine applies
them to the device pool with models.model.copy_pages before the write.
When the pool runs dry, `ensure` and `cow_for_write` first ask the
index to give back pages no sequence uses (`_reclaim`).

Invariants (tests/test_torch_serve.py, tests/test_torch_prefix_cache.py):
  - free_pages + live_pages == usable_pages (n_pages - 1), a live page
    counted once however many rows and index nodes reference it;
  - refcount[p] == (slots whose block table holds p) + (1 if the prefix
    index retains p);
  - no page is written while its refcount is > 1;
  - the null page is never allocated, shared or forked;
  - block-table entries beyond a sequence's page count are 0.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.attention import paged_kv_page_bytes
from repro_torch.models.model import init_paged_cache, is_page_leaf


class OutOfPages(Exception):
    """An allocation cannot be satisfied, even after reclaiming the
    prefix index's unused pages; the scheduler responds by preempting a
    sequence and retrying."""


class PagedKVCache:
    def __init__(self, cfg, *, n_pages, page_size, max_seqs,
                 max_pages_per_seq=None, dtype=None, create_pool=True,
                 kv_bits=0, kv_group_size=0, device=None):
        if n_pages < 2:
            raise ValueError("need at least the null page + one real page")
        self.cfg = cfg
        self.page_size = int(page_size)
        self.n_pages = int(n_pages)
        self.max_seqs = int(max_seqs)
        if max_pages_per_seq is None:
            self.max_pages_per_seq = self.n_pages - 1
        else:
            self.max_pages_per_seq = int(max_pages_per_seq)
            if self.max_pages_per_seq < 1:
                raise ValueError(
                    f"max_pages_per_seq={max_pages_per_seq!r}: must be >= 1")
        self.kv_bits = int(kv_bits)
        self.kv_group_size = int(kv_group_size)
        self._dtype = dtype
        self.pool = (init_paged_cache(cfg, n_pages, page_size, max_seqs,
                                      dtype, kv_bits=self.kv_bits,
                                      kv_group_size=self.kv_group_size,
                                      device=device)
                     if create_pool else None)
        self._pool_taken = False
        self.block_tables = np.zeros((max_seqs, self.max_pages_per_seq),
                                     np.int32)
        # per-row versions, bumped on every block-table mutation, so the
        # engine mirrors only changed rows to the device copy
        self.bt_version = np.zeros((max_seqs,), np.int64)
        self._free = list(range(self.n_pages - 1, 0, -1))
        self._owned: list[list[int]] = [[] for _ in range(max_seqs)]
        self._active = np.zeros((max_seqs,), bool)
        self._refcount = np.zeros((n_pages,), np.int32)
        self.prefix_index = None          # set by RadixPrefixCache
        self.high_water = 0
        self.cow_forks = 0
        self.pages_allocated = 0

    def bytes_per_page(self) -> int:
        """Device bytes one page id costs across all attention layers
        (K + V, codes + scales when binary-coded; one latent page a
        layer under MLA)."""
        return paged_kv_page_bytes(self.cfg, self.page_size, self._dtype,
                                   kv_bits=self.kv_bits,
                                   kv_group_size=self.kv_group_size)

    def pool_bytes(self) -> int:
        """Device bytes of the whole pool, the null page included."""
        return self.bytes_per_page() * self.n_pages

    def take_pool(self):
        """Hand the device pool to the engine (compact() then takes it
        as an argument)."""
        pool, self.pool = self.pool, None
        self._pool_taken = True
        return pool

    # ---------------- accounting ----------------
    @property
    def usable_pages(self) -> int:
        return self.n_pages - 1

    @property
    def free_page_count(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.usable_pages - self.free_page_count

    @property
    def live_pages(self) -> int:
        return int((self._refcount > 0).sum())

    def refcount(self, pid: int) -> int:
        return int(self._refcount[pid])

    def utilization(self) -> float:
        return self.used_pages / max(self.usable_pages, 1)

    def pages_for(self, n_tokens: int) -> int:
        return -(-max(n_tokens, 1) // self.page_size)

    def active_slots(self):
        return [i for i in range(self.max_seqs) if self._active[i]]

    # ---------------- slot lifecycle ----------------
    def alloc_slot(self) -> int | None:
        for i in range(self.max_seqs):
            if not self._active[i]:
                self._active[i] = True
                return i
        return None

    def _reclaim(self, shortfall: int) -> int:
        """Ask the prefix index to drop its least recently used pages
        that no sequence references; returns how many were freed."""
        if shortfall <= 0 or self.prefix_index is None:
            return 0
        return self.prefix_index.evict(shortfall)

    def ensure(self, slot: int, n_tokens: int) -> None:
        """Grow slot's page list to cover n_tokens; raises OutOfPages
        (allocating nothing) when the pool cannot, after reclaiming the
        prefix index's unused pages."""
        if not self._active[slot]:
            raise ValueError(f"slot {slot} is not active")
        need = self.pages_for(n_tokens) - len(self._owned[slot])
        if need <= 0:
            return
        if self.pages_for(n_tokens) > self.max_pages_per_seq:
            raise OutOfPages(f"slot {slot}: {n_tokens} tokens exceed "
                             f"max_pages_per_seq={self.max_pages_per_seq}")
        if need > len(self._free):
            self._reclaim(need - len(self._free))
        if need > len(self._free):
            raise OutOfPages(f"slot {slot}: need {need} pages, "
                             f"{len(self._free)} free")
        for _ in range(need):
            pid = self._free.pop()
            self.block_tables[slot, len(self._owned[slot])] = pid
            self._owned[slot].append(pid)
            self._refcount[pid] = 1
        self.bt_version[slot] += 1
        self.pages_allocated += need
        self.high_water = max(self.high_water, self.used_pages)

    def share(self, slot: int, page_ids) -> None:
        """Attach already-live pages (a matched prefix) to a fresh slot:
        they become its leading block-table entries and gain one
        reference each. Must precede any ensure() growth, so page index
        i keeps covering tokens [i*page_size, (i+1)*page_size)."""
        if not self._active[slot]:
            raise ValueError(f"slot {slot} is not active")
        if self._owned[slot]:
            raise ValueError(f"slot {slot}: share() must precede its "
                             f"own allocations")
        if len(page_ids) > self.max_pages_per_seq:
            raise ValueError(f"{len(page_ids)} pages exceed "
                             f"max_pages_per_seq={self.max_pages_per_seq}")
        for pid in page_ids:
            if pid == 0 or self._refcount[pid] <= 0:
                raise ValueError(f"page {pid} is not a live page")
        for idx, pid in enumerate(page_ids):
            self._owned[slot].append(int(pid))
            self.block_tables[slot, idx] = pid
            self._refcount[pid] += 1
        if len(page_ids):
            self.bt_version[slot] += 1

    def cow_for_write(self, slot: int, start_tok: int, end_tok: int):
        """Copy-on-write: fork every page of the slot in the token range
        [start_tok, end_tok) whose refcount is > 1 onto a fresh page (the
        shared original keeps its other references). Returns the
        [(src, dst), ...] copies to apply to the device pool before the
        write; raises OutOfPages (forking nothing) when the pool cannot
        supply the forks after reclaiming the prefix index's unused
        pages."""
        if end_tok <= start_tok:
            return []
        owned = self._owned[slot]
        p0, p1 = start_tok // self.page_size, (end_tok - 1) // self.page_size
        if p1 >= len(owned):
            raise ValueError(f"slot {slot}: tokens [{start_tok}, {end_tok}) "
                             f"beyond its {len(owned)} pages")
        shared = [i for i in range(p0, p1 + 1) if self._refcount[owned[i]] > 1]
        if not shared:
            return []
        if len(shared) > len(self._free):
            self._reclaim(len(shared) - len(self._free))
        if len(shared) > len(self._free):
            raise OutOfPages(f"slot {slot}: {len(shared)} COW forks, "
                             f"{len(self._free)} free")
        copies = []
        for i in shared:
            old, new = owned[i], self._free.pop()
            self._refcount[old] -= 1
            self._refcount[new] = 1
            owned[i] = new
            self.block_tables[slot, i] = new
            copies.append((old, new))
        self.bt_version[slot] += 1
        self.cow_forks += len(copies)
        self.pages_allocated += len(copies)
        self.high_water = max(self.high_water, self.used_pages)
        return copies

    def ref(self, pid: int) -> None:
        """Take a prefix-index reference on a live page."""
        if pid == 0 or self._refcount[pid] <= 0:
            raise ValueError(f"page {pid} is not a live page")
        self._refcount[pid] += 1

    def unref(self, pid: int) -> None:
        """Drop a reference; a page reaching refcount 0 is free again
        (its contents are reused by overwrite)."""
        if self._refcount[pid] <= 0:
            raise ValueError(f"page {pid} has no references")
        self._refcount[pid] -= 1
        if self._refcount[pid] == 0:
            self._free.append(pid)

    def release(self, slot: int) -> None:
        """Drop a sequence's references (completion or preemption);
        pages still referenced elsewhere (shared prefixes, the index)
        stay live."""
        for pid in self._owned[slot]:
            self.unref(pid)
        self._owned[slot] = []
        self.block_tables[slot, :] = 0
        self.bt_version[slot] += 1
        self._active[slot] = False

    def truncate(self, slot: int, n_tokens: int) -> int:
        """Drop the slot's trailing pages so it owns exactly
        pages_for(n_tokens); returns the number of pages freed."""
        keep = self.pages_for(n_tokens)
        owned = self._owned[slot]
        if keep > len(owned):
            raise ValueError(f"slot {slot}: cannot truncate {len(owned)} "
                             f"pages to {keep}")
        dropped = owned[keep:]
        self.block_tables[slot, keep:keep + len(dropped)] = 0
        del owned[keep:]
        for pid in dropped:
            self.unref(pid)
        if dropped:
            self.bt_version[slot] += 1
        return len(dropped)

    def owned_pages(self, slot: int):
        return list(self._owned[slot])

    # ---------------- defrag ----------------
    def compact(self, pool=None):
        """Remap live pages onto the lowest page ids (slots' pages in
        slot order, then the index's, then any other live page), rewrite
        the block tables and the prefix index, and move every page leaf
        of `pool` (codes and scales too on a binary-coded pool, latent
        pages; never a Mamba layer's state rows, which are indexed by
        slot) by one `index_select` over the page axis. Pass the pool when the engine
        took it (take_pool); returns the compacted pool."""
        if pool is None:
            if self._pool_taken:
                raise ValueError("the pool was taken; pass it to compact()")
            pool = self.pool
        mapping: dict[int, int] = {}

        def remap(pid: int) -> int:
            if pid not in mapping:
                mapping[pid] = len(mapping) + 1
            return mapping[pid]

        for slot in range(self.max_seqs):
            for j, pid in enumerate(self._owned[slot]):
                new = remap(pid)
                self._owned[slot][j] = new
                self.block_tables[slot, j] = new
            self.bt_version[slot] += 1
        if self.prefix_index is not None:
            self.prefix_index.remap(remap)
        for pid in np.flatnonzero(self._refcount[1:] > 0) + 1:
            remap(int(pid))

        src = np.arange(self.n_pages)
        new_rc = np.zeros_like(self._refcount)
        for old, new in mapping.items():
            src[new] = old
            new_rc[new] = self._refcount[old]
        self._refcount = new_rc
        if pool is not None:
            for layer in pool:
                for name, leaf in layer.items():
                    if is_page_leaf(leaf, self.n_pages):
                        layer[name] = leaf.index_select(
                            0, torch.as_tensor(src, device=leaf.device))
        self._free = list(range(self.n_pages - 1, len(mapping), -1))
        return pool
