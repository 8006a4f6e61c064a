"""Block-table paged KV cache: the host-side page allocator over the
device pool built by models.model.init_paged_cache (the reference's
`serve/kv_cache.py`, fp or binary-coded pages).

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

Sharding (`n_shards > 1`, one shard a data rank of a serving mesh): the
page ids split into `n_shards` equal contiguous blocks, as the pages of
the reference's pool split over its data axis, and the sequence slots
split the same way (slot s lives on shard s // (max_seqs / n_shards)).
Every page a sequence touches (growth, forks, shared prefixes) comes
from its own shard's block, so data rank d holds only block d, with
page `pid` at local id `pid - d * pages_per_shard`. The first page of
each block (`null_page_of_shard`) is that shard's reserve page, never
allocated: inactive rows of the shard write there (local id 0). Every
invariant below holds per shard; with `n_shards == 1` the layout is the
single global pool, reserve page == null page 0. `create_pool=False`
keeps the accounting alone (the engine on a mesh builds its shard's
pool itself; the allocator tests need none).

Invariants (tests/test_torch_serve.py, tests/test_torch_prefix_cache.py,
per shard in tests/test_torch_sharded_serve.py):
  - free_pages + live_pages == usable_pages (n_pages minus one reserve
    page a shard), a live page counted once however many rows and index
    nodes reference it; the same identity within each shard;
  - refcount[p] == (slots whose block table holds p) + (1 if the prefix
    index retains p);
  - no page is written while its refcount is > 1;
  - reserve pages (the null page 0 and each shard's first page) are
    never allocated, shared or forked;
  - every page slot s owns lies in shard_of_slot(s)'s block;
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
                 n_shards=1, kv_bits=0, kv_group_size=0, device=None):
        if n_pages < 2:
            raise ValueError("need at least the null page + one real page")
        if n_shards < 1 or n_pages % n_shards or max_seqs % n_shards:
            raise ValueError(f"n_pages={n_pages} and max_seqs={max_seqs} "
                             f"must split evenly over {n_shards} shards")
        if n_pages // n_shards < 2:
            raise ValueError("each shard needs its reserve page + one "
                             "usable page")
        self.cfg = cfg
        self.page_size = int(page_size)
        self.n_pages = int(n_pages)
        self.max_seqs = int(max_seqs)
        self.n_shards = int(n_shards)
        self.pages_per_shard = self.n_pages // self.n_shards
        self.seqs_per_shard = self.max_seqs // self.n_shards
        if max_pages_per_seq is None:
            self.max_pages_per_seq = self.pages_per_shard - 1
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
        # per-shard free lists; each shard's first page is its reserve
        self._free_by_shard: list[list[int]] = [
            list(range((s + 1) * self.pages_per_shard - 1,
                       s * self.pages_per_shard, -1))
            for s in range(self.n_shards)]
        self._owned: list[list[int]] = [[] for _ in range(max_seqs)]
        self._active = np.zeros((max_seqs,), bool)
        self._refcount = np.zeros((n_pages,), np.int32)
        self.prefix_index = None          # set by RadixPrefixCache
        self.high_water = 0
        self.cow_forks = 0
        self.pages_allocated = 0

    # ---------------- shard geometry ----------------
    def shard_of_page(self, pid: int) -> int:
        return pid // self.pages_per_shard

    def shard_of_slot(self, slot: int) -> int:
        return slot // self.seqs_per_shard

    def null_page_of_shard(self, shard: int) -> int:
        """The shard's reserve page (page 0 for shard 0 and for a single
        shard)."""
        return shard * self.pages_per_shard

    def is_reserve_page(self, pid: int) -> bool:
        """Every shard's reserve page: page 0 and each block's first
        page (`pid != 0` alone misses those of shards > 0)."""
        return pid % self.pages_per_shard == 0

    def local_page(self, pid):
        """A page's id (or an array of ids) in its shard's block: what a
        data rank's pool is indexed by."""
        return pid % self.pages_per_shard

    def bytes_per_page(self) -> int:
        """Device bytes one page id costs across all attention layers
        (K + V, codes + scales when binary-coded; one latent page a
        layer under MLA)."""
        return paged_kv_page_bytes(self.cfg, self.page_size, self._dtype,
                                   kv_bits=self.kv_bits,
                                   kv_group_size=self.kv_group_size)

    def pool_bytes(self) -> int:
        """Device bytes of the whole pool, reserve pages included (each
        data rank of a mesh holds pages_per_shard of them, of its own
        config's heads)."""
        return self.bytes_per_page() * self.n_pages

    def take_pool(self):
        """Hand the device pool to the engine (compact() then takes it
        as an argument)."""
        pool, self.pool = self.pool, None
        self._pool_taken = True
        return pool

    # ---------------- accounting ----------------
    @property
    def _free(self) -> list[int]:
        """Every free page (shard 0's first), read-only: allocation pops
        from the per-shard lists."""
        if self.n_shards == 1:
            return self._free_by_shard[0]
        return [p for fl in self._free_by_shard for p in fl]

    @property
    def usable_pages(self) -> int:
        return self.n_pages - self.n_shards

    def usable_in_shard(self, shard: int = 0) -> int:
        if not 0 <= shard < self.n_shards:
            raise ValueError(f"shard {shard} of {self.n_shards}")
        return self.pages_per_shard - 1

    @property
    def free_page_count(self) -> int:
        return sum(len(fl) for fl in self._free_by_shard)

    def free_in_shard(self, shard: int) -> int:
        return len(self._free_by_shard[shard])

    @property
    def used_pages(self) -> int:
        return self.usable_pages - self.free_page_count

    @property
    def live_pages(self) -> int:
        return int((self._refcount > 0).sum())

    def live_in_shard(self, shard: int) -> int:
        lo = shard * self.pages_per_shard
        return int((self._refcount[lo:lo + self.pages_per_shard] > 0).sum())

    def refcount(self, pid: int) -> int:
        return int(self._refcount[pid])

    def utilization(self) -> float:
        return self.used_pages / max(self.usable_pages, 1)

    def pages_for(self, n_tokens: int) -> int:
        return -(-max(n_tokens, 1) // self.page_size)

    def active_slots(self):
        return [i for i in range(self.max_seqs) if self._active[i]]

    # ---------------- slot lifecycle ----------------
    def pick_shard(self) -> int | None:
        """Admission's shard: the one with the most free pages among
        shards with a free sequence slot (ties to the lowest id; None
        when every slot is taken)."""
        best, best_free = None, -1
        for s in range(self.n_shards):
            lo = s * self.seqs_per_shard
            if self._active[lo:lo + self.seqs_per_shard].all():
                continue
            if len(self._free_by_shard[s]) > best_free:
                best, best_free = s, len(self._free_by_shard[s])
        return best

    def alloc_slot(self, shard: int | None = None) -> int | None:
        """Claim the first free slot (within `shard`'s block of slots
        when given)."""
        lo, hi = 0, self.max_seqs
        if shard is not None:
            lo = shard * self.seqs_per_shard
            hi = lo + self.seqs_per_shard
        for i in range(lo, hi):
            if not self._active[i]:
                self._active[i] = True
                return i
        return None

    def _reclaim(self, shortfall: int, shard: int) -> int:
        """Ask the prefix index to drop its least recently used pages of
        `shard` that no sequence references; returns how many were
        freed."""
        if shortfall <= 0 or self.prefix_index is None:
            return 0
        return self.prefix_index.evict(shortfall, shard=shard)

    def ensure(self, slot: int, n_tokens: int) -> None:
        """Grow slot's page list to cover n_tokens from the slot's
        shard; raises OutOfPages (allocating nothing) when that shard
        cannot, after reclaiming the prefix index's unused pages of the
        same shard."""
        if not self._active[slot]:
            raise ValueError(f"slot {slot} is not active")
        need = self.pages_for(n_tokens) - len(self._owned[slot])
        if need <= 0:
            return
        if self.pages_for(n_tokens) > self.max_pages_per_seq:
            raise OutOfPages(f"slot {slot}: {n_tokens} tokens exceed "
                             f"max_pages_per_seq={self.max_pages_per_seq}")
        shard = self.shard_of_slot(slot)
        free = self._free_by_shard[shard]
        if need > len(free):
            self._reclaim(need - len(free), shard)
        if need > len(free):
            raise OutOfPages(f"slot {slot}: need {need} pages, "
                             f"{len(free)} free in shard {shard}")
        for _ in range(need):
            pid = free.pop()
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
        i keeps covering tokens [i*page_size, (i+1)*page_size). The
        pages must lie in the slot's shard."""
        if not self._active[slot]:
            raise ValueError(f"slot {slot} is not active")
        if self._owned[slot]:
            raise ValueError(f"slot {slot}: share() must precede its "
                             f"own allocations")
        if len(page_ids) > self.max_pages_per_seq:
            raise ValueError(f"{len(page_ids)} pages exceed "
                             f"max_pages_per_seq={self.max_pages_per_seq}")
        shard = self.shard_of_slot(slot)
        for pid in page_ids:
            if self.is_reserve_page(int(pid)) or self._refcount[pid] <= 0:
                raise ValueError(f"page {pid} is not a live page")
            if self.shard_of_page(int(pid)) != shard:
                raise ValueError(f"slot {slot}, page {pid}: cross-shard "
                                 f"prefix attach")
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
        shard = self.shard_of_slot(slot)
        free = self._free_by_shard[shard]
        if len(shared) > len(free):
            self._reclaim(len(shared) - len(free), shard)
        if len(shared) > len(free):
            raise OutOfPages(f"slot {slot}: {len(shared)} COW forks, "
                             f"{len(free)} free in shard {shard}")
        copies = []
        for i in shared:
            old, new = owned[i], free.pop()
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
        if self.is_reserve_page(int(pid)) or self._refcount[pid] <= 0:
            raise ValueError(f"page {pid} is not a live page")
        self._refcount[pid] += 1

    def unref(self, pid: int) -> None:
        """Drop a reference; a page reaching refcount 0 returns to its
        shard's free list (its contents are reused by overwrite)."""
        if self._refcount[pid] <= 0:
            raise ValueError(f"page {pid} has no references")
        self._refcount[pid] -= 1
        if self._refcount[pid] == 0:
            self._free_by_shard[self.shard_of_page(pid)].append(pid)

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
    def compact(self, pool=None, shard=None):
        """Remap live pages onto the lowest page ids of their shard
        (slots' pages in slot order, then the index's, then any other
        live page), rewrite the block tables and the prefix index, and
        move every page leaf of `pool` (codes and scales too on a
        binary-coded pool, latent pages; never a Mamba layer's state
        rows, which are indexed by slot) by one `index_select` over the
        page axis. Pages never cross shards, so the permutation is block
        diagonal: with `shard`, `pool` is that shard's block (a data
        rank's pool, local ids) and moves by its block of the
        permutation. Pass the pool when the engine took it (take_pool);
        returns the compacted pool."""
        if pool is None:
            if self._pool_taken:
                raise ValueError("the pool was taken; pass it to compact()")
            pool = self.pool
        pps = self.pages_per_shard
        mapping: dict[int, int] = {}
        nxt = [s * pps + 1 for s in range(self.n_shards)]

        def remap(pid: int) -> int:
            if pid not in mapping:
                sh = self.shard_of_page(pid)
                mapping[pid] = nxt[sh]
                nxt[sh] += 1
            return mapping[pid]

        for slot in range(self.max_seqs):
            for j, pid in enumerate(self._owned[slot]):
                new = remap(pid)
                self._owned[slot][j] = new
                self.block_tables[slot, j] = new
            self.bt_version[slot] += 1
        if self.prefix_index is not None:
            self.prefix_index.remap(remap)
        for pid in np.flatnonzero(self._refcount > 0):
            remap(int(pid))

        src = np.arange(self.n_pages)
        new_rc = np.zeros_like(self._refcount)
        for old, new in mapping.items():
            src[new] = old
            new_rc[new] = self._refcount[old]
        self._refcount = new_rc
        n_rows, lo = self.n_pages, 0
        if shard is not None:
            n_rows, lo = pps, shard * pps
        if pool is not None:
            idx = src[lo:lo + n_rows] - lo
            for layer in pool:
                for name, leaf in layer.items():
                    if is_page_leaf(leaf, n_rows):
                        layer[name] = leaf.index_select(
                            0, torch.as_tensor(idx, device=leaf.device))
        self._free_by_shard = [list(range((s + 1) * pps - 1, nxt[s] - 1, -1))
                               for s in range(self.n_shards)]
        return pool
