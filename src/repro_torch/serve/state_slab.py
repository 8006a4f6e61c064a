"""Pooled fixed-size state slabs for recurrent (Mamba) layers (the
reference's `serve/state_slab.py`).

Recurrent state is O(1) a sequence: one (d_inner, d_state) fp32 SSM
carry plus a (d_conv - 1, d_inner) conv window a Mamba layer, so it
does not page like attention K/V. It still needs admission control:
"can this sequence get state storage" is the same capacity question as
"can it get pages", and an engine that admitted on pages alone would
oversubscribe the state rows. StateSlabPool answers it with one slab an
admitted sequence, under the page allocator's invariants:

  - per-shard slab blocks, as the page pool's (serve/kv_cache.py): slot
    s draws from shard s // seqs_per_shard's block, a data rank of a
    serving mesh holding its block's rows;
  - each shard's first slab is its *reserve* slab, never allocated (as
    page 0 is the null page);
  - conservation: live_slabs + free_slab_count == usable_slabs
    (n_slabs - n_shards); a slab's refcount is only ever 0 or 1 (state is
    written every step, so nothing is shared and nothing forks);
  - a failed allocation raises the page pool's OutOfPages and allocates
    nothing: the scheduler treats slab exhaustion as page exhaustion
    (decline the admission, or preempt);
  - compact() remaps live slabs onto the lowest ids of their shard.

The state rows themselves live in the paged cache (init_paged_cache
gives Mamba layers max_seqs rows indexed by slot); the pool is the
host-side capacity and lifecycle layer that decides whether a slot may
hold state at all. On a model axis of M ranks the engine builds it from
the rank's config (models/model.py:shard_config), whose d_inner is
d_inner / M: the ssm and conv rows hold the rank's channels (the
reference's cache rule puts d_inner on the model axis) and
bytes_per_slab() / pool_bytes() are a rank's share.
"""
from __future__ import annotations

import numpy as np

from repro_torch.hw import torch_dtype
from repro_torch.serve.kv_cache import OutOfPages


class StateSlabPool:
    def __init__(self, cfg, *, n_slabs, max_seqs, n_shards=1, dtype=None):
        if n_slabs < 2:
            raise ValueError("need at least the reserve slab + one usable")
        if n_shards < 1 or n_slabs % n_shards or max_seqs % n_shards:
            raise ValueError(f"n_slabs={n_slabs} and max_seqs={max_seqs} "
                             f"must split evenly over {n_shards} shards")
        if n_slabs // n_shards < 2:
            raise ValueError("each shard needs its reserve slab + one "
                             "usable slab")
        self.cfg = cfg
        self.n_slabs = int(n_slabs)
        self.max_seqs = int(max_seqs)
        self.n_shards = int(n_shards)
        self.slabs_per_shard = self.n_slabs // self.n_shards
        self.seqs_per_shard = self.max_seqs // self.n_shards
        self._dtype = dtype
        # per-shard free lists; each shard's first slab is its reserve
        self._free_by_shard: list[list[int]] = [
            list(range((s + 1) * self.slabs_per_shard - 1,
                       s * self.slabs_per_shard, -1))
            for s in range(self.n_shards)]
        self._refcount = np.zeros((self.n_slabs,), np.int32)
        self._slab_of_slot = np.full((self.max_seqs,), -1, np.int32)
        self.high_water = 0
        self.slabs_allocated = 0

    # ---------------- shard geometry ----------------
    def shard_of_slab(self, sid: int) -> int:
        return sid // self.slabs_per_shard

    def shard_of_slot(self, slot: int) -> int:
        return slot // self.seqs_per_shard

    def is_reserve_slab(self, sid: int) -> bool:
        return sid % self.slabs_per_shard == 0

    # ---------------- accounting ----------------
    @property
    def usable_slabs(self) -> int:
        return self.n_slabs - self.n_shards

    def usable_in_shard(self, shard: int = 0) -> int:
        if not 0 <= shard < self.n_shards:
            raise ValueError(f"shard {shard} of {self.n_shards}")
        return self.slabs_per_shard - 1

    @property
    def free_slab_count(self) -> int:
        return sum(len(fl) for fl in self._free_by_shard)

    def free_in_shard(self, shard: int) -> int:
        return len(self._free_by_shard[shard])

    @property
    def used_slabs(self) -> int:
        return self.usable_slabs - self.free_slab_count

    @property
    def live_slabs(self) -> int:
        """Slabs with refcount > 0."""
        return int((self._refcount > 0).sum())

    def live_in_shard(self, shard: int) -> int:
        lo = shard * self.slabs_per_shard
        return int((self._refcount[lo:lo + self.slabs_per_shard] > 0).sum())

    def refcount(self, sid: int) -> int:
        return int(self._refcount[sid])

    def slab_of(self, slot: int) -> int | None:
        sid = int(self._slab_of_slot[slot])
        return None if sid < 0 else sid

    def bytes_per_slab(self) -> int:
        """Device bytes one slab holds across all Mamba layers: the fp32
        SSM carry plus the conv window a layer."""
        mc = self.cfg.mamba
        if mc is None:
            return 0
        di = self.cfg.d_inner
        itemsize = torch_dtype(self._dtype or self.cfg.dtype).itemsize
        ssm = di * mc.d_state * 4
        conv = (mc.d_conv - 1) * di * itemsize
        n_mamba = sum(1 for s in self.cfg.layer_specs() if s.kind != "attn")
        return (ssm + conv) * n_mamba

    def pool_bytes(self) -> int:
        return self.bytes_per_slab() * self.n_slabs

    # ---------------- lifecycle ----------------
    def alloc(self, slot: int) -> int:
        """Claim a slab for `slot` from its shard's block; raises
        OutOfPages (allocating nothing) when that shard has none free. A
        slot holds at most one slab."""
        if self._slab_of_slot[slot] >= 0:
            raise ValueError(f"slot {slot} already holds a slab")
        shard = self.shard_of_slot(slot)
        free = self._free_by_shard[shard]
        if not free:
            raise OutOfPages(f"slot {slot}: no free state slab in shard "
                             f"{shard}")
        sid = free.pop()
        self._refcount[sid] = 1
        self._slab_of_slot[slot] = sid
        self.slabs_allocated += 1
        self.high_water = max(self.high_water, self.used_slabs)
        return sid

    def release(self, slot: int) -> None:
        """Return `slot`'s slab (completion or preemption); a no-op for
        a slot that holds none."""
        sid = int(self._slab_of_slot[slot])
        if sid < 0:
            return
        self._refcount[sid] = 0
        self._free_by_shard[self.shard_of_slab(sid)].append(sid)
        self._slab_of_slot[slot] = -1

    # ---------------- defrag ----------------
    def compact(self) -> dict[int, int]:
        """Remap live slabs onto the lowest ids of their shard in slot
        order and return the {old: new} mapping (host only: state rows
        are indexed by slot, not slab id, so nothing moves on the
        device)."""
        mapping: dict[int, int] = {}
        nxt = [s * self.slabs_per_shard + 1 for s in range(self.n_shards)]
        for slot in range(self.max_seqs):
            sid = int(self._slab_of_slot[slot])
            if sid < 0:
                continue
            sh = self.shard_of_slab(sid)
            mapping[sid] = nxt[sh]
            self._slab_of_slot[slot] = nxt[sh]
            nxt[sh] += 1
        new_rc = np.zeros_like(self._refcount)
        for old, new in mapping.items():
            new_rc[new] = self._refcount[old]
        self._refcount = new_rc
        self._free_by_shard = [
            list(range((s + 1) * self.slabs_per_shard - 1, nxt[s] - 1, -1))
            for s in range(self.n_shards)]
        return mapping
