"""Pooled fixed-size state slabs for recurrent (Mamba) layers (the
reference's `serve/state_slab.py`, single shard).

Recurrent state is O(1) a sequence: one (d_inner, d_state) fp32 SSM
carry plus a (d_conv - 1, d_inner) conv window a Mamba layer, so it
does not page like attention K/V. It still needs admission control:
"can this sequence get state storage" is the same capacity question as
"can it get pages", and an engine that admitted on pages alone would
oversubscribe the state rows. StateSlabPool answers it with one slab an
admitted sequence, under the page allocator's invariants:

  - slab 0 is the *reserve* slab, never allocated (as page 0 is the
    null page);
  - conservation: live_slabs + free_slab_count == usable_slabs
    (n_slabs - 1); a slab's refcount is only ever 0 or 1 (state is
    written every step, so nothing is shared and nothing forks);
  - a failed allocation raises the page pool's OutOfPages and allocates
    nothing: the scheduler treats slab exhaustion as page exhaustion
    (decline the admission, or preempt);
  - compact() remaps live slabs onto the lowest ids.

The state rows themselves live in the paged cache (init_paged_cache
gives Mamba layers max_seqs rows indexed by slot); the pool is the
host-side capacity and lifecycle layer that decides whether a slot may
hold state at all. Sharded pools (a block of slabs per data shard) come
with multi-GPU serving (ROADMAP Queue 1 item 6).
"""
from __future__ import annotations

import numpy as np

from repro_torch.hw import torch_dtype
from repro_torch.serve.kv_cache import OutOfPages


class StateSlabPool:
    def __init__(self, cfg, *, n_slabs, max_seqs, n_shards=1, dtype=None):
        if n_shards != 1:
            raise NotImplementedError(
                "sharded state slab pools come with multi-GPU serving "
                "(ROADMAP Queue 1 item 6)")
        if n_slabs < 2:
            raise ValueError("need at least the reserve slab + one usable")
        self.cfg = cfg
        self.n_slabs = int(n_slabs)
        self.max_seqs = int(max_seqs)
        self.n_shards = 1
        self._dtype = dtype
        self._free = list(range(self.n_slabs - 1, 0, -1))
        self._refcount = np.zeros((self.n_slabs,), np.int32)
        self._slab_of_slot = np.full((self.max_seqs,), -1, np.int32)
        self.high_water = 0
        self.slabs_allocated = 0

    # ---------------- accounting ----------------
    @property
    def usable_slabs(self) -> int:
        return self.n_slabs - 1

    @property
    def free_slab_count(self) -> int:
        return len(self._free)

    @property
    def used_slabs(self) -> int:
        return self.usable_slabs - self.free_slab_count

    @property
    def live_slabs(self) -> int:
        """Slabs with refcount > 0."""
        return int((self._refcount > 0).sum())

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
        """Claim a slab for `slot`; raises OutOfPages (allocating
        nothing) when none is free. A slot holds at most one slab."""
        if self._slab_of_slot[slot] >= 0:
            raise ValueError(f"slot {slot} already holds a slab")
        if not self._free:
            raise OutOfPages(f"slot {slot}: no free state slab")
        sid = self._free.pop()
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
        self._free.append(sid)
        self._slab_of_slot[slot] = -1

    # ---------------- defrag ----------------
    def compact(self) -> dict[int, int]:
        """Remap live slabs onto the lowest ids in slot order and return
        the {old: new} mapping (host only: state rows are indexed by
        slot, not slab id, so nothing moves on the device)."""
        mapping: dict[int, int] = {}
        nxt = 1
        for slot in range(self.max_seqs):
            sid = int(self._slab_of_slot[slot])
            if sid < 0:
                continue
            mapping[sid] = nxt
            self._slab_of_slot[slot] = nxt
            nxt += 1
        new_rc = np.zeros_like(self._refcount)
        for old, new in mapping.items():
            new_rc[new] = self._refcount[old]
        self._refcount = new_rc
        self._free = list(range(self.n_slabs - 1, nxt - 1, -1))
        return mapping
