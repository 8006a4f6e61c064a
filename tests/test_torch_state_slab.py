"""The port's StateSlabPool (repro_torch/serve/state_slab.py) against the
reference's, op by op on one shard: seeded random sequences of alloc,
release and compact, with every return value, exhaustion (OutOfPages),
counter and per-slot slab equal after each op and conservation
(live_slabs + free_slab_count == usable_slabs) checked throughout; plus
bytes_per_slab and the scheduler's slab hooks."""
import numpy as np
import pytest

from repro.configs import smoke_config as jax_smoke_config
from repro.serve.kv_cache import OutOfPages as JaxOutOfPages
from repro.serve.state_slab import StateSlabPool as JaxPool
from repro_torch.configs import smoke_config
from repro_torch.serve import OutOfPages
from repro_torch.serve.state_slab import StateSlabPool
from torch_threads import one_torch_thread  # noqa: F401

ARCHS = ["falcon-mamba-7b", "jamba-1.5-large-398b"]


def state(pool):
    return (pool.usable_slabs, pool.free_slab_count, pool.used_slabs,
            pool.live_slabs, pool.high_water, pool.slabs_allocated,
            [pool.slab_of(s) for s in range(pool.max_seqs)],
            [pool.refcount(i) for i in range(pool.n_slabs)])


@pytest.mark.parametrize("seed", range(4))
def test_ops_match_the_reference(seed):
    rng = np.random.default_rng(seed)
    n_slabs, max_seqs = int(rng.integers(2, 7)), int(rng.integers(1, 7))
    cfg, jcfg = smoke_config(ARCHS[0]), jax_smoke_config(ARCHS[0])
    mine = StateSlabPool(cfg, n_slabs=n_slabs, max_seqs=max_seqs)
    ref = JaxPool(jcfg, n_slabs=n_slabs, max_seqs=max_seqs)
    held = set()
    for _ in range(60):
        op = rng.choice(["alloc", "release", "compact"], p=[.5, .4, .1])
        if op == "alloc":
            free = [s for s in range(max_seqs) if s not in held]
            if not free:
                continue
            slot = int(rng.choice(free))
            try:
                want = ref.alloc(slot)
            except JaxOutOfPages:
                with pytest.raises(OutOfPages):
                    mine.alloc(slot)
            else:
                assert mine.alloc(slot) == want
                held.add(slot)
        elif op == "release":
            slot = int(rng.integers(0, max_seqs))   # idle slots: no-ops
            ref.release(slot)
            mine.release(slot)
            held.discard(slot)
        else:
            assert mine.compact() == ref.compact()
        assert state(mine) == state(ref)
        assert mine.live_slabs + mine.free_slab_count == mine.usable_slabs
        assert mine.refcount(0) == 0          # the reserve slab


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bytes_per_slab_matches_the_reference(arch, dtype):
    cfg, jcfg = smoke_config(arch), jax_smoke_config(arch)
    mine = StateSlabPool(cfg, n_slabs=3, max_seqs=2, dtype=dtype)
    ref = JaxPool(jcfg, n_slabs=3, max_seqs=2, dtype=dtype)
    assert mine.bytes_per_slab() == ref.bytes_per_slab() > 0


def test_refusals():
    cfg = smoke_config(ARCHS[0])
    # shards split the slabs and the slots evenly, a reserve slab each
    with pytest.raises(ValueError, match="split evenly"):
        StateSlabPool(cfg, n_slabs=5, max_seqs=2, n_shards=2)
    with pytest.raises(ValueError, match="reserve"):
        StateSlabPool(cfg, n_slabs=2, max_seqs=2, n_shards=2)
    with pytest.raises(ValueError, match="reserve"):
        StateSlabPool(cfg, n_slabs=1, max_seqs=2)
    pool = StateSlabPool(cfg, n_slabs=2, max_seqs=2)
    pool.alloc(0)
    with pytest.raises(ValueError, match="already holds"):
        pool.alloc(0)
    with pytest.raises(OutOfPages):
        pool.alloc(1)
    assert pool.used_slabs == 1 and pool.slab_of(1) is None


def test_scheduler_declines_admission_without_a_slab():
    """Two slots but one usable slab: the second request waits until the
    first finishes, and every slab returns."""
    from repro_torch.serve import DenseSlotPool, Scheduler

    class Req:
        def __init__(self):
            self.prompt, self.out, self.done = np.arange(3), [], False

    cfg = smoke_config(ARCHS[0])
    slab = StateSlabPool(cfg, n_slabs=2, max_seqs=2)
    sched = Scheduler(DenseSlotPool(2), watermark=0, slab=slab)
    sched.submit(Req())
    sched.submit(Req())
    first = sched.try_admit()
    assert first is not None and sched.try_admit() is None
    assert len(sched.waiting) == 1 and slab.free_slab_count == 0
    sched.finish(first.slot)
    second = sched.try_admit()
    assert second is not None and slab.slab_of(second.slot) is not None
    sched.preempt_one()
    assert slab.live_slabs == 0 and sched.preemptions == 1
    summary = sched.metrics_summary([])
    assert summary["slabs_allocated"] == 2 and summary["slab_high_water"] == 1
    assert summary["slab_usable_slabs"] == 1
