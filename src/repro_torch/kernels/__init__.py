"""The port's kernels: hand-written CUDA for the reference's Pallas
kernels on the serving path (csrc/), their wrappers (bcq_matmul.py,
paged_attention.py), the plain PyTorch oracles (ref.py) and the BCQ
dispatch (ops.py)."""
from repro_torch.kernels import bcq_matmul, ops, paged_attention, ref


_COUNTERS = (bcq_matmul.LAUNCHES, paged_attention.LAUNCHES, ops.PLAIN_CALLS)


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset, plus the BCQ
    calls that took the plain path (`bcq_plain`)."""
    return {k: v for counts in _COUNTERS for k, v in counts.items()}


def reset_launch_counts() -> None:
    set_launch_counts({})


def set_launch_counts(values: dict) -> None:
    """Every count to its value in `values` (0 where it has none)."""
    for counts in _COUNTERS:
        for k in counts:
            counts[k] = values.get(k, 0)


def add_launch_counts(delta: dict) -> None:
    """Add `delta` to the counts: the launches of a replayed CUDA graph
    (serve/compile_cache.py), whose kernels run without their wrappers
    being called."""
    for counts in _COUNTERS:
        for k in counts:
            counts[k] += delta.get(k, 0)


__all__ = ["bcq_matmul", "ops", "paged_attention", "ref", "launch_counts",
           "reset_launch_counts", "set_launch_counts", "add_launch_counts"]
