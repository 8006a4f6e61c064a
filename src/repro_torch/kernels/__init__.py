"""The port's kernels: hand-written CUDA for the reference's Pallas
kernels on the serving path (csrc/), their wrappers (bcq_matmul.py,
paged_attention.py), the plain PyTorch oracles (ref.py) and the BCQ
dispatch (ops.py)."""
from repro_torch.kernels import bcq_matmul, ops, paged_attention, ref


def launch_counts() -> dict:
    """Kernel launches per wrapper since the last reset, plus the BCQ
    calls that took the plain path (`bcq_plain`)."""
    return {**bcq_matmul.LAUNCHES, **paged_attention.LAUNCHES,
            **ops.PLAIN_CALLS}


def reset_launch_counts() -> None:
    for counts in (bcq_matmul.LAUNCHES, paged_attention.LAUNCHES,
                   ops.PLAIN_CALLS):
        for k in counts:
            counts[k] = 0


__all__ = ["bcq_matmul", "ops", "paged_attention", "ref", "launch_counts",
           "reset_launch_counts"]
