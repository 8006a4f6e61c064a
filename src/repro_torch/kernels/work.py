"""Work reports of the kernel wrappers on meta tensors, and the shapes
of the launches they make on the card.

On the meta device a wrapper launches nothing: it returns an empty
output of the kernel's shape and dtype (the counterpart of
`jax.eval_shape` through a `pallas_call`) and reports the kernel's own
bytes and operations (roofline/analysis.py) to every open recorder.
What its plain version would do (expand fp32 weights, about ten times
the bytes of w3 codes) is never reported. The dry run's op counter
(roofline/op_profile.py) opens one.

    with recording() as rec:
        ...                              # meta tensors through the model
    rec.calls, rec.flops, rec.bytes, rec.by_kernel

A launch on the card notes its shape (`note_launch`, beside the launch
count) to every open `launch_shapes()` log, so a run can show at which
shapes each kernel ran (a mesh rank's per-shard shapes):

    with launch_shapes() as shapes:
        ...                              # CUDA tensors through the model
    shapes["bcq_gemv"] -> {(M, K, N), ...}
"""
from __future__ import annotations

_RECORDERS: list = []
_SHAPE_LOGS: list = []


class Recorder:
    """Kernel work reported while it is open: totals and per kernel
    {"calls", "flops", "bytes"}."""

    def __init__(self):
        self.calls = 0
        self.flops = 0
        self.bytes = 0
        self.by_kernel: dict = {}

    def add(self, name: str, flops: int, n_bytes: int) -> None:
        self.calls += 1
        self.flops += flops
        self.bytes += n_bytes
        ent = self.by_kernel.setdefault(name, {"calls": 0, "flops": 0,
                                               "bytes": 0})
        ent["calls"] += 1
        ent["flops"] += flops
        ent["bytes"] += n_bytes


class recording:
    """with recording() as rec: the kernel work reported inside."""

    def __init__(self, recorder: Recorder = None):
        self.rec = recorder if recorder is not None else Recorder()

    def __enter__(self) -> Recorder:
        _RECORDERS.append(self.rec)
        return self.rec

    def __exit__(self, *exc):
        _RECORDERS.remove(self.rec)
        return False


def report(name: str, work: dict) -> None:
    """A meta-tensor call of kernel `name` with `work` {"flops",
    "bytes"}: added to every open recorder."""
    for rec in _RECORDERS:
        rec.add(name, work["flops"], work["bytes"])


class launch_shapes:
    """with launch_shapes() as shapes: {kernel name: {shape, ...}} of the
    launches made inside."""

    def __enter__(self) -> dict:
        self.shapes: dict = {}
        _SHAPE_LOGS.append(self.shapes)
        return self.shapes

    def __exit__(self, *exc):
        _SHAPE_LOGS.remove(self.shapes)
        return False


def note_launch(name: str, shape) -> None:
    """A launch of kernel `name` at `shape`: added to every open log."""
    for log in _SHAPE_LOGS:
        log.setdefault(name, set()).add(tuple(int(d) for d in shape))
