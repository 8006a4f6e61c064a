"""Static profile of a traced step (the counterpart of the reference's
`roofline/hlo_profile.py`, which reads compiled HLO text; the port has
no HLO, so it watches the aten ops of a step run on meta tensors), and
the grouping of a torch.profiler trace's CUDA kernels by name.

`OpCounter` is a TorchDispatchMode that sees every aten op of the step,
forward and backward. It counts:
  - bytes: each op's distinct tensor operands and its results that are
    not views of an operand (an in-place result is its operand), each
    tensor once; an indexed write into a tensor in place (index_put_,
    index_copy_, scatter_, ...) moves its other operands twice (read,
    then written into the rows they name), and an indexed read (index,
    embedding, gather, index_select) its result twice (the rows read,
    then written) and its indices, not the whole source tensor; views,
    metadata ops and allocations without a write (empty, empty_like,
    empty_strided) move none;
  - output bytes and op counts by kind, and the largest single ops;
  - live bytes: every tensor storage the step creates is live from its
    first op until its storage is freed (a weakref finalizer on the
    storage), beside the storages alive when the counter opened (the
    step's arguments); the peak over the step is `peak_live_bytes`;
  - the kernels' own work (kernels/work.py): a kernel wrapper on meta
    tensors reports its bytes and operations and returns an empty
    output, so the kernel's traffic is counted once, as the kernel
    moves it, never as its plain version would.
FLOPs are counted beside it by torch.utils.flop_counter.FlopCounterMode
(`count_step` opens both).
"""
from __future__ import annotations

import weakref
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import work

aten = torch.ops.aten
TOP_OPS = 25        # the largest single ops a profile keeps
TOP_KERNELS = 8     # the kernel names a trace's summary lists
# allocations that write nothing
_NO_WRITE = {aten.empty.memory_format, aten.empty_like.default,
             aten.empty_strided.default, aten.new_empty.default,
             aten.new_empty_strided.default}


# writes into the rows that index operands name, in place
_INDEXED_WRITES = {"index_put_", "_index_put_impl_", "index_copy_",
                   "scatter_", "scatter_add_", "scatter_reduce_",
                   "index_add_", "put_"}


# reads of the rows that index operands name
_INDEXED_READS = {"index", "_unsafe_index", "embedding", "gather",
                  "index_select", "take"}


def _is_view(func) -> bool:
    """A view op: a result aliases an operand without writing it (its
    schema says so, or it is _unsafe_view, which aliases unannounced)."""
    return func is aten._unsafe_view.default or any(
        r.alias_info is not None and not r.alias_info.is_write
        for r in func._schema.returns)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class OpCounter(TorchDispatchMode):
    """with OpCounter() as oc: a step on meta tensors; then oc.bytes,
    oc.peak_live_bytes, oc.by_kind, oc.top_ops, oc.kernels."""

    def __init__(self):
        super().__init__()
        self.bytes = 0          # Python ints: exact past 2**53
        self.n_ops = 0
        self.by_kind = defaultdict(lambda: {"bytes": 0, "count": 0})
        self.top_ops: list = []
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self._live: dict = {}
        self.kernels = work.Recorder()
        self._recording = work.recording(self.kernels)

    def track(self, tensors) -> None:
        """Count the storages of `tensors` as live (the step's
        arguments, before the step runs)."""
        for t in tensors:
            self._add_storage(t)

    def _add_storage(self, t) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def __enter__(self):
        self._recording.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._recording.__exit__(*exc)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.n_ops += 1
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        for t in outs:
            self._add_storage(t)
        if func in _NO_WRITE or _is_view(func):
            return out
        seen = {}
        for t in tree_leaves((args, kwargs)):
            if isinstance(t, torch.Tensor):
                seen[id(t)] = _nbytes(t)
        out_b = 0
        for t in outs:
            if id(t) not in seen:
                out_b += _nbytes(t)
        name = func._overloadpacket.__name__
        if name in _INDEXED_WRITES:
            seen.pop(id(args[0]), None)
            out_b = sum(seen.values())
        elif name in _INDEXED_READS:
            seen[id(args[0])] = out_b
        b = sum(seen.values()) + out_b
        self.bytes += b
        kind = self.by_kind[func.__name__]
        kind["bytes"] += out_b
        kind["count"] += 1
        if out_b:
            self.top_ops.append((out_b, func.__name__))
            if len(self.top_ops) > 4 * TOP_OPS:
                self.top_ops.sort(key=lambda x: -x[0])
                del self.top_ops[TOP_OPS:]
        return out

    def profile(self) -> dict:
        """The reference's `profile_hlo` shape: op kinds by output bytes,
        the largest single ops (output bytes, kind)."""
        kinds = sorted(((k, dict(v)) for k, v in self.by_kind.items()),
                       key=lambda kv: -kv[1]["bytes"])
        top = sorted(self.top_ops, key=lambda x: -x[0])[:TOP_OPS]
        return {"by_kind": kinds, "top_ops": top}


def count_step(fn, arguments=()):
    """Run fn() under the op counter and FlopCounterMode, the storages
    of `arguments` counted live from the start. -> (fn's result, dict:
    flops (FlopCounterMode's plus the kernels' own), bytes (the ops'
    plus the kernels' own), peak_live_bytes, n_ops, kernels, profile)."""
    fc = FlopCounterMode(display=False)
    oc = OpCounter()
    oc.track(t for t in arguments)
    with fc, oc:
        result = fn()
    k = oc.kernels
    return result, {
        "flops": fc.get_total_flops() + k.flops,
        "bytes": oc.bytes + k.bytes,
        "peak_live_bytes": oc.peak_live_bytes,
        "n_ops": oc.n_ops,
        "kernels": {"calls": k.calls, "flops": k.flops, "bytes": k.bytes,
                    "by_kernel": k.by_kernel},
        "profile": oc.profile(),
    }


# ---------------------------------------------------------------------------
# torch.profiler traces on the card
# ---------------------------------------------------------------------------

def traced_kernels(prof) -> list:
    """The CUDA kernel events of a torch.profiler trace."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def kernel_time_by_name(kernels) -> dict:
    """Device microseconds of each kernel name over the events."""
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    return by_name


def top_kernels(by_name: dict, steps: int) -> list:
    """The TOP_KERNELS kernel names with the most device time, in ms a
    step."""
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP_KERNELS]
    return [{"name": name[:80], "ms": us / 1e3 / steps} for name, us in top]
