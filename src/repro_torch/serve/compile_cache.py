"""Process-wide cache of the serving step wrappers, keyed by (wrapper
kind, model config, mesh fingerprint) (the reference's
`serve/compile_cache.py`).

Engines *borrow* their step functions from here instead of building
their own, so N engines of one config share one wrapper per kind, and
`stats()` counts entries, hits and misses exactly as the reference's
cache does (a second identical engine adds hits and no entry).

What a wrapper caches is the port's counterpart of a jitted executable:

  - On a CUDA device, the fixed-shape steps (`decode_dense`,
    `decode_paged`, `draft_propose` with one graph per depth k,
    `verify_paged`) are captured as a CUDA graph on their first call
    for a signature and replayed after that: one launch of the whole
    step instead of its ~2,000 kernels from a Python loop. The
    signature is the shapes and dtypes of the inputs, the static
    arguments, and the identity (device addresses) of every tensor of
    the params and cache trees the graph reads and writes. Host inputs
    are copied into the graph's own input tensors through pinned
    memory, one non-blocking copy each; device inputs by one device
    copy. A wrapper returns the graph's output tensors, which stay
    valid until the next replay of any graph of this cache: read them
    (or copy them) before that.
  - Every other kind (prefill, the extend pass, scatter, page copies,
    block-table pushes, the evaluation forward) changes shape from call
    to call and runs eagerly; so does every kind on the CPU, which is
    the path the CPU tests take.

`wrapper._cache_size()` counts the distinct shape signatures a wrapper
has run (the reference's `jitted._cache_size()`): a second engine of the
same shapes captures graphs of its own pool but adds no signature.

Capture. A graph is captured after one warm-up run on a side stream
(kernel builds, cuBLAS workspaces). The decode steps write their cache
in place; a warm-up's K/V (and MLA latent) writes repeat exactly what
the first replay writes, but a Mamba layer's state rows would advance
twice, so the warm-up saves those rows and restores them. The capture
runs nothing, with Python's cyclic collector held off (a dead engine
in a reference cycle would otherwise have its graphs destroyed in the
middle of the capture, which invalidates it). The kernel wrappers
count launches when they are called, which a replay does not do: the
counts a capture traces are recorded, left out of the totals (nothing
ran), and added once per replay, so `kernels.launch_counts()` keeps
counting the launches the device ran.
A capture that fails raises with the reason; nothing falls back to the
eager step.

Memory. All graphs draw on one memory pool (`graph_pool_handle`). A
wrapper holds no reference to the params or the pool a graph reads: a
graph is dropped when the first tensor of either tree is freed, so a
dropped engine takes its graphs with it, and `clear()` drops every
graph.

Meshes. Wrappers are keyed by the mesh's fingerprint as in the
reference (the config a rank runs is its shard config, so the key
differs from a single device's anyway). Under a model axis > 1 every
kind runs eagerly: the steps hold the model group's collectives, and
gloo's collectives cannot be captured in a CUDA graph. Capturing them
with NCCL's is a later PR (ROADMAP Queue 1 item 6.4). A data-only mesh
(model axis 1) has no collective inside a step (the engine gathers the
sampled tokens outside it), so its graphed kinds capture as on one
device, unless its weights are sharded over the data axis (FSDP,
dist/fsdp.py): then every pass gathers them over the data group inside
the step, and every kind runs eagerly; `get(..., fsdp=True)` keys it
apart.
"""
from __future__ import annotations

import gc
import time
import weakref

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.models.model import (copy_pages, decode_step,
                                      decode_step_paged, draft_propose_paged,
                                      extend_paged, forward, prefill,
                                      scatter_prefill_cache, verify_paged)
from repro_torch.quant.qlinear import QuantizedTensor

_CACHE: dict = {}
_STATS = {"hits": 0, "misses": 0}
# graphs captured, seconds spent capturing them (warm-up included),
# replays and the kernel launches they ran, since the last clear()
_GRAPHS = {"captured": 0, "capture_s": 0.0, "replays": 0}
_REPLAYED: dict = {}
_POOL: list = []          # [the shared graph memory pool handle]
_SIDE: dict = {}          # device -> side stream for warm-up and capture


def mesh_fingerprint(mesh):
    """Hashable identity of a mesh: axis names, shape, devices."""
    if mesh is None:
        return None
    return (tuple(mesh.axis_names), tuple(np.shape(mesh.devices)),
            tuple(str(d) for d in np.ravel(mesh.devices)))


def _tensors(tree, out: list) -> list:
    """The tensors of a params or cache tree, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, dict):
        for v in tree.values():
            _tensors(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _tensors(v, out)
    elif isinstance(tree, QuantizedTensor):
        out += (tree.codes, tree.alphas, tree.betas)
    elif hasattr(tree, "tensors"):              # dist/fsdp.py FsdpLeaf
        out += tree.tensors()
    return out


def _sig(a):
    """Shape signature of one non-tree argument."""
    if isinstance(a, (torch.Tensor, np.ndarray)):
        return tuple(a.shape), str(a.dtype)
    if isinstance(a, (list, tuple)):
        return (len(a),)
    return type(a).__name__


def _host(a) -> torch.Tensor:
    """A host input as a CPU tensor."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.from_numpy(np.ascontiguousarray(a))


class _Graph:
    """One captured step: the graph, its input and output tensors and
    the launches one replay makes."""

    def __init__(self, graph, inputs):
        self.graph = graph
        self.inputs = inputs
        self.out = None
        self.launches: dict = {}

    def load(self, args) -> None:
        """Copy this call's inputs into the graph's input tensors: a host
        input through pinned memory (the caching host allocator keeps
        the block until the copy has run), a device input directly."""
        for dst, a in zip(self.inputs, args):
            if isinstance(a, torch.Tensor) and a.device.type == "cuda":
                dst.copy_(a)
            else:
                dst.copy_(_host(a).pin_memory(), non_blocking=True)

    def replay(self):
        self.graph.replay()
        kernels.add_launch_counts(self.launches)
        _GRAPHS["replays"] += 1
        for k, n in self.launches.items():
            _REPLAYED[k] = _REPLAYED.get(k, 0) + n
        return self.out


class Step:
    """A borrowed step function. `roles` names each positional argument:
    "tree" (params or cache, passed as is), "in" (an input tensor or host
    array, moved to the device), "raw" (a host value passed as is) or
    "static" (a hashable value that keys the step, like jit's static
    arguments). `graphed` kinds capture a CUDA graph on a CUDA device."""

    def __init__(self, kind, cfg, fn, roles, graphed=False):
        self.kind, self.cfg, self._fn = kind, cfg, fn
        self._roles = roles
        self._graphed = graphed
        self._shapes: set = set()
        self._graphs: dict = {}

    def _cache_size(self) -> int:
        """Distinct shape signatures this wrapper has run."""
        return len(self._shapes)

    def graphs(self) -> int:
        """Captured graphs alive in this wrapper."""
        return len(self._graphs)

    def drop_graphs(self) -> None:
        self._graphs.clear()

    def _shape_key(self, args):
        return tuple(
            tuple((tuple(t.shape), t.dtype) for t in _tensors(a, []))
            if r == "tree" else a if r == "static" else _sig(a)
            for r, a in zip(self._roles, args))

    def __call__(self, *args):
        if len(args) != len(self._roles):
            raise TypeError(f"{self.kind} takes {len(self._roles)} "
                            f"arguments, got {len(args)}")
        # every kind takes a params or cache tree, which sets the device
        dev = next(_tensors(a, [])[0] for r, a in zip(self._roles, args)
                   if r == "tree").device
        if self._graphed and dev.type == "cuda":
            return self._replay(dev, args)
        self._shapes.add(self._shape_key(args))
        args = [torch.as_tensor(_host(a), device=dev) if r == "in" else a
                for r, a in zip(self._roles, args)]
        with torch.no_grad():
            return self._fn(*args)

    # ---------------- the graph path ----------------
    def _replay(self, dev, args):
        trees = [a for r, a in zip(self._roles, args) if r == "tree"]
        ins = [a for r, a in zip(self._roles, args) if r == "in"]
        key = (tuple(_sig(a) for a in ins),
               tuple(a for r, a in zip(self._roles, args) if r == "static"),
               tuple(tuple(map(torch.Tensor.data_ptr, _tensors(t, [])))
                     for t in trees))
        g = self._graphs.get(key)
        if g is None:
            self._shapes.add(self._shape_key(args))
            g = self._capture(dev, key, args, trees, ins)
        g.load(ins)
        return g.replay(), trees[1]

    def _state_rows(self, cache) -> list:
        """The cache leaves a step advances rather than rewrites: every
        leaf of a Mamba layer (its state rows)."""
        return [leaf for spec, layer in zip(self.cfg.layer_specs(), cache)
                if spec.kind != "attn" for leaf in layer.values()]

    def _capture(self, dev, key, args, trees, ins):
        t0 = time.perf_counter()
        inputs = [torch.empty(tuple(a.shape), dtype=_host(a).dtype,
                              device=dev) for a in ins]
        it = iter(inputs)
        call = [next(it) if r == "in" else a
                for r, a in zip(self._roles, args)]
        g = _Graph(torch.cuda.CUDAGraph(), inputs)
        g.load(ins)
        side = _SIDE.get(dev)
        if side is None:
            side = _SIDE[dev] = torch.cuda.Stream(dev)
        if not _POOL:
            _POOL.append(torch.cuda.graph_pool_handle())
        before = kernels.launch_counts()
        try:
            with torch.no_grad():
                saved = [(leaf, leaf.clone())
                         for leaf in self._state_rows(trees[1])]
                side.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(side):
                    self._fn(*call)                      # warm-up
                    for leaf, copy in saved:
                        leaf.copy_(copy)
                torch.cuda.current_stream(dev).wait_stream(side)
                del saved
                traced = kernels.launch_counts()
                # no cyclic collection while capturing: it may free a
                # dead engine's graphs, whose destruction invalidates
                # the capture in progress
                collecting = gc.isenabled()
                gc.disable()
                try:
                    with torch.cuda.graph(g.graph, pool=_POOL[0],
                                          stream=side):
                        out = self._fn(*call)
                except Exception as e:
                    raise RuntimeError(f"{self.kind}: CUDA graph capture "
                                       f"failed: {e}") from e
                finally:
                    if collecting:
                        gc.enable()
                captured = kernels.launch_counts()
        finally:
            kernels.set_launch_counts(before)
        g.out = out[0]
        g.launches = {k: captured[k] - traced[k] for k in captured}
        self._graphs[key] = g
        # the graph reads these trees' tensors without holding them: it
        # goes when either tree's first tensor is freed
        for t in trees:
            weakref.finalize(_tensors(t, [])[0], self._graphs.pop, key,
                             None)
        torch.cuda.synchronize(dev)
        _GRAPHS["captured"] += 1
        _GRAPHS["capture_s"] += time.perf_counter() - t0
        return g


def _build(kind, cfg, mesh=None, fsdp=False):
    step = _build_step(kind, cfg)
    # a model axis > 1 runs its group's collectives inside the steps, and
    # FSDP its data group's
    step._graphed = step._graphed and not fsdp and (
        mesh is None or mesh.shape[1] == 1)
    return step


def _build_step(kind, cfg):
    if kind == "decode_dense":
        return Step(kind, cfg, lambda p, c, t, s: decode_step(cfg, p, c, t, s),
                    ("tree", "tree", "in", "in"), graphed=True)
    if kind == "decode_paged":
        def step(p, c, t, s, bt, live, null_row):
            # masked (inactive) rows read and write the null page
            bt = torch.where(live[:, None] > 0, bt, null_row[:, None])
            return decode_step_paged(cfg, p, c, t, s, bt.contiguous())
        return Step(kind, cfg, step, ("tree", "tree") + ("in",) * 5,
                    graphed=True)
    if kind == "prefill":
        return Step(kind, cfg,
                    lambda p, t, lp, ml: prefill(cfg, p, t, ml, last_pos=lp),
                    ("tree", "in", "in", "static"))
    if kind == "extend_paged":
        return Step(kind, cfg,
                    lambda p, c, t, sp, bt, nv: extend_paged(cfg, p, c, t, sp,
                                                             bt, nv),
                    ("tree", "tree") + ("in",) * 4)
    if kind == "draft_propose":
        # the draft's k-step propose pass; k is static: one graph a depth
        def propose(p, c, cur, sp, bt, ke, null_row, k):
            return draft_propose_paged(cfg, p, c, cur, sp, bt, ke,
                                       null_row, k)
        return Step(kind, cfg, propose,
                    ("tree", "tree") + ("in",) * 5 + ("static",),
                    graphed=True)
    if kind == "verify_paged":
        # speculative verify: k+1 positions in one pass, logits at every
        # position (one graph a token width k+1)
        def verify_step(p, c, t, sp, bt, nv, live, null_row):
            bt = torch.where(live[:, None] > 0, bt, null_row[:, None])
            return verify_paged(cfg, p, c, t, sp, bt.contiguous(), nv)
        return Step(kind, cfg, verify_step, ("tree", "tree") + ("in",) * 6,
                    graphed=True)
    if kind == "scatter_prefill":
        return Step(kind, cfg,
                    lambda c, r, sl, pi, nv: scatter_prefill_cache(
                        cfg, c, r, sl, pi, nv),
                    ("tree", "tree", "raw", "raw", "raw"))
    if kind == "copy_pages":
        return Step(kind, cfg, copy_pages, ("tree", "raw", "raw", "static"))
    if kind == "bt_update":
        def bt_update(bt, idx, rows):
            bt[idx.long()] = rows.to(bt.dtype)
            return bt
        return Step(kind, cfg, bt_update, ("tree", "in", "in"))
    if kind == "eval_forward":
        # logits-only forward for perplexity (data/evaluate.py)
        def fwd(p, x):
            with torch.inference_mode():
                return forward(cfg, p, x, remat="none")[0]
        return Step(kind, cfg, fwd, ("tree", "in"))
    raise KeyError(kind)


def get(kind: str, cfg=None, mesh=None, fsdp: bool = False):
    """The shared wrapper for (kind, cfg, mesh, whether the weights are
    FSDP-sharded): built on first request, borrowed ever after."""
    key = (kind, cfg, mesh_fingerprint(mesh)) + (("fsdp",) if fsdp else ())
    fn = _CACHE.get(key)
    if fn is None:
        fn = _CACHE[key] = _build(kind, cfg, mesh, fsdp)
        _STATS["misses"] += 1
    else:
        _STATS["hits"] += 1
    return fn


def stats() -> dict:
    return {"entries": len(_CACHE), **_STATS}


def graph_stats() -> dict:
    """Graphs captured, capture seconds, replays and the kernel launches
    inside replays since the last clear(), and the graphs alive now."""
    return {**_GRAPHS, "launches": dict(_REPLAYED),
            "live": sum(w.graphs() for w in _CACHE.values())}


def clear() -> None:
    """Drop every cached wrapper and every captured graph."""
    for w in _CACHE.values():
        w.drop_graphs()
    _CACHE.clear()
    _POOL.clear()
    _STATS.update(hits=0, misses=0)
    _GRAPHS.update(captured=0, capture_s=0.0, replays=0)
    _REPLAYED.clear()
