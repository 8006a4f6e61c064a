"""Meshes of `torch.distributed` ranks for serving and training (the
counterpart of the reference's `dist/context.py` and its
`jax.sharding.Mesh`).

One process a mesh position: a (data, model) mesh of D x M ranks, rank
r at coordinates (d, m) = (r // M, r % M), as a jax mesh orders its
devices. A bound ServeMesh holds this rank's coordinates and its
process groups beside the world: the model group (the M ranks of its
data row, which split heads, MLP width and experts; the mesh's backend)
and the data group (the D ranks of its model column, which split the
batch and the page pool; gloo, since the serving loop exchanges sampled
tokens over it as CPU tensors), and for FSDP-sharded weights the data
group of the mesh's backend, over which a layer's weight blocks are
gathered (`gather_fsdp`, `reduce_fsdp`; the gloo group itself on a
gloo mesh).

The backend follows from the devices the caller named, never silently:
NCCL when every rank has a CUDA device of its own, gloo when the ranks
are on the CPU or when the caller named one card for several ranks (the
one-card rehearsal, the counterpart of the reference's `--devices N`
host devices). Gloo takes CUDA tensors for all_reduce (sum and max),
all_gather, reduce_scatter and broadcast (it stages them through host
memory itself).

`reduce_model`, `copy_to_model`, `gather_model` and `gather_data` are
the model-side hooks: exact no-ops outside a mesh or over an axis of
size 1, as the reference's `constrain_batch` is, so models/ calls them
unconditionally. While autograd records on a mesh, the device hooks are
autograd Functions with the backward the SPMD semantics need (training,
train/train_step.py):

    hook            forward                 backward
    reduce_model    all-reduce over model   identity (the loss is the
                                            same on every model rank)
    copy_to_model   identity                all-reduce over model
    gather_model    all-gather over model   this rank's slice
    gather_fsdp     all-gather over data    reduce-scatter (sum) over data
    reduce_fsdp     all-reduce over data    all-reduce over data (each
                                            data rank keeps other rows;
                                            the MoE routing's mean over
                                            the data group)

copy_to_model(reduce_model(y)) sums partial outputs that every rank then
uses whole (Mamba's x_proj features) forward and backward.
`gather_counts` all-gathers a small int tensor over the data group (a
training MoE layer's routing counts, models/moe.py), with no gradient.
A backward collective is counted under a kind of its own ("..._backward");
`sync_grads` and `reduce_max` count theirs as "step_...".
`spawn(fn, mesh)` runs `fn(bound_mesh, *args)` on every rank of a mesh
in processes of its own (spawned, rendezvous through a file store in a
temporary directory) and returns each rank's result; a rank that raises
fails the whole call with its traceback, and the other ranks are
stopped.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

_MESH_STACK: list = []


def _backend(devices) -> str:
    """The backend the named devices call for (see the module doc)."""
    kinds = {torch.device(d).type for d in devices}
    if kinds == {"cpu"}:
        return "gloo"
    if kinds != {"cuda"}:
        raise ValueError(f"devices {list(devices)}: a mesh takes CPU ranks "
                         f"or CUDA ranks, not both")
    names = [str(torch.device(d)) for d in devices]
    return "nccl" if len(set(names)) == len(names) else "gloo"


class ServeMesh:
    """A (data, model) mesh of ranks. Unbound (`rank` None) it is the
    description the launcher spawns from; `bind(rank)` inside a rank's
    process gives the mesh that rank serves with."""

    axis_names = ("data", "model")

    def __init__(self, data: int, model: int, devices, *, rank=None,
                 base: int = 0):
        devices = [str(torch.device(d)) for d in devices]
        if data < 1 or model < 1:
            raise ValueError(f"mesh {data}x{model}: axes must be >= 1")
        if len(devices) != data * model:
            raise ValueError(f"mesh {data}x{model} needs {data * model} "
                             f"devices, {len(devices)} named")
        self.shape = (int(data), int(model))
        self.devices = np.array(devices, dtype=object).reshape(self.shape)
        self.backend = _backend(devices)
        self.rank = rank
        # the world rank of this mesh's rank 0 (a submesh's offset)
        self.base = int(base)
        self._groups = None
        # collectives this rank ran, by kind: {"all_reduce": n, ...}
        self.counts: dict = {}

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def coords(self) -> tuple:
        """(d, m) of this rank."""
        return divmod(self.rank, self.shape[1])

    @property
    def device(self) -> torch.device:
        return torch.device(self.devices.reshape(-1)[self.rank])

    def describe(self) -> str:
        return (f"mesh (data={self.shape[0]}, model={self.shape[1]}) "
                f"backend={self.backend} devices="
                f"{','.join(self.devices.reshape(-1))}")

    def bind(self, rank: int) -> "ServeMesh":
        """This mesh as rank `rank` sees it, with its process groups
        (every rank creates every group, in one order, as
        torch.distributed requires). A mesh of one rank needs no
        process group."""
        out = ServeMesh(*self.shape, self.devices.reshape(-1), rank=rank)
        if out.size > 1:
            out._groups = out._new_groups(rank)
        return out

    def submesh(self, data: int, model: int, first: int = 0):
        """The (data, model) mesh of this bound mesh's ranks first ..
        first + data*model - 1, bound, with groups of its own: one spawn
        serves several meshes, in turn or side by side on disjoint
        ranks. Every rank of this mesh must call it, in one order (each
        creates every group); the ranks outside get None."""
        n = data * model
        if first + n > self.size:
            raise ValueError(f"a {data}x{model} mesh from rank {first} "
                             f"needs ranks this mesh's {self.size} lack")
        rank = self.rank - first
        devices = self.devices.reshape(-1)[first:first + n]
        sub = ServeMesh(data, model, devices, rank=rank,
                        base=self.base + first)
        groups = sub._new_groups(rank) if n > 1 else None
        if not 0 <= rank < n:
            return None
        sub._groups = groups
        return sub

    def _new_groups(self, rank: int) -> dict:
        """Create every model and data group of this mesh over the world
        (world ranks base .. base + size - 1); returns those of `rank`
        (this mesh's)."""
        D, M = self.shape
        d, m = divmod(rank, M)
        groups = {}
        for dd in range(D):
            g = dist.new_group([self.base + dd * M + j for j in range(M)])
            if dd == d:
                groups["model"] = g
        for mm in range(M):
            # tokens cross the data axis as host tensors: gloo; weight
            # blocks (FSDP) as device tensors, over the mesh's backend
            ranks = [self.base + i * M + mm for i in range(D)]
            g = dist.new_group(ranks, backend="gloo")
            dev = (g if self.backend == "gloo"
                   else dist.new_group(ranks, backend=self.backend))
            if mm == m:
                groups["data_host"], groups["data"] = g, dev
        return groups

    def group(self, axis: str):
        return self._groups[axis]

    def _count(self, kind: str) -> None:
        self.counts[kind] = self.counts.get(kind, 0) + 1


def current_mesh():
    return _MESH_STACK[-1] if _MESH_STACK else None


@contextlib.contextmanager
def mesh_context(mesh):
    """Install `mesh` (bound) as the active mesh (stacked; reentrant)."""
    _MESH_STACK.append(mesh)
    try:
        yield mesh
    finally:
        _MESH_STACK.pop()


def data_coords() -> tuple:
    """(index, size) of this rank on the data axis; (0, 1) outside a
    mesh."""
    mesh = current_mesh()
    if mesh is None:
        return 0, 1
    return mesh.coords[0], mesh.shape[0]


def model_coords() -> tuple:
    """(index, size) of this rank on the model axis; (0, 1) outside a
    mesh."""
    mesh = current_mesh()
    if mesh is None:
        return 0, 1
    return mesh.coords[1], mesh.shape[1]


def _records(x) -> bool:
    """Whether autograd records through `x`: a hook then runs as its
    autograd Function."""
    return torch.is_grad_enabled() and x.requires_grad


def _reduce_scatter(x, group, n, dim):
    """This rank's 1/n block along `dim` of the sum of `x` over `group`."""
    x = x.movedim(dim, 0).contiguous()
    out = torch.empty((x.shape[0] // n, *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    # torch 2.13 renames reduce_scatter_tensor (same arguments)
    (getattr(dist, "reduce_scatter_single", None)
     or dist.reduce_scatter_tensor)(out, x, group=group)
    return out.movedim(0, dim)


def _all_reduce(x, mesh, group, kind, op=None):
    """`x` summed (or `op`) over `group`, in place on a contiguous copy
    of a non-contiguous `x`; counted as `kind`."""
    x = x.contiguous()
    if op is None:
        dist.all_reduce(x, group=mesh.group(group))
    else:
        dist.all_reduce(x, op=op, group=mesh.group(group))
    mesh._count(kind)
    return x


class _ReduceModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, mesh):
        return _all_reduce(y.clone(), mesh, "model", "all_reduce")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.mesh, "model",
                           "all_reduce_backward"), None


class _GatherModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.dim, ctx.m, ctx.n = dim, mesh.coords[1], x.shape[dim]
        mesh._count("all_gather")
        return _gather(x.contiguous(), mesh.group("model"), mesh.shape[1],
                       dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.m * ctx.n, ctx.n), None, None


class _GatherFsdp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        mesh._count("all_gather_data")
        return _gather(x.contiguous(), mesh.group("data"), mesh.shape[0],
                       dim)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        mesh._count("reduce_scatter_data_backward")
        return _reduce_scatter(g, mesh.group("data"), mesh.shape[0],
                               ctx.dim), None, None


class _ReduceFsdp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_reduce(x.clone(), mesh, "data", "all_reduce_data")

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.mesh, "data",
                           "all_reduce_data_backward"), None


def reduce_model(y: torch.Tensor) -> torch.Tensor:
    """Sum the partial outputs of a contracting projection over the
    model group (in place, or into a new tensor while autograd records);
    the identity outside a mesh or when the model axis has size 1."""
    mesh = current_mesh()
    if mesh is None or mesh.shape[1] == 1:
        return y
    if _records(y):
        return _ReduceModel.apply(y, mesh)
    return _all_reduce(y, mesh, "model", "all_reduce")


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """`x`, the replicated input of a column-parallel projection (each
    model rank applies its block of heads, MLP width or vocabulary): the
    identity forward; while autograd records on a model axis, its
    gradient (each rank's partial) is summed over the model group."""
    mesh = current_mesh()
    if mesh is None or mesh.shape[1] == 1 or not _records(x):
        return x
    return _CopyToModel.apply(x, mesh)


def routes_over_data(x: torch.Tensor) -> bool:
    """Whether autograd records through `x` on a mesh whose data axis
    has more than one rank: a training step's MoE layer then routes the
    whole microbatch of every data rank (models/moe.py)."""
    mesh = current_mesh()
    return mesh is not None and mesh.shape[0] > 1 and _records(x)


def gather_counts(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Every data rank's copy of the small device tensor `x` (an int
    tensor: a MoE layer's routing counts), stacked along a new dim 0 in
    data-rank order, over the data group of the mesh's backend (counted
    as "all_gather_counts"); x[None] outside a mesh or on a data axis
    of 1."""
    mesh = mesh or current_mesh()
    if mesh is None or mesh.shape[0] == 1:
        return x[None]
    mesh._count("all_gather_counts")
    return _gather(x.contiguous()[None], mesh.group("data"), mesh.shape[0],
                   0)


def _gather(x, group, n, dim):
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def gather_model(x: torch.Tensor, dim: int = -1, mesh=None) -> torch.Tensor:
    """Concatenate each model rank's block of `x` along `dim` (the
    vocabulary of split logits, a K-cut leaf's code words); the identity
    outside a mesh."""
    mesh = mesh or current_mesh()
    if mesh is None or mesh.shape[1] == 1:
        return x
    if _records(x):
        return _GatherModel.apply(x, mesh, dim % x.dim())
    mesh._count("all_gather")
    return _gather(x.contiguous(), mesh.group("model"), mesh.shape[1], dim)


def gather_fsdp(x: torch.Tensor, dim: int, mesh=None) -> torch.Tensor:
    """Concatenate each data rank's block of the device tensor `x` along
    `dim` over the data group (FSDP, dist/fsdp.py: a weight made whole
    for the layer about to run, or every data rank's activations of a
    pass the ranks run in lockstep); the identity outside a mesh."""
    mesh = mesh or current_mesh()
    if mesh is None or mesh.shape[0] == 1:
        return x
    if _records(x):
        return _GatherFsdp.apply(x, mesh, dim % x.dim())
    mesh._count("all_gather_data")
    return _gather(x.contiguous(), mesh.group("data"), mesh.shape[0], dim)


def reduce_fsdp(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Sum the device tensor `x` over the data group, in place (or into a
    new tensor while autograd records) (FSDP: the partial products of a
    weight's data-rank blocks of K); the identity outside a mesh."""
    mesh = mesh or current_mesh()
    if mesh is None or mesh.shape[0] == 1:
        return x
    if _records(x):
        return _ReduceFsdp.apply(x, mesh)
    return _all_reduce(x, mesh, "data", "all_reduce_data")


def sync_grads(tensors, axis: str, mesh=None) -> list:
    """The device tensors `tensors` each summed over the `axis` ("data" or
    "model") group, in one all-reduce of their concatenation (counted as
    "step_all_reduce_<axis>"); as they are outside a mesh or over an
    axis of size 1."""
    mesh = mesh or current_mesh()
    n = mesh.shape[0 if axis == "data" else 1] if mesh is not None else 1
    if n == 1 or not tensors:
        return list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    _all_reduce(flat, mesh, axis, f"step_all_reduce_{axis}")
    return [part.view_as(t) for part, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def reduce_max(x: torch.Tensor, mesh=None,
               kind: str = "step_all_reduce_max") -> torch.Tensor:
    """The elementwise maximum of the device tensor `x` over the whole
    mesh (over the data group, then the model group; counted as
    "<kind>_<axis>"); `x` outside a mesh."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return x
    for axis, n in zip(("data", "model"), mesh.shape):
        if n > 1:
            x = _all_reduce(x, mesh, axis, f"{kind}_{axis}",
                            dist.ReduceOp.MAX)
    return x


def mesh_any(flag: bool, mesh=None) -> bool:
    """Whether `flag` holds on any rank of the mesh: every rank waits
    for every other here (a barrier: each rank's data group, then each
    model group, which holds a rank of every data group); `flag` outside
    a mesh."""
    mesh = mesh or current_mesh()
    if mesh is None or mesh.size == 1:
        return bool(flag)
    x = torch.tensor([float(flag)], device=mesh.device)
    return bool(reduce_max(x, mesh, "barrier").item())


def gather_data(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Concatenate each data rank's block of the host tensor `x` along
    dim 0 (a row a batch slot, in slot order: the sampled token of each,
    or under speculation each row's variable token list, padded, its
    length first); the identity outside a mesh."""
    mesh = mesh or current_mesh()
    if mesh is None or mesh.shape[0] == 1:
        return x
    mesh._count("all_gather_host")
    return _gather(x.contiguous(), mesh.group("data_host"), mesh.shape[0], 0)


def broadcast_data(x: torch.Tensor, src_d: int, mesh=None) -> torch.Tensor:
    """The host tensor `x` of data rank `src_d` (same model coordinate)
    on every data rank; the identity outside a mesh."""
    mesh = mesh or current_mesh()
    if mesh is None or mesh.shape[0] == 1:
        return x
    mesh._count("broadcast_host")
    x = x.contiguous()
    src = mesh.base + src_d * mesh.shape[1] + mesh.coords[1]
    dist.broadcast(x, src=src, group=mesh.group("data_host"))
    return x


# --------------------------------------------------------------------------
# spawning the ranks of a mesh
# --------------------------------------------------------------------------

def _rank_main(fn, mesh, rank, store, args, threads, timeout_s, results):
    try:
        if threads:
            torch.set_num_threads(threads)
        if mesh.size > 1:
            dist.init_process_group(
                mesh.backend, init_method=f"file://{store}", rank=rank,
                world_size=mesh.size,
                timeout=datetime.timedelta(seconds=timeout_s))
        bound = mesh.bind(rank)
        if bound.device.type == "cuda":
            torch.cuda.set_device(bound.device)
        with mesh_context(bound):
            out = fn(bound, *args)
        results.put((rank, True, out))
    except BaseException:
        # the parent stops the other ranks on this report
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, mesh: ServeMesh, args=(), *, threads=None,
          timeout_s: float = 600.0) -> list:
    """Run `fn(bound_mesh, *args)` on every rank of `mesh`, each in a
    spawned process with the mesh installed (mesh_context), and return
    the results in rank order. `fn` and `args` must pickle (a module-
    level function). `threads` sets each rank's torch thread count
    (default for CPU ranks: the cores split among them, so they do not
    oversubscribe the machine). A rank that raises, or a run longer than
    `timeout_s`, raises RuntimeError here after every rank has been
    stopped."""
    import multiprocessing as mp

    if threads is None and mesh.backend == "gloo" and all(
            torch.device(d).type == "cpu" for d in mesh.devices.reshape(-1)):
        threads = max(1, (os.cpu_count() or 1) // mesh.size)

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="mesh_store_")
    store = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, mesh, r, store, args, threads, timeout_s,
                               results), daemon=True)
             for r in range(mesh.size)]
    out: dict = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while len(out) < mesh.size:
            left = deadline - time.monotonic()
            try:
                rank, ok, val = results.get(timeout=max(min(left, 5.0), 0.01))
            except queue.Empty:
                dead = [i for i, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and i not in out]
                if dead:
                    raise RuntimeError(f"{mesh.describe()}: rank {dead[0]} "
                                       f"exited with code "
                                       f"{procs[dead[0]].exitcode}")
                if left <= 0:
                    late = sorted(set(range(mesh.size)) - set(out))
                    raise RuntimeError(f"{mesh.describe()}: ranks {late} "
                                       f"did not finish in {timeout_s} s")
                continue
            if not ok:
                raise RuntimeError(f"{mesh.describe()}: rank {rank} "
                                   f"failed:\n{val}")
            out[rank] = val
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(mesh.size)]
