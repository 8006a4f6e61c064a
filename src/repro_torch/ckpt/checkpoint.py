"""Fault-tolerant training checkpoints (the reference's
`ckpt/checkpoint.py`), in the reference's format.

Layout: <dir>/step_<N>/arrays.npz + meta.json + COMMITTED. Crash
safety: everything is written into step_<N>.tmp, renamed into place,
and the COMMITTED marker is written (and fsynced) last, so a crash
mid-save leaves the previous checkpoint as the restore target. Saves
can run on a background thread after a synchronous copy to host
memory; `keep_n` prunes old steps.

The format is the interface: arrays.npz holds one array per leaf of
the saved tree, keyed by tree.keystr of its path in the reference's
stacked layout ("['params']['blocks']['L0']['attn']['wq']" with the
(n_groups, ...) leaf, "['opt']['mu']...", "['opt']['step']"), and
meta.json {"step", "time", ...}. bf16 leaves are stored as the raw
2-byte void arrays numpy writes for the reference's bf16 (its restore
cannot cast them back; the port reads their bits), everything else as
its numpy dtype. A checkpoint written by either package restores in
the other. `stack_params` stacks the port's per-layer params into that
layout (`ckpt.packed.unstack_blocks` goes back).

A training state cut over a mesh (dist/sharding.py:TrainLayout, passed
as `layout`) is saved whole, in the same format: every rank gathers each
leaf in turn, the mesh's rank 0 copies it to host memory and writes the
checkpoint, and the other ranks wait at a barrier until it is committed.
`restore(layout=)` has each rank read the whole tree, one leaf at a
time, and keep its block, so a checkpoint written on any mesh (or on one
device) resumes on any other.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.ckpt.packed import _restack
from repro_torch.tree import keystr, leaves_with_paths, unflatten


def stack_params(cfg, params) -> dict:
    """The port's {"layers": [...]} -> the reference's stacked {"blocks":
    {"L{i}": (n_groups, ...) leaves}} (copies)."""
    return _restack(params, len(cfg.pattern))


def _host(t) -> np.ndarray:
    """A leaf -> a numpy array of its own (bf16 as 2-byte voids)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _flatten(tree, layout=None) -> dict:
    """{keystr: host array} of every leaf, whole (each gathered over the
    mesh of `layout`; kept on its rank 0 only)."""
    if layout is None:
        return {keystr(path): _host(leaf)
                for path, leaf in leaves_with_paths(tree)}
    out = {}
    for path, leaf in leaves_with_paths(tree):
        whole = layout.gather(path, leaf)
        if layout.mesh.rank == 0:
            out[keystr(path)] = _host(whole)
        del whole
    return out


def _from_host(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A stored array -> a tensor of `like`'s dtype on its device."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:     # bf16 bits
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a if a.flags.c_contiguous else a.copy())
    return t.to(device=like.device, dtype=like.dtype)


def _unflatten_into(template, arrays, layout=None):
    """The template's tree from `arrays` (a dict or an open npz: read a
    leaf at a time), each leaf cut to this rank's block by `layout`."""
    out = []
    for path, leaf in leaves_with_paths(template):
        key = keystr(path)
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        a = arrays[key]
        if layout is not None:
            a = layout.cut(path, a)
        if tuple(a.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {a.shape} != "
                             f"expected {tuple(leaf.shape)}")
        out.append(_from_host(a, leaf))
    return unflatten(template, out)


class CheckpointManager:
    def __init__(self, directory, keep_n: int = 3, async_save: bool = True):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_n = keep_n
        self.async_save = async_save
        self._thread: threading.Thread | None = None

    # ---------------- save ----------------
    def save(self, step: int, tree, metadata: dict | None = None,
             block: bool = False, layout=None):
        """Copy `tree` to host memory now; write it on a thread (or here
        with `block` or async_save=False). With a TrainLayout `tree` is a
        rank's blocks: every rank of its mesh calls this; rank 0 writes
        the whole tree here, and every rank returns once it is
        committed."""
        from repro_torch.dist.context import mesh_any
        arrays = _flatten(tree, layout)
        meta = {"step": int(step), "time": time.time(), **(metadata or {})}
        self.wait()   # never two writers (async then sync same step)
        if layout is not None:
            if layout.mesh.rank == 0:
                self._write(step, arrays, meta)
            mesh_any(False, layout.mesh)      # the others wait for it
        elif self.async_save and not block:
            self._thread = threading.Thread(
                target=self._write, args=(step, arrays, meta), daemon=True)
            self._thread.start()
        else:
            self._write(step, arrays, meta)

    def _write(self, step, arrays, meta):
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz", **arrays)
        (tmp / "meta.json").write_text(json.dumps(meta))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        with open(final / "COMMITTED", "w") as f:
            f.write(str(meta["step"]))
            f.flush()
            os.fsync(f.fileno())
        self._gc()

    def wait(self):
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    def _gc(self):
        steps = self.committed_steps()
        for s in steps[:-self.keep_n] if self.keep_n else []:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ---------------- restore ----------------
    def committed_steps(self):
        out = []
        for p in sorted(self.dir.glob("step_*")):
            if p.suffix == ".tmp" or not (p / "COMMITTED").exists():
                continue
            try:
                out.append(int(p.name.split("_")[1]))
            except (IndexError, ValueError):
                continue
        return out

    def latest_step(self):
        steps = self.committed_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: int | None = None, layout=None):
        """-> (tree matching template, metadata). The template supplies
        structure, shapes, dtypes and devices (e.g. a freshly
        initialized state); with a TrainLayout, a rank's blocks, which
        it cuts from the whole leaves."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        path = self.dir / f"step_{step:08d}"
        with np.load(path / "arrays.npz") as z:
            tree = _unflatten_into(template, z, layout)
        meta = json.loads((path / "meta.json").read_text())
        return tree, meta
