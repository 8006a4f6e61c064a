"""Mesh construction (the reference's `launch/mesh.py`). Functions, not
module state: importing this module touches no device and starts no
process."""
from __future__ import annotations

import torch

from repro_torch.dist.context import ServeMesh
from repro_torch.hw import resolve_device


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's 16x16 (2x16x16 multi-pod) TPU meshes: training's
    FSDP over them is still to do (ROADMAP Queue 1 item 6, its training
    part)."""
    raise NotImplementedError(
        "the pod meshes wait on FSDP training (--mesh pod|multipod: "
        "ROADMAP Queue 1 item 6, still to do); serving meshes come from "
        "make_serve_mesh")


def make_host_mesh(device=None):
    """The calling process as a (1, 1) mesh (tests, examples): bound at
    rank 0, no process group, every collective a no-op; on the card
    unless the caller names another device."""
    return ServeMesh(1, 1, [str(resolve_device(device))], rank=0)


def make_serve_mesh(data: int = 1, model: int = 1, devices=None):
    """A serving mesh of `data` page-pool shards (each holding an equal
    block of the paged-KV pool and an equal slice of the batch) x
    `model` tensor-parallel ways, one rank a position (unbound: spawn
    its ranks with dist.context.spawn or launch/serve.py). `devices`
    names each rank's device in rank order ("cuda:0,cuda:0" rehearses
    two ranks on one card, "cpu,cpu" two on the CPU); by default every
    rank gets a card of its own, and too few cards raise."""
    n = data * model
    if devices is None:
        visible = torch.cuda.device_count()
        if n > visible:
            raise ValueError(f"mesh {data}x{model} needs {n} devices, only "
                             f"{visible} visible (name the devices to "
                             f"share one: --devices cuda:0,cuda:0,...)")
        devices = [f"cuda:{i}" for i in range(n)]
    elif isinstance(devices, str):
        devices = devices.split(",")
    return ServeMesh(data, model, devices)
