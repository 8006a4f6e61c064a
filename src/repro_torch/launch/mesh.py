"""Mesh construction (the reference's `launch/mesh.py`). Functions, not
module state: importing this module touches no device and starts no
process. The meshes are dist/context.py's ServeMesh, which serves
(launch/serve.py) and trains (launch/train.py) alike."""
from __future__ import annotations

import torch

from repro_torch.dist.context import ServeMesh
from repro_torch.hw import resolve_device

# a card a rank, the collectives over NCCL: never run yet
NCCL_ITEM = ("a mesh of a card a rank over NCCL is ROADMAP Queue 1 item "
             "6.4, never run yet")


def make_production_mesh(*, multi_pod: bool = False, model: int = 1,
                         devices=None):
    """The reference's training mesh (its 16x16 "pod": data = FSDP/ZeRO
    and batch, model = TP) over the visible cards: (N / `model`,
    `model`), one card a rank (unbound: spawn its ranks with
    dist.context.spawn or launch/train.py). `devices` names the ranks'
    devices instead ("cuda:0,cuda:0" rehearses two ranks on one card).
    Too few cards raise, as in make_serve_mesh. The multi-pod mesh's
    third, pure data-parallel "pod" axis is ROADMAP Queue 1 item 6.2,
    still to do."""
    if multi_pod:
        raise NotImplementedError(
            "the multi-pod mesh (a third, pure data-parallel \"pod\" axis; "
            "--mesh multipod) is ROADMAP Queue 1 item 6.2, still to do")
    if devices is None:
        n = torch.cuda.device_count()
        if n < model or n % model:
            raise ValueError(f"a pod mesh with a {model}-way model axis "
                             f"needs a multiple of {model} cards, {n} "
                             f"visible (name the devices to share one: "
                             f"--devices cuda:0,cuda:0,...; {NCCL_ITEM})")
        devices = [f"cuda:{i}" for i in range(n)]
    elif isinstance(devices, str):
        devices = devices.split(",")
    if len(devices) % model:
        raise ValueError(f"{len(devices)} devices do not split into a "
                         f"{model}-way model axis")
    return ServeMesh(len(devices) // model, model, devices)


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
                             f"share one: --devices cuda:0,cuda:0,...; "
                             f"{NCCL_ITEM})")
        devices = [f"cuda:{i}" for i in range(n)]
    elif isinstance(devices, str):
        devices = devices.split(",")
    return ServeMesh(data, model, devices)
