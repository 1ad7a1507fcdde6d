"""Device meshes over the ranks of the default process group (port of
``repro.launch.mesh``).

A "device" is a rank of the default ``torch.distributed`` group.  Under
``torchrun`` the launcher made that group; otherwise :func:`ensure_group`
makes a world-1 group over a local store (``nccl`` for ``cuda``, ``gloo``
for ``cpu``), so a single process gets the (1, 1) mesh, as the reference
gets on one jax device.  Importing this module touches no device and no
group.
"""
from __future__ import annotations

import contextlib
import os
from typing import Sequence

import torch


def _device_type(device=None) -> str:
    if device is not None:
        return torch.device(device).type
    import torch.distributed as dist
    backend = dist.get_backend() if dist.is_initialized() else None
    return "cuda" if backend == "nccl" else "cpu"


def ensure_group(device="cuda") -> None:
    """Make the default process group if none exists: the launcher's
    (``torchrun`` sets ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``), else a
    world-1 group over an in-process store."""
    import torch.distributed as dist
    if dist.is_initialized():
        return
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend)
        return
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


@contextlib.contextmanager
def owned_group(device="cuda"):
    """The default group for a driver's run: made by :func:`ensure_group`
    if none exists, and then destroyed when the run ends."""
    import torch.distributed as dist
    owned = not dist.is_initialized()
    ensure_group(device)
    try:
        yield
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()


def make_mesh(shape: Sequence[int], axes: Sequence[str], device=None):
    """A ``DeviceMesh`` of ``shape`` with axis names ``axes`` over the
    default group's ranks, in rank order.  It is built directly from the
    rank grid, so no rank picks a card index: a fake group of any size
    gives a mesh without touching a device."""
    from torch.distributed.device_mesh import DeviceMesh
    n = 1
    for s in shape:
        n *= int(s)
    return DeviceMesh(_device_type(device),
                      torch.arange(n).view(*[int(s) for s in shape]),
                      mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_host_mesh(model_parallel: int = 1, device: str = "cuda"):
    """Small mesh over whatever ranks exist (tests / examples); makes a
    world-1 group first when no launcher made one.  The mesh is on the card
    unless the caller names ``device="cpu"``."""
    import torch.distributed as dist
    ensure_group(device)
    n = dist.get_world_size()
    mp = model_parallel if n % model_parallel == 0 else 1
    return make_mesh((n // mp, mp), ("data", "model"), device=device)
