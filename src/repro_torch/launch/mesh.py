"""Meshes and the process group of a job (counterpart of
``repro/launch/mesh.py``).

Functions, not module constants: importing this module touches no device
and no process group.  :func:`init_world` starts ``torch.distributed``
(NCCL on the card, gloo only when the caller asks for the CPU; no fallback
from one to the other) on a ``file://`` store, or on the caller's
``init_method``: nothing is read from a cluster.  The mesh builders wrap
``init_device_mesh`` over the world so started.
"""
from __future__ import annotations

import datetime
import os
import tempfile

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device


def production_mesh_shape(multi_pod: bool = False) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """(shape, axis names) of the reference's production mesh: 2 pods of
    16 x 16, or one pod of 16 x 16."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def init_world(
    rank: int = 0,
    world_size: int = 1,
    device: str | torch.device | None = None,
    init_method: str | None = None,
    timeout: datetime.timedelta | None = None,
) -> torch.device:
    """Start the default process group and return this rank's device.

    ``device`` None means the card (``cuda:<rank % cards>``) and NCCL;
    ``"cpu"`` means gloo.  A CUDA device where NCCL is missing raises.
    ``init_method`` defaults to a ``file://`` store in a new temporary
    directory, which serves a world of one; a larger world passes one
    shared by its ranks.  ``timeout``: how long a collective waits for the
    other ranks before it raises (the backend's default when None)."""
    dev = resolve_device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("torch.distributed has no NCCL backend on this machine")
        if dev.index is None:
            dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process group backend for device {dev}")
    if init_method is None:
        if world_size != 1:
            raise ValueError("a world of more than one rank needs a shared init_method")
        init_method = "file://" + os.path.join(tempfile.mkdtemp(prefix="repro_world_"), "store")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=timeout)
    return dev


def make_mesh(shape: tuple[int, ...], names: tuple[str, ...],
              device: str | torch.device | None = None) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` with axes ``names`` over the started
    world (on the card unless ``device`` says the CPU)."""
    dev = resolve_device("cuda" if device is None else device)
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(names))


def make_host_mesh(data: int | None = None, model: int = 1,
                   device: str | torch.device | None = None) -> DeviceMesh:
    """A ``(data, model)`` mesh over the current world (tests, local
    runs); ``data`` defaults to the world size over ``model``."""
    n = dist.get_world_size()
    if data is None:
        data = n // model
    if data * model > n:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} ranks, the world has {n}")
    return make_mesh((data, model), ("data", "model"), device)
