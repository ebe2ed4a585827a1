"""Device mesh construction and multi-process initialization.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh``: one process (rank)
per device, each mesh axis a process group. On the card the collectives run
on NCCL, on the CPU on gloo; a process that joins no cluster forms a
one-rank world, so every sharded function runs on a single device too.
"""
from __future__ import annotations

import os
from datetime import timedelta

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

#: how long a collective may wait for its peers before it raises
TIMEOUT = timedelta(minutes=5)


def _backend(device_type: str | None = None) -> str:
    """gloo for CPU tensors and, where there is a card, NCCL for CUDA ones."""
    if device_type == "cpu" or not torch.cuda.is_available():
        return "gloo"
    return "cpu:gloo,cuda:nccl"


def _bind_card():
    """One card per process: the local rank's (torchrun's LOCAL_RANK), else
    the rank's modulo the cards of this host."""
    if torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None):
    """Join (or form) the process group; returns ``(rank, world_size)``.

    ``coordinator_address`` is ``"host:port"`` of rank 0, as in the JAX
    package; with none given, the variables ``torchrun`` sets (``MASTER_ADDR``,
    ``RANK``, ``WORLD_SIZE``) are used where present. A single process with
    no cluster joins nothing and gets ``(0, 1)``; a process group that is
    already initialized is kept.
    """
    if not dist.is_initialized():
        env = os.environ
        if coordinator_address is not None:
            dist.init_process_group(
                _backend(), init_method=f"tcp://{coordinator_address}",
                world_size=-1 if num_processes is None else num_processes,
                rank=-1 if process_id is None else process_id, timeout=TIMEOUT)
        elif all(k in env for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")):
            dist.init_process_group(_backend(), init_method="env://", timeout=TIMEOUT)
        else:
            return 0, 1
        _bind_card()
    return dist.get_rank(), dist.get_world_size()


def make_mesh(shape: tuple[int, ...] | int | None = None, axis_names: tuple[str, ...] = ("shard",),
              device_type: str | None = None) -> DeviceMesh:
    """Build a mesh over the ranks of the process group.

    ``shape=None`` puts every rank on one axis; an int is a one-axis shape.
    Names that do not match the shape's rank become ``ax0, ax1, ...``.
    ``device_type`` is "cuda" (the card, the default) or "cpu". A process
    with no process group forms a one-rank world first.
    """
    device_type = device_type or "cuda"
    if device_type == "cuda":
        torch.cuda.current_device()  # no card: torch's own error, before any group forms
    if not dist.is_initialized():
        dist.init_process_group(_backend(device_type), store=dist.HashStore(), rank=0,
                                world_size=1, timeout=TIMEOUT)
    if shape is None:
        shape = (dist.get_world_size(),)
    elif isinstance(shape, int):
        shape = (shape,)
    shape = tuple(int(s) for s in shape)
    if len(axis_names) != len(shape):
        axis_names = tuple(f"ax{i}" for i in range(len(shape)))
    return init_device_mesh(device_type, shape, mesh_dim_names=tuple(axis_names))
