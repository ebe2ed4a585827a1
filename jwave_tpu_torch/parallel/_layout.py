"""Global values in, DTensors out.

A sharded function takes the global value, the same on every rank (a
tensor, numpy, or a ``DTensor`` on the mesh), works on this rank's block,
and returns a ``DTensor`` whose placements are the JAX ``out_specs``:
``Shard(d)`` on the mesh axes a ``PartitionSpec`` names, ``Replicate()``
on the others. Nothing here communicates, except a ``DTensor`` whose
placements differ from the ones wanted, which is redistributed.
"""
from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..utils.host import as_tensor


def mesh_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def placements(mesh: DeviceMesh, dims: dict[str, int]):
    """Per mesh axis: ``Shard(dims[name])`` if the axis is named, else
    ``Replicate()``."""
    return tuple(Shard(dims[name]) if name in dims else Replicate()
                 for name in mesh.mesh_dim_names)


def global_input(x, mesh: DeviceMesh):
    """A ``DTensor`` stays as it is; anything else becomes a tensor on the
    mesh's device."""
    if isinstance(x, DTensor):
        return x
    dev = mesh_device(mesh)
    x = as_tensor(x, dev)
    return x if x.device == dev else x.to(dev)


def local_block(x, mesh: DeviceMesh, dims: dict[str, int]) -> torch.Tensor:
    """This rank's block of the global value ``x`` laid out as ``dims``
    (mesh axis name -> tensor dim), in ``torch.chunk``'s split, as DTensor's
    ``Shard`` cuts."""
    if isinstance(x, DTensor):
        want = placements(mesh, dims)
        if tuple(x.placements) != want:
            x = x.redistribute(mesh, want)
        return x.to_local()
    for name, d in dims.items():
        size = mesh.size(mesh.mesh_dim_names.index(name))
        chunk = -(-x.shape[d] // size)
        start = min(mesh.get_local_rank(name) * chunk, x.shape[d])
        x = x.narrow(d, start, min(chunk, x.shape[d] - start))
    return x


def sharded_output(local: torch.Tensor, mesh: DeviceMesh, dims: dict[str, int],
                   shape) -> DTensor:
    """The ``DTensor`` of global ``shape`` whose block on this rank is
    ``local``, laid out as ``dims``."""
    shape = tuple(int(s) for s in shape)
    stride, acc = [], 1
    for s in reversed(shape):
        stride.append(acc)
        acc *= s
    return DTensor.from_local(local.contiguous(), mesh, placements(mesh, dims), run_check=False,
                              shape=torch.Size(shape), stride=tuple(reversed(stride)))
