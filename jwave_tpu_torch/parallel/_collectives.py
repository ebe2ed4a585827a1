"""The collectives of the sharded layer, each on one mesh axis's process
group, with the JAX package's semantics (``lax.all_to_all``, ``ppermute``,
``all_gather``, ``psum``/``pmax``, ``axis_index``).

Complex tensors travel as ``torch.view_as_real`` (NCCL takes no complex
type). Every function calls ``torch.distributed`` through its module
attribute, so a spy on ``dist.<name>`` sees each call; a one-rank axis
still goes through the backend, except the ring shift, which
``torch.distributed`` refuses to one's own rank and which is then the
identity.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """``mesh.shape[axis]`` of a JAX mesh."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """``lax.axis_index(axis)``: this rank's coordinate along ``axis``."""
    return mesh.get_local_rank(axis)


def _wire(x: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(x) if x.is_complex() else x


def _exchange(chunks: torch.Tensor, group) -> torch.Tensor:
    """(D, ...) contiguous: chunk i goes to group rank i; returns (D, ...)
    with the chunk received from group rank j at j."""
    out = torch.empty_like(chunks)
    dist.all_to_all_single(_wire(out), _wire(chunks), group=group)
    return out


def all_to_all(x: torch.Tensor, mesh: DeviceMesh, axis: str, split_axis: int, concat_axis: int,
               tiled: bool = False) -> torch.Tensor:
    """``lax.all_to_all``. Untiled: ``x``'s ``split_axis`` has size D (the
    axis's ranks); it is removed and an axis of size D, indexed by the
    source rank, is inserted at ``concat_axis``. Tiled: ``split_axis`` is
    cut into D chunks, chunk i goes to rank i, and the received chunks are
    concatenated along ``concat_axis`` in rank order."""
    d = axis_size(mesh, axis)
    split_axis %= x.dim()
    if tiled:
        chunks = x.unflatten(split_axis, (d, -1)).movedim(split_axis, 0).contiguous()
        out = _exchange(chunks, mesh.get_group(axis))
        concat_axis %= x.dim()
        return out.movedim(0, concat_axis).flatten(concat_axis, concat_axis + 1)
    out = _exchange(x.movedim(split_axis, 0).contiguous(), mesh.get_group(axis))
    return out.movedim(0, concat_axis % x.dim())


def ring_shift(x: torch.Tensor, mesh: DeviceMesh, axis: str, offset: int) -> torch.Tensor:
    """``lax.ppermute`` with the permutation ``i -> (i + offset) mod D``: each
    rank sends ``x`` ``offset`` steps along the ring and returns what its
    ``-offset`` neighbour sent. Peers are named by their global ranks."""
    d = axis_size(mesh, axis)
    if d == 1:
        return x
    group = mesh.get_group(axis)
    me = axis_index(mesh, axis)
    send = _wire(x.contiguous())
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dist.get_global_rank(group, (me + offset) % d), group),
           dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, (me - offset) % d), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return torch.view_as_complex(recv) if x.is_complex() else recv


def all_gather(x: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int) -> torch.Tensor:
    """``lax.all_gather(..., tiled=True)``: the ranks' blocks concatenated
    along ``dim`` in rank order."""
    dim %= x.dim()
    part = x.movedim(dim, 0).contiguous()
    out = torch.empty((axis_size(mesh, axis) * part.shape[0],) + part.shape[1:],
                      dtype=x.dtype, device=x.device)
    # torch 2.13 names it all_gather_single and deprecates the older name
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(_wire(out), _wire(part), group=mesh.get_group(axis))
    return out.movedim(0, dim)


def psum(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """``lax.psum``: the elementwise sum over the axis's ranks."""
    out = x.clone()
    dist.all_reduce(_wire(out), op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    return out


def pmax(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """``lax.pmax`` of a real tensor."""
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=mesh.get_group(axis))
    return out
