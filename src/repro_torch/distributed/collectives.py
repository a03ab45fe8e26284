"""Meshes and collectives over ``torch.distributed`` (the port's own
module: the reference's ``shard_map`` bodies name mesh axes, and this is
what an axis name means here).

The reference's ``shard_map`` is one program over every device.  The
port runs one process a rank (SPMD), each calling a function on its own
shards with explicit collectives:

  * a mesh is PyTorch's :class:`~torch.distributed.device_mesh.DeviceMesh`
    (:func:`init_mesh`), over NCCL on ``cuda`` and gloo on ``cpu``;
  * a collective over a mesh axis runs on ``mesh.get_group(axis)``; over
    a tuple of axes, on each axis in turn (a sum over ``data`` then over
    ``model`` is the sum over both), so no group other than the mesh's
    own is ever made;
  * :func:`local_shard` and :func:`gather` stand for the reference
    scripts' ``device_put(x, NamedSharding(mesh, spec))`` and
    ``device_get``: the rank's block of a global tensor by a
    :class:`~repro_torch.distributed.sharding.P`, and the global tensor
    back from every rank's block.

Autograd: :func:`all_to_all`'s backward is the reverse exchange; the
backward of :func:`psum` sums the cotangents over the same axes and
:func:`pmean`'s averages them.  That is ``torch.distributed.nn``'s
convention: the objective is the sum of every rank's own loss, and each
rank differentiates its own, as under DDP.  :func:`gather` is not
differentiable.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as fcoll

from repro_torch.device import resolve_device


def init_mesh(shape, axes, device: str | torch.device | None = None, *,
              rank: int | None = None, store: str | None = None):
    """A :class:`DeviceMesh` of ``shape`` with axis names ``axes`` over
    the process group's ranks in row-major order, on ``device``'s type
    (the card unless the caller names another; NCCL on ``cuda``, gloo on
    ``cpu``).

    With no process group yet, ``rank`` and ``store`` (a path for a
    ``file://`` store, no network) bring one up of world size
    ``prod(shape)``; otherwise the running one is used.  On ``cuda``
    each rank takes card ``rank % device_count``."""
    dev = resolve_device(device)
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    if not dist.is_initialized():
        if rank is None or store is None:
            raise RuntimeError("no process group: pass rank= and store= "
                               "(or call torch.distributed."
                               "init_process_group first)")
        if dev.type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            init_method=f"file://{store}", rank=rank,
            world_size=math.prod(shape))
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def axis_names(mesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def axis_size(mesh, axis) -> int:
    """The ranks along ``axis`` (a name or a tuple of names)."""
    sizes = dict(zip(axis_names(mesh), mesh.shape))
    return math.prod(sizes[a] for a in _axes(axis))


def _axes(axis) -> tuple[str, ...]:
    return tuple(axis) if isinstance(axis, tuple) else (axis,)


def _all_reduce(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    for a in _axes(axes):
        x = fcoll.wait_tensor(fcoll.all_reduce(x, "sum", mesh.get_group(a)))
    return x


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return _all_reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous(), ctx.mesh, ctx.axes), None, None


def psum(x: torch.Tensor, axis, mesh) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis`` (a name or a tuple of
    names), on every one of them (``jax.lax.psum``)."""
    return _Psum.apply(x.contiguous(), mesh, _axes(axis))


def pmean(x: torch.Tensor, axis, mesh) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``axis`` (``jax.lax.pmean``)."""
    return psum(x, axis, mesh) / axis_size(mesh, axis)


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    return fcoll.wait_tensor(fcoll.all_to_all_single(
        x.contiguous(), None, None, group))


class AllToAll(torch.autograd.Function):
    """The tiled all-to-all on dimension 0 over one process group: block
    ``i`` of ``x`` (``x.shape[0] / n`` rows) goes to rank ``i``, and block
    ``j`` of the result came from rank ``j``.  The exchange is its own
    inverse, so the backward sends each cotangent block back to where its
    row came from by the same exchange."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.group), None


def all_to_all(x: torch.Tensor, axis: str, mesh) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_axis=0, concat_axis=0,
    tiled=True)`` over one mesh axis; ``x.shape[0]`` must divide by the
    axis size."""
    n = axis_size(mesh, axis)
    if x.shape[0] % n:
        raise ValueError(f"all_to_all over {axis!r} ({n} ranks): dimension "
                         f"0 of {tuple(x.shape)} does not divide")
    return AllToAll.apply(x, mesh.get_group(axis))


def _block(mesh, axes) -> tuple[int, int]:
    """(this rank's block index, block count) along a spec entry: the
    row-major coordinate over ``axes`` in the mesh's own order."""
    names = axis_names(mesh)
    if list(axes) != sorted(axes, key=names.index):
        raise ValueError(f"spec axes {axes} are not in the mesh's order "
                         f"{names}")
    coord = mesh.get_coordinate()
    if coord is None:
        raise RuntimeError("this rank is not part of the mesh")
    idx, n = 0, 1
    for a in axes:
        i = names.index(a)
        idx, n = idx * mesh.shape[i] + coord[i], n * mesh.shape[i]
    return idx, n


def local_shard(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    """This rank's block of the global tensor ``x`` under ``spec`` (per
    dimension ``None``, an axis or a tuple of axes, major first): the
    twin of ``device_put(x, NamedSharding(mesh, spec))`` as one device
    sees it.  A view; each sharded dimension must divide evenly."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        idx, n = _block(mesh, _axes(entry))
        if x.shape[dim] % n:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not "
                             f"divide over {entry!r} ({n} ranks)")
        step = x.shape[dim] // n
        x = x.narrow(dim, idx * step, step)
    return x


def gather(x_local: torch.Tensor, mesh, spec) -> torch.Tensor:
    """The global tensor from every rank's :func:`local_shard` block
    (``device_get``); on every rank of the mesh."""
    x = x_local.detach().contiguous()
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        _block(mesh, _axes(entry))  # checks the axes' order
        for a in reversed(_axes(entry)):  # the minor axis first
            parts = [torch.empty_like(x) for _ in range(axis_size(mesh, a))]
            dist.all_gather(parts, x, group=mesh.get_group(a))
            x = torch.cat(parts, dim)
    return x


def barrier(mesh) -> None:
    """Every rank of the mesh has reached this point (a barrier over
    each axis in turn)."""
    for a in axis_names(mesh):
        dist.barrier(group=mesh.get_group(a))
