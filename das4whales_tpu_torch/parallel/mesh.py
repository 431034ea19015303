"""Device meshes for the sharded DAS pipelines, on ``torch.distributed``
(the port of ``das4whales_tpu.parallel.mesh``).

JAX drives a ``Mesh`` of devices from one process (``shard_map``).
PyTorch's idiom is one process a device, a *rank*, under
``torch.distributed``: this module is the multi-controller port of the
same layout. A :class:`Mesh` names its axes, as JAX's does:

* ``file``    — data parallelism over independent 60 s files;
* ``channel`` — channel parallelism within a file;
* ``time``    — time parallelism over a long record (``parallel.timeshard``).

Every rank builds the same mesh (:func:`make_mesh` is collective: it
creates one process group an axis, through
``torch.distributed.device_mesh.DeviceMesh`` where the mesh spans the
default group) and knows its own coordinates, its device and the
backend. A process that was not launched as a rank gets a mesh of one:
its collectives are identities and need no process group.

The port of ``NamedSharding`` is each rank's LOCAL slice of a global
array: :class:`Sharding` (an axis name or None a dimension, JAX's
``PartitionSpec``) gives this rank's slices, places its slice on its
device (:meth:`Sharding.place`, :func:`shard_block`) and gathers the
whole back (:meth:`Sharding.gather`, :func:`gather_block`).

Two ranks may share one card only over gloo: NCCL refuses two ranks on
one device ("Duplicate GPU detected"). :func:`make_mesh` raises for that
layout on any other backend, naming the reason; it never switches the
backend on its own.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Sequence

import numpy as np
import torch

from ..utils.device import resolve_device


class Mesh:
    """One rank's view of a named device mesh.

    ``shape`` maps each axis name to its size (JAX's ``mesh.shape``);
    ``ranks`` is the ``[*shape]`` array of the process-group ranks the
    mesh lays out row-major; ``coords`` this rank's index on each axis;
    ``device`` its ``torch.device``; ``backend`` the process groups'
    backend (None for a mesh of one). ``groups`` holds one process group
    an axis and ``group`` the whole mesh's (None for a mesh of one, and
    for an axis of size one where the mesh is one rank)."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int], ranks: np.ndarray,
                 rank: int, device: torch.device, backend: str | None,
                 groups: Dict[str, object] | None = None, group=None, device_mesh=None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.ranks = np.asarray(ranks).reshape(tuple(self.shape.values()))
        self.rank = int(rank)
        where = np.argwhere(self.ranks == self.rank)
        if len(where) != 1:
            raise ValueError(f"rank {rank} is not on the mesh {self.ranks.tolist()}")
        self.coords = dict(zip(self.axis_names, (int(i) for i in where[0])))
        self.device = device
        self.backend = backend
        self.groups = dict(groups or {})
        self.group = group
        self.device_mesh = device_mesh

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    def axis_index(self, axis: str) -> int:
        return self.coords[axis]

    def axis_ranks(self, axis: str) -> list:
        """The process-group ranks along ``axis`` through this rank, in
        axis order."""
        idx = [self.coords[a] if a != axis else slice(None) for a in self.axis_names]
        return [int(r) for r in self.ranks[tuple(idx)]]

    def global_rank(self, rank: int) -> int:
        """The default group's rank of this mesh's process-group ``rank``
        (they differ where the mesh was built on a subgroup)."""
        if self.group is None:
            return rank
        import torch.distributed as dist

        return dist.get_global_rank(self.group, rank)

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, coords={self.coords}, "
                f"device={self.device}, backend={self.backend})")


def _world(group) -> tuple:
    """``(initialized, world size, rank)`` of ``group`` (default: the
    default group)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        if group is not None:
            raise ValueError("a process group was given but torch.distributed is not initialized")
        return False, 1, 0
    return True, dist.get_world_size(group), dist.get_rank(group)


def _device_label(d) -> str:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return str(dev)


def _shared_card(where: str) -> ValueError:
    return ValueError(
        f"two ranks on one CUDA device ({where}) need backend 'gloo': NCCL refuses two "
        "ranks on one device ('Duplicate GPU detected'); pass backend='gloo'"
    )


def _default_device(rank: int, backend: str | None, world: int) -> torch.device:
    """A rank's card when ``devices`` is not given: torchrun's
    ``LOCAL_RANK`` over the host's cards (the card of a process that was
    not launched as a rank). Raises without a card, never the CPU. Where
    a group of several ranks has more ranks on a host
    (``LOCAL_WORLD_SIZE``) than the host has cards, two of them share a
    card: allowed over gloo only, else every rank raises here."""
    if not torch.cuda.is_available():
        return resolve_device(None)
    n_cards = torch.cuda.device_count()
    local = int(os.environ.get("LOCAL_RANK", rank))
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", local + 1))
    if world > 1 and backend != "gloo" and max(local + 1, per_host) > n_cards:
        raise _shared_card(f"{max(local + 1, per_host)} ranks on a host of {n_cards} "
                           f"card(s), LOCAL_RANK={local}")
    return resolve_device(f"cuda:{local % n_cards}")


def make_mesh(shape: Sequence[int] | None = None,
              axis_names: Sequence[str] = ("file", "channel"),
              devices=None, backend: str | None = None, group=None) -> Mesh:
    """Build this rank's view of a mesh over the ranks of ``group`` (the
    default group; a process that was not launched as a rank is a world
    of one).

    With ``shape=None`` all ranks go to the *last* axis (pure channel
    parallelism), as in JAX. A shape that does not cover the devices
    raises. ``devices`` lists one device a rank, in rank order (``"cpu"``,
    ``"cuda:0"``; default: each rank's card by ``LOCAL_RANK``).
    ``backend`` is the process groups' backend (default: ``group``'s). A
    mesh of several ranks spans the default group on its backend, one
    process group an axis through ``DeviceMesh``; ``group`` (with
    ``backend``) takes a group of one rank, e.g. a one-rank NCCL group in
    a gloo world. Two ranks on one CUDA device, by ``devices`` or by
    ``LOCAL_RANK``, need ``"gloo"``: any other backend raises, naming the
    reason. Collective: every rank calls it
    with the same arguments, in the same order as its other group
    constructions."""
    axis_names = tuple(axis_names)
    initialized, world, rank = _world(group)
    n = len(devices) if devices is not None else world
    if shape is None:
        shape = (1,) * (len(axis_names) - 1) + (n,)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not match axis names {axis_names}")
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} does not cover {n} devices")
    be = backend
    if be is None and initialized:
        import torch.distributed as dist

        be = dist.get_backend(group)
    labels = None
    if devices is not None:
        labels = [_device_label(d) for d in devices]
        cuda = [d for d in labels if d.startswith("cuda")]
        if len(set(cuda)) < len(cuda) and (be or "nccl") != "gloo":
            raise _shared_card(str(labels))
    if n != world:
        raise ValueError(f"a mesh of {n} devices needs {n} ranks; this group has {world}")
    device = (resolve_device(labels[rank]) if labels is not None
              else _default_device(rank, be, world))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    ranks = np.arange(n).reshape(shape)
    if not initialized:
        return Mesh(axis_names, shape, ranks, 0, device, None)
    import torch.distributed as dist

    if world == 1:
        # a group of one (e.g. a one-rank NCCL group): every axis is it
        return Mesh(axis_names, shape, ranks, rank, device, be,
                    {a: group for a in axis_names}, group=group)
    if group is not None or be != dist.get_backend():
        raise ValueError(
            f"a mesh of {world} ranks spans the default group on its backend "
            f"({dist.get_backend()}); got group={group}, backend={be!r}"
        )
    from torch.distributed.device_mesh import DeviceMesh

    dm = DeviceMesh("cuda" if be == "nccl" else "cpu", torch.as_tensor(ranks),
                    mesh_dim_names=axis_names)
    return Mesh(axis_names, shape, ranks, rank, device, be,
                {a: dm.get_group(a) for a in axis_names}, group=None, device_mesh=dm)


def flat_mesh(mesh: Mesh, axis_name: str) -> Mesh:
    """The ranks of ``mesh`` as a one-axis mesh named ``axis_name``, in
    row-major order (JAX's ``make_mesh(devices=mesh.devices.reshape(-1))``),
    on ``mesh``'s own process groups: the new axis's collectives run over
    the whole mesh's group. Not collective (no group is created)."""
    groups = {} if mesh.backend is None else {axis_name: mesh.group}
    return Mesh((axis_name,), (mesh.size,), mesh.ranks.reshape(-1), mesh.rank, mesh.device,
                mesh.backend, groups, group=mesh.group, device_mesh=None)


@dataclass(frozen=True)
class Sharding:
    """The port of ``NamedSharding(mesh, PartitionSpec(*spec))``: ``spec``
    names, per dimension, the mesh axis it is split over (None: whole on
    every rank; dimensions past the spec are whole). A rank holds the
    contiguous block of its coordinate on each named axis."""

    mesh: Mesh
    spec: tuple = ()

    def slices(self, global_shape: Sequence[int]) -> tuple:
        """This rank's slice of each dimension of ``global_shape``."""
        out = []
        for d, n in enumerate(global_shape):
            ax = self.spec[d] if d < len(self.spec) else None
            if ax is None:
                out.append(slice(0, int(n)))
                continue
            p = self.mesh.axis_size(ax)
            if int(n) % p:
                raise ValueError(f"dimension {d} of {tuple(global_shape)} is not divisible "
                                 f"by mesh axis {ax}={p}")
            w = int(n) // p
            i = self.mesh.axis_index(ax)
            out.append(slice(i * w, (i + 1) * w))
        return tuple(out)

    def global_shape(self, local_shape: Sequence[int]) -> tuple:
        return tuple(int(n) * (self.mesh.axis_size(self.spec[d])
                               if d < len(self.spec) and self.spec[d] is not None else 1)
                     for d, n in enumerate(local_shape))

    def local(self, x):
        """This rank's block of a global host array or tensor (a view)."""
        return x[self.slices(x.shape)]

    def place(self, x, non_blocking: bool = False) -> torch.Tensor:
        """This rank's block of a global array, as a tensor on the mesh's
        device (only the block crosses to it)."""
        blk = self.local(x)
        if isinstance(blk, np.ndarray):
            blk = np.ascontiguousarray(blk)
            blk = torch.from_numpy(blk if blk.flags.writeable else blk.copy())
        return blk.to(self.mesh.device, non_blocking=non_blocking)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global array from every rank's block (collective over the
        whole mesh; every rank gets it, on ``x``'s device)."""
        from . import collectives

        parts = collectives.all_gather(x.contiguous(), self.mesh)
        full = torch.empty(self.global_shape(x.shape), dtype=x.dtype, device=x.device)
        for r, part in enumerate(parts):
            coords = dict(zip(self.mesh.axis_names,
                              (int(i) for i in np.argwhere(self.mesh.ranks == r)[0])))
            idx = []
            for d, n in enumerate(x.shape):
                ax = self.spec[d] if d < len(self.spec) else None
                i = coords[ax] if ax is not None else 0
                idx.append(slice(i * n, (i + 1) * n) if ax is not None else slice(None))
            full[tuple(idx)] = part
        return full


def channel_sharding(mesh: Mesh, channel_axis: str = "channel", ndim: int = 2) -> Sharding:
    """The channel (leading) axis of a ``[channel x time]`` block split
    over ``channel_axis``."""
    spec = [None] * ndim
    spec[0] = channel_axis
    return Sharding(mesh, tuple(spec))


def file_channel_sharding(mesh: Mesh, file_axis: str = "file",
                          channel_axis: str = "channel") -> Sharding:
    """A ``[file x channel x time]`` batch split over both axes."""
    return Sharding(mesh, (file_axis, channel_axis, None))


def replicated(mesh: Mesh) -> Sharding:
    return Sharding(mesh, ())


def shard_block(x, mesh: Mesh, channel_axis: str = "channel") -> torch.Tensor:
    """This rank's channel slice of a global ``[channel x time]`` block,
    on its device."""
    return channel_sharding(mesh, channel_axis, np.ndim(x)).place(x)


def gather_block(x: torch.Tensor, mesh: Mesh, channel_axis: str = "channel",
                 spec: tuple | None = None) -> torch.Tensor:
    """The inverse of :func:`shard_block` (or of any ``spec``'s
    placement): the global block from every rank's slice."""
    if spec is None:
        spec = channel_sharding(mesh, channel_axis, x.ndim).spec
    return Sharding(mesh, tuple(spec)).gather(x)
