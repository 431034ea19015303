"""Collectives over a :class:`~.mesh.Mesh` axis (the counterparts of the
``jax.lax`` collectives the JAX package's ``shard_map`` bodies call).

* :func:`all_to_all` — ``jax.lax.all_to_all(..., tiled=True)``: split
  ``split_axis`` into one block a rank, send block ``j`` to rank ``j``,
  concatenate the received blocks on ``concat_axis`` in rank order. On
  ``dist.all_to_all_single``, which splits and concatenates dim 0 only:
  the axes are moved and the tensor made contiguous before and after.
* :func:`ppermute` — ``jax.lax.ppermute``: ``(source, destination)``
  pairs of axis indices; a rank that receives nothing gets zeros. On
  ``dist.batch_isend_irecv``.
* :func:`psum`, :func:`pmax`, :func:`pmin` — ``all_reduce`` over one axis
  (or, with ``axis=None``, the whole mesh).
* :func:`axis_index`, :func:`axis_size`; :func:`all_gather` and
  :func:`all_gather_object` over the whole mesh.

Every rank of the axis calls the same collective in the same order; a
collective inside a branch that only some ranks take deadlocks the mesh.
On a mesh of one rank (no process group, or a group of one such as a
one-rank NCCL group) every collective is an identity and nothing is
sent, as is a collective over an axis of size one on a larger mesh.

**Backends.** With NCCL the tensors stay on the card. With gloo a CUDA
tensor is copied to pinned host memory, reduced or exchanged there and
copied back, explicitly: gloo's support for CUDA tensors differs by
collective and by version. Complex tensors travel as their real view.
:data:`STATS` counts each collective's calls, bytes sent and, on gloo,
the bytes staged through the host; with :func:`timing` on (the smoke's
measurement) it also keeps each one's wall and the staging share of it,
synchronizing the card around every call. A collective that fails — a
peer that died, or the process group's timeout — raises naming the
collective, the axis and this rank.
"""

from __future__ import annotations

import pickle
import time
from contextlib import contextmanager
from typing import Sequence

import torch

from .mesh import Mesh

#: per collective: calls, bytes this rank sent, bytes staged through the
#: host (gloo on a CUDA tensor), and with timing on the wall and the
#: staging seconds
STATS: dict = {}
_TIMING = [False]


def reset_stats() -> None:
    STATS.clear()


def read_stats() -> dict:
    return {k: dict(v) for k, v in STATS.items()}


def timing(on: bool = True) -> None:
    """Keep each collective's wall (synchronizing the card around it)."""
    _TIMING[0] = bool(on)


def _stat(name: str) -> dict:
    return STATS.setdefault(name, {"calls": 0, "bytes": 0, "staged_bytes": 0,
                                   "seconds": 0.0, "stage_seconds": 0.0})


def _sync(x: torch.Tensor) -> None:
    if _TIMING[0] and x.is_cuda:
        torch.cuda.synchronize(x.device)


@contextmanager
def _timed(name: str, ref: torch.Tensor, axis):
    st = _stat(name)
    st["calls"] += 1
    _sync(ref)
    t0 = time.perf_counter()
    try:
        yield st
    except RuntimeError as exc:   # the backends' errors: re-raised with the collective named
        raise RuntimeError(f"mesh collective {name} over axis {axis!r} failed on this "
                           f"rank (a peer rank died, or the process group's timeout "
                           f"passed): {type(exc).__name__}: {exc}") from exc
    _sync(ref)
    st["seconds"] += time.perf_counter() - t0


def _identity(mesh: Mesh, axis) -> bool:
    """No peer to talk to: a mesh of one rank (with or without a process
    group), or an axis of size one."""
    if mesh.backend is None or mesh.size == 1:
        return True
    return axis is not None and mesh.axis_size(axis) == 1


def _group(mesh: Mesh, axis):
    return mesh.group if axis is None else mesh.groups[axis]


def _staged(mesh: Mesh) -> bool:
    return mesh.backend == "gloo"


class _Stage:
    """A tensor as the backend takes it: real, contiguous, and (gloo, a
    CUDA tensor) in pinned host memory."""

    def __init__(self, x: torch.Tensor, mesh: Mesh, st: dict):
        self.src = x
        self.complex = x.is_complex()
        t = torch.view_as_real(x) if self.complex else x
        self.host = _staged(mesh) and t.is_cuda
        self.st = st
        if self.host:
            t0 = time.perf_counter()
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t)
            st["staged_bytes"] += h.numel() * h.element_size()
            st["stage_seconds"] += time.perf_counter() - t0
            t = h
        self.t = t.contiguous()

    def empty(self) -> torch.Tensor:
        if self.host:
            return torch.empty(self.t.shape, dtype=self.t.dtype, pin_memory=True)
        return torch.empty_like(self.t)

    def back(self, t: torch.Tensor) -> torch.Tensor:
        if self.host:
            t0 = time.perf_counter()
            t = t.to(self.src.device)
            self.st["staged_bytes"] += t.numel() * t.element_size()
            self.st["stage_seconds"] += time.perf_counter() - t0
        return torch.view_as_complex(t.contiguous()) if self.complex else t


def axis_index(mesh: Mesh, axis: str) -> int:
    return mesh.axis_index(axis)


def axis_size(mesh: Mesh, axis: str) -> int:
    return mesh.axis_size(axis)


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str, split_axis: int,
               concat_axis: int) -> torch.Tensor:
    """JAX's tiled ``all_to_all`` over ``axis`` (module docstring)."""
    p = mesh.axis_size(axis)
    nd = x.ndim
    split_axis %= nd
    concat_axis %= nd
    if x.shape[split_axis] % p:
        raise ValueError(f"all_to_all: dimension {split_axis} of {tuple(x.shape)} is not "
                         f"divisible by axis {axis}={p}")
    if _identity(mesh, axis):
        return x
    import torch.distributed as dist

    with _timed("all_to_all", x, axis) as st:
        S = x.shape[split_axis]
        y = x.movedim(split_axis, 0)
        y = y.reshape((p, S // p) + tuple(y.shape[1:]))
        stage = _Stage(y, mesh, st)
        out = stage.empty()
        st["bytes"] += stage.t.numel() * stage.t.element_size()
        dist.all_to_all_single(out, stage.t, group=_group(mesh, axis))
        z = stage.back(out)                       # [p, S/p, rest...]: block i from rank i
    z = z.movedim(1, split_axis + 1).movedim(0, concat_axis)
    shape = list(z.shape)
    merged = shape[concat_axis] * shape[concat_axis + 1]
    return z.reshape(shape[:concat_axis] + [merged] + shape[concat_axis + 2:])


def ppermute(x: torch.Tensor, mesh: Mesh, axis: str,
             perm: Sequence[tuple]) -> torch.Tensor:
    """JAX's ``ppermute`` over ``axis``: ``perm`` pairs ``(source,
    destination)`` of axis indices; ranks that receive nothing get
    zeros."""
    me = mesh.axis_index(axis)
    if _identity(mesh, axis):
        for s, d in perm:
            if s == me and d == me:
                return x
        return torch.zeros_like(x)
    import torch.distributed as dist

    line = mesh.axis_ranks(axis)
    with _timed("ppermute", x, axis) as st:
        stage = _Stage(x, mesh, st)
        out = stage.empty()
        out.zero_()
        got = False
        ops = []
        group = _group(mesh, axis)
        for s, d in perm:
            if s == me and d == me:
                out.copy_(stage.t)
                got = True
            elif s == me:
                ops.append(dist.P2POp(dist.isend, stage.t, mesh.global_rank(line[d]), group))
                st["bytes"] += stage.t.numel() * stage.t.element_size()
            elif d == me:
                ops.append(dist.P2POp(dist.irecv, out, mesh.global_rank(line[s]), group))
                got = True
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        res = stage.back(out) if got else torch.zeros_like(x)
    return res


def _all_reduce(x: torch.Tensor, mesh: Mesh, axis, op_name: str) -> torch.Tensor:
    if _identity(mesh, axis):
        return x
    import torch.distributed as dist

    op = {"psum": dist.ReduceOp.SUM, "pmax": dist.ReduceOp.MAX,
          "pmin": dist.ReduceOp.MIN}[op_name]
    with _timed(op_name, x, axis) as st:
        stage = _Stage(x, mesh, st)
        t = stage.t if stage.host else stage.t.clone()
        st["bytes"] += t.numel() * t.element_size()
        dist.all_reduce(t, op=op, group=_group(mesh, axis))
        res = stage.back(t)
    return res


def psum(x: torch.Tensor, mesh: Mesh, axis: str | None) -> torch.Tensor:
    """Sum over ``axis`` (None: the whole mesh)."""
    return _all_reduce(x, mesh, axis, "psum")


def pmax(x: torch.Tensor, mesh: Mesh, axis: str | None) -> torch.Tensor:
    """Max over ``axis`` (None: the whole mesh)."""
    return _all_reduce(x, mesh, axis, "pmax")


def pmin(x: torch.Tensor, mesh: Mesh, axis: str | None) -> torch.Tensor:
    """Min over ``axis`` (None: the whole mesh)."""
    return _all_reduce(x, mesh, axis, "pmin")


def all_gather(x: torch.Tensor, mesh: Mesh) -> list:
    """Every rank's ``x`` (same shape and dtype on every rank), in mesh
    rank order, over the whole mesh."""
    if _identity(mesh, None):
        return [x]
    import torch.distributed as dist

    with _timed("all_gather", x, None) as st:
        stage = _Stage(x, mesh, st)
        outs = [stage.empty() for _ in range(mesh.size)]
        st["bytes"] += stage.t.numel() * stage.t.element_size()
        dist.all_gather(outs, stage.t, group=mesh.group)
        res = [stage.back(o) for o in outs]
    return res


def all_gather_object(obj, mesh: Mesh) -> list:
    """Every rank's picklable ``obj``, in mesh rank order (the packed
    picks and records a campaign gathers: a few kB)."""
    if _identity(mesh, None):
        return [obj]
    import torch.distributed as dist

    out = [None] * mesh.size
    ref = torch.empty(0, device=mesh.device)
    with _timed("all_gather_object", ref, None) as st:
        st["bytes"] += len(pickle.dumps(obj))
        dist.all_gather_object(out, obj, group=mesh.group)
    return out


def barrier(mesh: Mesh) -> None:
    """Wait for every rank of the mesh (a MAX over it)."""
    if _identity(mesh, None):
        return
    pmax(torch.zeros(1, dtype=torch.int32, device=mesh.device), mesh, None)
