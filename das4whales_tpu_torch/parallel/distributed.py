"""Multi-process start-up and global meshes, on ``torch.distributed``
(the port of ``das4whales_tpu.parallel.distributed``).

One process a device (a rank). torchrun's variables form the process
group::

    torchrun --nproc_per_node 4 -m das4whales_tpu_torch campaign --sharded ...
    # or by hand, on every process:
    MASTER_ADDR=host0 MASTER_PORT=29500 WORLD_SIZE=8 RANK=$RANK LOCAL_RANK=$LR \\
        python -m das4whales_tpu_torch campaign --multihost ...

:func:`initialize_from_env` is called first: without the variables (or
with ``WORLD_SIZE=1``) it is a no-op and every mesh is a mesh of one.
The process group's ``timeout`` bounds every collective, so a rank that
dies fails its peers within it instead of hanging them.

:func:`global_mesh` lays the axes out so the file axis is process-major
across hosts (``LOCAL_WORLD_SIZE`` ranks a host; without it each rank is
its own host) and the channel/time axis stays within a host.
"""

from __future__ import annotations

import datetime
import os
from typing import Sequence

import torch

from .mesh import Mesh, make_mesh

#: the variables :func:`initialize_from_env` reads (torchrun's)
ENV_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")

#: the collective timeout :func:`initialize` gave the process group it
#: formed last, in seconds
_TIMEOUT_S: float | None = None


def default_backend() -> str:
    """NCCL with a card, gloo without (the CPU tests). Two ranks that
    share one card pass ``backend="gloo"`` to :func:`initialize` and
    :func:`~.mesh.make_mesh` (``parallel.mesh``)."""
    return "nccl" if torch.cuda.is_available() else "gloo"


def initialize(init_method: str, world_size: int, rank: int, *, backend: str | None = None,
               timeout_s: float = 300.0) -> bool:
    """Form the process group (``dist.init_process_group``) with every
    collective bounded by ``timeout_s``. Returns False when it was
    already formed (idempotent re-entry)."""
    global _TIMEOUT_S
    import torch.distributed as dist

    if dist.is_initialized():
        return False
    dist.init_process_group(backend or default_backend(), init_method=init_method,
                            world_size=int(world_size), rank=int(rank),
                            timeout=datetime.timedelta(seconds=float(timeout_s)))
    _TIMEOUT_S = float(timeout_s)
    return True


def collective_timeout_s() -> float:
    """How long a collective of the default process group waits for its
    peers before it raises, in seconds: the ``timeout_s`` :func:`initialize`
    formed it with, else the timeout the backend reports, else torch's
    default."""
    import torch.distributed as dist

    if _TIMEOUT_S is not None:
        return _TIMEOUT_S
    try:  # a group formed outside initialize(): its backend's own setting
        opts = dist.group.WORLD._get_backend(torch.device("cpu")).options
        return float(opts._timeout.total_seconds())
    except Exception:  # noqa: BLE001 — no such accessor on this torch or backend
        return float(dist.default_pg_timeout.total_seconds())


def initialize_from_env(timeout_s: int = 300) -> bool:
    """Form the multi-process group from torchrun's variables, if set.

    Reads ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` (and
    ``LOCAL_RANK`` for the card, ``parallel.mesh``). Returns True when a
    multi-process group was formed; False when the variables are absent
    or ``WORLD_SIZE`` is 1 (no-op), or when the group already exists
    (idempotent re-entry). A world of several without ``RANK`` raises: a
    rank defaulting to 0 would collide with the real rank 0 and hang the
    launch until the timeout."""
    nproc = int(os.environ.get("WORLD_SIZE", "1"))
    if nproc <= 1 or not os.environ.get("MASTER_ADDR"):
        return False
    rank = os.environ.get("RANK")
    if rank is None:
        raise ValueError(
            "WORLD_SIZE > 1 but RANK is not set; export a distinct rank "
            "(0..N-1) on every process (torchrun sets it)"
        )
    if not os.environ.get("MASTER_PORT"):
        raise ValueError("WORLD_SIZE > 1 but MASTER_PORT is not set")
    return initialize("env://", nproc, int(rank), timeout_s=timeout_s)


def _layout() -> tuple:
    """``(world, rank, ranks a host)``."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return 1, 0, 1
    world, rank = dist.get_world_size(), dist.get_rank()
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    if local < 1 or world % local:
        raise ValueError(f"LOCAL_WORLD_SIZE={local} does not divide the world of {world}")
    return world, rank, local


def process_count() -> int:
    """Hosts in the world (JAX's ``process_count``): ``WORLD_SIZE /
    LOCAL_WORLD_SIZE``."""
    world, _, local = _layout()
    return world // local


def process_index() -> int:
    """This rank's host (JAX's ``process_index``)."""
    _, rank, local = _layout()
    return rank // local


def global_mesh(axis_names: Sequence[str] = ("file", "channel"),
                files_per_host: int | None = None, devices=None) -> Mesh:
    """The mesh over every rank, laid out so the FIRST (file) axis is
    process-major across hosts and the LAST (channel/time) axis stays
    within a host: with ``files_per_host=None`` one file shard a host. A
    world of one is a mesh of one."""
    world, _, _ = _layout()
    n_files = process_count() * (1 if files_per_host is None else int(files_per_host))
    if world % n_files:
        raise ValueError(f"{world} ranks not divisible into {n_files} file shards")
    return make_mesh((n_files, world // n_files), axis_names, devices=devices)


def local_device_batch(n_files_global: int) -> slice:
    """This host's slice of a ``[file, ...]`` global batch: the file
    indices it reads (:func:`global_mesh`'s process-major file axis)."""
    n_proc = process_count()
    if n_files_global % n_proc:
        raise ValueError(
            f"{n_files_global} files not divisible over {n_proc} processes; "
            "pad the batch (io.stream tail policies) or adjust files_per_host"
        )
    per = n_files_global // n_proc
    start = process_index() * per
    return slice(start, start + per)
