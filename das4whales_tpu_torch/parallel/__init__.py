"""Scale-out on ``torch.distributed``: batched slabs on one card, device
meshes, the distributed f-k transform and the sharded detection steps
(the port's copy of ``das4whales_tpu.parallel``; one process a device,
``parallel.mesh``)."""

from . import batch, collectives, dispatch, distributed, fft, mesh, pipeline, timeshard  # noqa: F401
from .batch import BatchedMatchedFilterDetector  # noqa: F401
from .distributed import global_mesh, initialize_from_env  # noqa: F401
from .fft import sharded_fk_apply  # noqa: F401
from .mesh import gather_block, make_mesh, shard_block  # noqa: F401
from .pipeline import make_sharded_mf_step  # noqa: F401
from .timeshard import (  # noqa: F401
    make_sharded_mf_step_time,
    sharded_bp_filt_time,
    sharded_fk_apply_time,
    time_sharding,
)
