"""Self-healing multi-worker serving (the port's copy of
``das4whales_tpu.fleet``).

``supervisor`` owns the control plane — spawn, place, watch and recover
over N shared-nothing ``python -m das4whales_tpu_torch serve`` worker
subprocesses, with a crash-only desired-state ledger; ``router`` is the
tenant-keyed HTTP front door. The control plane computes nothing on a
device: the workers own the card in their own processes.
"""

from .router import FleetRouter  # noqa: F401
from .supervisor import (  # noqa: F401
    FleetConfig,
    FleetSupervisor,
    free_port,
    load_fleet_config,
    settled_files,
)
