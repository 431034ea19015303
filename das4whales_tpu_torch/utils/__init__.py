"""Cross-cutting utilities: audio export, profiling and progress,
logging, design checkpointing; by path, device resolution
(``device``), the kernel build (``build``) and the memory preflight
(``memory``)."""

from . import artifacts, audio, checkpoint, locks, log, profiling, views  # noqa: F401
from .artifacts import append_record, atomic_bytes, atomic_json, read_records  # noqa: F401
from .audio import export_audio, read_audio  # noqa: F401
from .checkpoint import load_design, register_design, save_design  # noqa: F401
from .log import get_logger, log_metadata  # noqa: F401
from ..telemetry.progress import progress  # noqa: F401
from .profiling import StageTimer, annotate, block_and_time, device_trace  # noqa: F401
