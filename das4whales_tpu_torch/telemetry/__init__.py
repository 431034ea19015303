"""Campaign flight recorder: spans, labeled metrics, and probe surfaces
(the port's copy of ``das4whales_tpu.telemetry``).

* :mod:`~das4whales_tpu_torch.telemetry.trace` — host-side span tracing
  with a no-op fast path (``DAS_TRACE`` / ``run_campaign*(trace=)``
  enables), paired with ``torch.profiler.record_function`` on the same
  names so host and device timelines correlate, exported as
  Chrome-trace/Perfetto JSON next to the manifest; span ids are stamped
  into manifest ledger events.
* :mod:`~das4whales_tpu_torch.telemetry.metrics` — a labeled
  counter/gauge/histogram registry with Prometheus text exposition and
  a JSON snapshot; ``faults.counters()`` is a view over it.
* :mod:`~das4whales_tpu_torch.telemetry.probes` — ``liveness()`` /
  ``readiness()`` driven by the dispatch-watchdog, health-quarantine and
  dispatch-progress signals.

Not in this slice: the cost cards (``telemetry/costs.py``), the quality
observatory (``telemetry/quality.py``) and the serving SLOs
(``telemetry/slo.py``) come with the ROADMAP item 'Service and fleet'.

Import discipline: this package (and everything it imports at module
level) is pure stdlib — ``faults`` imports it at package init, and the
disabled-mode fast path must never pay a torch import.
"""

from . import metrics, probes, progress, trace  # noqa: F401
from .metrics import (  # noqa: F401
    REGISTRY,
    counter,
    gauge,
    histogram,
    prometheus_text,
    resilience_counters,
    resilience_delta,
    snapshot,
)
from .probes import liveness, readiness  # noqa: F401
from .progress import progress as progress_bar  # noqa: F401
from .trace import (  # noqa: F401
    campaign_trace,
    current_span_id,
    disable,
    enable,
    enabled,
    export_chrome_trace,
    span,
    timed_best,
)
