"""Streaming multi-tenant detection service (the port's copy of
``das4whales_tpu.service``).

The batch campaigns (``workflows.campaign``) terminate: one call, one
file list, one manifest. This package turns the same machinery into a
PERSISTENT process serving N fiber arrays × M subscribers on one card:

* :mod:`~das4whales_tpu_torch.service.ingest` — bounded per-stream ring
  buffers (drop-oldest or reject backpressure, counted), a file-replay
  source, and the continuous slab slicer that reuses the batch
  campaign's bucket/padding rules bit for bit.
* :mod:`~das4whales_tpu_torch.service.scheduler` — the multi-stream
  generalization of ``parallel.dispatch.PipelinedDispatch``:
  deficit-round-robin across tenants over ONE shared in-flight queue,
  per-tenant memory admission via the preflight, and the downshift
  ladder applied per tenant.
* :mod:`~das4whales_tpu_torch.service.api` — a stdlib-only HTTP
  surface: NDJSON pick streams with cursor resume, ``/metrics``
  (Prometheus), ``/livez``/``/readyz`` (``telemetry.probes``), ``/slo``,
  ``/quality``, and a live-ingest endpoint with explicit 429
  backpressure.
* :mod:`~das4whales_tpu_torch.service.runner` — lifecycle: the
  config-file tenant registry, SIGTERM graceful drain, crash-resume via
  the settled-manifest semantics, trace export.

``python -m das4whales_tpu_torch serve tenants.json`` is the entry
point.
"""

from .ingest import FileReplaySource, IngestItem, RingBuffer, SlabSlicer
from .runner import (
    DetectionService,
    ServiceConfig,
    TenantSpec,
    load_service_config,
)
from .scheduler import StreamScheduler, TenantRuntime

__all__ = [
    "DetectionService", "FileReplaySource", "IngestItem", "RingBuffer",
    "ServiceConfig", "SlabSlicer", "StreamScheduler", "TenantRuntime",
    "TenantSpec", "load_service_config",
]
