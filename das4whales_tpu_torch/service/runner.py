"""Service lifecycle: tenant registry, run loop, drain, resume (the
port's copy of ``das4whales_tpu.service.runner``).

``python -m das4whales_tpu_torch serve tenants.json`` builds a
:class:`DetectionService` from a JSON tenant registry and runs it until
SIGTERM/SIGINT. The registry is the JAX package's, plus ``device``::

    {
      "outdir": "out_service",
      "host": "127.0.0.1", "port": 8080,
      "dispatch_depth": 2, "trace": false, "device": "cuda",
      "tenants": [
        {"name": "array-a", "files": ["day1/*.h5 paths..."],
         "channels": [0, 9000, 1], "batch": 4, "bucket": "pow2",
         "bank": "fin", "hbm_share_gb": 8.0, "weight": 1.0,
         "ring_capacity": 8, "overflow": "reject",
         "realtime_factor": 1.0},
        ...
      ]
    }

``device`` (None or absent: the card) is where every tenant detects;
``"cpu"`` runs the plain versions on the CPU. ``persistent_cache``
(XLA's compile cache in the JAX package) is accepted so a JAX registry
loads unchanged, and does nothing: eager PyTorch compiles no program.

Lifecycle contract:

* **SIGTERM graceful drain** — sources stop, rings close, every
  dispatched-unresolved slab resolves through its own tenant's
  executor, per-tenant counters events flush, and the span trace
  exports to ``<outdir>/trace.json`` (when tracing is on). Files that
  were ingested but never detected simply have no manifest record.
* **crash/drain resume** — on the next start each tenant loads its
  settled set from its own manifest (done + quarantined settle;
  failed/timeout retry) and the replay source skips settled files at
  the source, so nothing re-runs and nothing is lost.
* per-tenant picks are bit-identical to a standalone
  ``run_campaign_batched`` over the same files — the service is the
  same math on the same slabs, scheduled differently.
"""

from __future__ import annotations

import json
import os
import signal
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..telemetry import trace as telemetry
from ..utils.log import get_logger
from .api import ServiceAPI
from .ingest import FileReplaySource
from .scheduler import StreamScheduler, TenantRuntime

log = get_logger("das4whales_tpu_torch.service.runner")


@dataclass
class TenantSpec:
    """One tenant (fiber array × subscriber configuration) in the
    registry. ``files`` is the replay/backfill source (empty for a
    live-ingest-only tenant); ``metadata`` (dict of
    ``config.AcquisitionMetadata`` fields) is required for live ingest
    and optional for replay (probed from the files otherwise)."""

    name: str
    files: List[str] = field(default_factory=list)
    #: explicit manifest/picks directory (default
    #: ``<service outdir>/<name>``): a STABLE directory keeps the
    #: manifest — and with it every ``/picks`` cursor — across a
    #: tenant's migration between service processes.
    outdir: str | None = None
    channels: List[int] | None = None
    batch: int = 4
    bucket: object = "pow2"
    #: detector family this tenant runs ("mf" | "spectro" | "gabor" |
    #: "learned" — ``workflows.campaign.FAMILIES``). Non-MF tenants
    #: require ``wire="conditioned"`` and bucket exactly (coerced, same
    #: rule as ``run_campaign_batched``: padded records would change
    #: their data-dependent thresholds/windows).
    family: str = "mf"
    bank: str | None = None
    wire: str = "conditioned"
    interrogator: str = "optasense"
    engine: str = "h5py"
    metadata: Dict | None = None
    #: DRR weight: 2.0 gets twice the megasample credit per round
    weight: float = 1.0
    #: this tenant's own device-memory admission budget in GiB (None:
    #: the process DAS_HBM_BUDGET_GB) — the preflight prices against it
    hbm_share_gb: float | None = None
    admission: bool = True
    ring_capacity: int = 8
    #: "reject" (full ring -> 429) or "drop_oldest" (evict + count)
    overflow: str = "reject"
    #: freshness SLO target: ``slo_objective`` of this tenant's picks
    #: must settle within ``slo_p95_s`` seconds of ring admission
    #: (None: no SLO evaluated — the latency histogram still records).
    #: Burn rates are evaluated over ``slo_windows`` seconds
    #: (``telemetry.slo``).
    slo_p95_s: float | None = None
    slo_objective: float = 0.95
    slo_windows: List[float] | None = None
    #: replay pacing: 1.0 = real time, 0/None = as fast as the reader
    realtime_factor: float | None = None
    linger_s: float = 0.25
    retry: object = None
    health: object = True
    max_failures: int | None = None
    read_deadline_s: float | None = None
    dispatch_deadline_s: float | None = None
    serial: bool | None = None
    detector_kwargs: Dict = field(default_factory=dict)

    def __post_init__(self):
        if not self.name:
            raise ValueError("tenant name must be non-empty")
        from ..workflows.campaign import FAMILIES

        if self.family not in FAMILIES:
            raise ValueError(
                f"tenant {self.name!r}: unknown detector family "
                f"{self.family!r}; expected one of {FAMILIES}"
            )
        if self.family != "mf":
            if self.wire != "conditioned":
                raise ValueError(
                    f"tenant {self.name!r}: family={self.family!r} requires "
                    "wire='conditioned' (the family's prefilter consumes "
                    f"strain, not stored-dtype counts; got {self.wire!r})"
                )
            if self.bank is not None:
                raise ValueError(
                    f"tenant {self.name!r}: 'bank' is a matched-filter "
                    f"template grid; family={self.family!r} takes its "
                    "configuration through detector_kwargs"
                )
            if self.bucket != "exact":
                # the run_campaign_batched rule: non-MF families are not
                # padding-invariant (data-dependent thresholds/windows)
                log.info("tenant %s: family=%s buckets exactly (overriding "
                         "bucket=%r)", self.name, self.family, self.bucket)
                self.bucket = "exact"
        if self.dispatch_deadline_s is None:
            from ..config import dispatch_deadline_default

            self.dispatch_deadline_s = dispatch_deadline_default()

    def slo_policy(self):
        """The tenant's :class:`telemetry.slo.SLOPolicy`, or None when
        no ``slo_p95_s`` target is configured."""
        if self.slo_p95_s is None:
            return None
        from ..telemetry import slo as slo_mod

        windows = (tuple(float(w) for w in self.slo_windows)
                   if self.slo_windows else slo_mod.DEFAULT_WINDOWS)
        return slo_mod.SLOPolicy(
            target_s=float(self.slo_p95_s),
            objective=float(self.slo_objective), windows=windows,
        )

    def live_metadata(self):
        """Metadata for live-ingested blocks (the HTTP feed carries
        samples, not headers)."""
        if self.metadata is None:
            return None
        from ..config import as_metadata

        return as_metadata(self.metadata)


@dataclass
class ServiceConfig:
    tenants: List[TenantSpec]
    outdir: str = "out_service"
    host: str = "127.0.0.1"
    #: 0 binds an ephemeral port (tests); the bound port is
    #: ``DetectionService.api.port``
    port: int = 0
    dispatch_depth: int | None = None
    trace: bool | None = None
    #: arm the cost observatory (``telemetry.costs``) for this service
    #: process: None defers to ``DAS_COST_CARDS``; True enables — cost
    #: cards, live roofline fractions and ``cost_cards.json`` at drain
    cost_cards: bool | None = None
    #: arm the science-quality observatory (``telemetry.quality``):
    #: None defers to ``DAS_QUALITY``; True enables — pick stream/SNR/
    #: health telemetry, per-tenant drift baselines, ``GET /quality``
    #: rows, and ``quality.json`` at drain. Drift never touches
    #: readiness, scheduling, or picks
    quality: bool | None = None
    resume: bool = True
    #: accepted for the JAX registry and inert (module docstring)
    persistent_cache: bool | str = True
    #: where every tenant detects (None: the card; "cpu": the CPU)
    device: str | None = None


_TENANT_KEYS = {f.name for f in TenantSpec.__dataclass_fields__.values()}


def load_service_config(path: str) -> ServiceConfig:
    """Parse a JSON tenant registry into a :class:`ServiceConfig`
    (unknown keys fail loudly — a typo'd knob must not silently run
    with the default)."""
    with open(path) as fh:
        raw = json.load(fh)
    tenants = []
    for t in raw.get("tenants", []):
        unknown = set(t) - _TENANT_KEYS
        if unknown:
            raise ValueError(
                f"unknown tenant keys {sorted(unknown)} for "
                f"{t.get('name', '?')!r}; known: {sorted(_TENANT_KEYS)}"
            )
        tenants.append(TenantSpec(**t))
    if not tenants and not raw.get("allow_empty"):
        # a spare service starts empty on purpose and receives its
        # tenants via POST /adopt — it opts in explicitly
        raise ValueError(f"{path}: no tenants configured")
    known = {"tenants", "outdir", "host", "port", "dispatch_depth", "trace",
             "cost_cards", "quality", "resume", "persistent_cache",
             "allow_empty", "device"}
    unknown = set(raw) - known
    if unknown:
        raise ValueError(f"unknown service keys {sorted(unknown)}; "
                         f"known: {sorted(known)}")
    return ServiceConfig(
        tenants=tenants, outdir=raw.get("outdir", "out_service"),
        host=raw.get("host", "127.0.0.1"), port=int(raw.get("port", 0)),
        dispatch_depth=raw.get("dispatch_depth"),
        trace=raw.get("trace"), cost_cards=raw.get("cost_cards"),
        quality=raw.get("quality"),
        resume=bool(raw.get("resume", True)),
        persistent_cache=raw.get("persistent_cache", True),
        device=raw.get("device"),
    )


class DetectionService:
    """The persistent process: N tenants, one scheduler, one API.

    ``fault_plans`` maps tenant name -> ``faults.FaultPlan`` (the chaos
    harness, per tenant — tests only). Start with :meth:`start` (API +
    sources), run the scheduler with :meth:`run`; :meth:`request_stop`
    (the SIGTERM handler) begins the graceful drain.
    """

    def __init__(self, config: ServiceConfig, fault_plans=None):
        from ..utils.device import resolve_device

        self.config = config
        # before any file is read: a service without its card refuses
        self.device = resolve_device(config.device)
        os.makedirs(config.outdir, exist_ok=True)
        # the cost/quality observatories are process switches (their
        # consumers — dispatch brackets, scheduler resolves — read the
        # module flags): a service that asks for them turns them on for
        # its serving lifetime, and restores whatever it flipped at
        # stop() — the process may outlive the service (embedded/test
        # use), and a later campaign must not inherit this service's
        # switches
        self._restore_switches: list = []
        if config.cost_cards:
            from ..telemetry import costs as tcosts

            if not tcosts.enabled():
                self._restore_switches.append(tcosts.disable)
            tcosts.enable()
        if config.quality:
            # the enable must precede the tenant loop: TenantRuntime
            # reads the module flag at construction below
            from ..telemetry import quality as tquality

            if not tquality.enabled():
                self._restore_switches.append(tquality.disable)
            tquality.enable()
        fault_plans = fault_plans or {}
        self.tenants: Dict[str, TenantRuntime] = {}
        self.sources: Dict[str, FileReplaySource] = {}
        for spec in config.tenants:
            t = TenantRuntime(
                spec, spec.outdir or os.path.join(config.outdir, spec.name),
                resume=config.resume, fault_plan=fault_plans.get(spec.name),
                device=self.device,
            )
            self.tenants[spec.name] = t
            files = t.replay_files()
            if files:
                self.sources[spec.name] = FileReplaySource(
                    t.ring, files, spec.channels, spec.metadata,
                    interrogator=spec.interrogator, engine=spec.engine,
                    wire=spec.wire,
                    realtime_factor=spec.realtime_factor,
                    read_deadline_s=spec.read_deadline_s,
                    fault_plan=fault_plans.get(spec.name),
                )
            elif spec.files:
                # replay tenant with every file already settled: nothing
                # will ever arrive — close the ring so until_idle runs
                # (and the resume drill) terminate
                t.ring.close()
            # tenants with NO files configured are live-only: their ring
            # stays open for HTTP ingest until drain
        self.scheduler = StreamScheduler(self.tenants.values(),
                                         dispatch_depth=config.dispatch_depth)
        self.api = ServiceAPI(self, host=config.host, port=config.port)
        self._stop = threading.Event()
        self._drained = threading.Event()
        self._started = False
        # brackets tenant-registry mutation from HTTP admin verbs
        # (/drain, /adopt): two concurrent adopts of the same name must
        # serialize through the registry check
        self._admin_lock = threading.Lock()

    # -- the API's view ----------------------------------------------------

    def tenant(self, name: str) -> Optional[TenantRuntime]:
        return self.tenants.get(name)

    def snapshot(self) -> Dict:
        from ..telemetry import probes

        return {
            "outdir": self.config.outdir,
            "draining": self._stop.is_set(),
            "drained": self._drained.is_set(),
            "probes": probes.snapshot(),
            "in_flight_slabs": self.scheduler.pipe.in_flight(),
            # list(...) snapshots the registry: /drain and /adopt mutate
            # it from other HTTP threads
            "tenants": [t.snapshot() for t in list(self.tenants.values())],
        }

    def slo_report(self) -> Dict:
        """The ``/slo`` surface: every tenant's SLO verdict (targets,
        multi-window burn rates, state) plus the burning list the
        ``/readyz`` detail embeds."""
        tenants = [t.slo_snapshot() for t in list(self.tenants.values())]
        return {
            "tenants": tenants,
            "burning": [s["tenant"] for s in tenants
                        if s.get("state") == "burning"],
        }

    def slo_burning(self) -> List[str]:
        return self.slo_report()["burning"]

    def quality_report(self) -> Dict:
        """The ``GET /quality`` surface (``telemetry.quality``): every
        scored tenant's quality row — pick totals, SNR percentiles,
        per-signal drift verdicts — plus the drifting list the
        ``/readyz`` detail embeds. Same records as ``quality.json``, by
        construction (one observatory)."""
        from ..telemetry import quality as tquality

        return tquality.OBSERVATORY.snapshot(tenants=list(self.tenants))

    def quality_drifting(self) -> List[str]:
        """The drifting names alone — ``/readyz`` polls this, so it
        reads one flag per tenant instead of building the full
        snapshot (SNR-tail sorts and all) per probe."""
        from ..telemetry import quality as tquality

        return tquality.OBSERVATORY.drifting_tenants(list(self.tenants))

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "DetectionService":
        from ..telemetry import probes

        # a service start is a new serving lifetime: the probe streaks
        # describe THIS process-as-a-service, not whatever batch
        # campaigns ran in the process before (in production the two
        # coincide; embedded/tests they need not) — a freshly started
        # service must answer /livez healthy until ITS dispatches say
        # otherwise
        probes.reset()
        self.api.start()
        with self._admin_lock:
            self._started = True
            sources = list(self.sources.values())
        for src in sources:
            src.start()
        log.info("service up: %d tenant(s), api %s",
                 len(self.tenants), self.api.url)
        return self

    def request_stop(self) -> None:
        """Begin the graceful drain (idempotent; the SIGTERM handler).
        Sources stop, rings close (new ingest answers 429 'draining');
        the run loop finishes in-flight slabs and exits."""
        if self._stop.is_set():
            return
        log.info("drain requested: stopping sources, closing rings")
        self._stop.set()
        with self._admin_lock:
            sources = list(self.sources.values())
            tenants = list(self.tenants.values())
        for src in sources:
            src.stop()
        for t in tenants:
            t.ring.close()

    def run(self, until_idle: bool = True) -> Dict:
        """The scheduler loop, on the caller's thread, inside the trace
        harness. ``until_idle=True`` (replay/backfill) returns
        once every source is exhausted and resolved; ``False`` (serve)
        runs until :meth:`request_stop`. Either way the exit path IS
        the drain: in-flight slabs resolve, tallies flush, the trace
        exports to ``<outdir>/trace.json``."""
        with telemetry.campaign_trace(
            self.config.outdir, self.config.trace, kind="service",
            n_tenants=len(self.tenants),
        ):
            try:
                self.scheduler.run_until_idle(should_stop=self._stop.is_set)
                if not until_idle:
                    # serve mode: stay up past idle (a live tenant's next
                    # HTTP push re-fills its ring) until a drain is
                    # requested
                    while not self._stop.is_set():
                        self._stop.wait(0.05)
                        self.scheduler.run_until_idle(
                            should_stop=self._stop.is_set
                        )
            finally:
                # the drain half that must happen on EVERY exit path:
                # finish in-flight slabs, flush per-tenant counters
                self.scheduler.drain()
                for t in list(self.tenants.values()):
                    t.finish()
                from ..telemetry import costs as tcosts

                if tcosts.enabled() and tcosts.REGISTRY.cards():
                    try:
                        tcosts.export_json(os.path.join(
                            self.config.outdir, "cost_cards.json"))
                    except OSError:
                        pass   # the drain outcome wins
                from ..telemetry import quality as tquality

                if tquality.enabled():
                    try:
                        # the quality observatory's durable artifact,
                        # next to cost_cards.json
                        tquality.export_json(
                            os.path.join(self.config.outdir,
                                         "quality.json"),
                            tenants=list(self.tenants),
                        )
                    except Exception:  # noqa: BLE001 — decorative export:
                        # the drain outcome (and _drained below) wins,
                        # same hardening as the campaign's _flush_quality
                        log.debug("quality export failed at drain",
                                  exc_info=True)
                self._drained.set()
        return {name: t.result() for name, t in list(self.tenants.items())}

    # -- admin verbs: the two sides of one migration -----------------------

    def drain_tenant(self, name: str, timeout_s: float = 30.0) -> Dict:
        """Gracefully drain ONE tenant (migration's sending verb, the
        ``POST /drain/<tenant>`` body). Its source stops and its ring
        closes (new ingest answers 429), buffered work resolves through
        the scheduler, the counters event and ``cost_card.json`` flush,
        and the settled manifest is left complete on disk — then the
        tenant leaves the rotation. Returns its final counts + outdir
        (everything the adopting worker needs)."""
        import time

        with self._admin_lock:
            t = self.tenants.get(name)
            if t is None:
                raise KeyError(name)
            src = self.sources.pop(name, None)
        if src is not None:
            src.stop()
        t.ring.close()
        done = threading.Event()
        self.scheduler.retire_when_idle(name, done)
        deadline = time.monotonic() + timeout_s
        while not done.wait(0.05):
            if self._drained.is_set():
                break   # the run loop's own drain already finished it
            if time.monotonic() >= deadline:
                raise TimeoutError(
                    f"tenant {name!r} did not drain within {timeout_s:.0f}s"
                )
        with self._admin_lock:
            self.tenants.pop(name, None)
        res = t.result()
        return {
            "tenant": name, "outdir": t.outdir,
            "n_done": res.n_done, "n_failed": res.n_failed,
            "n_skipped": res.n_skipped,
            "n_quarantined": res.n_quarantined, "n_timeout": res.n_timeout,
        }

    def adopt_tenant(self, spec, outdir: str | None = None,
                     fault_plan=None) -> Dict:
        """Adopt a tenant from an existing outdir (migration's
        receiving verb, the ``POST /adopt`` body). ``spec`` is a
        :class:`TenantSpec` or registry dict. The outdir gets an
        EXPLICIT ``fsck.startup_check`` before the runtime touches it —
        a dead worker's directory must prove itself safe to resume —
        then the tenant joins the scheduler rotation and its un-settled
        files start replaying (settled ones skip at the source, so
        nothing re-runs: exactly the crash-resume semantics)."""
        from .. import fsck

        if isinstance(spec, dict):
            unknown = set(spec) - _TENANT_KEYS
            if unknown:
                raise ValueError(
                    f"unknown tenant keys {sorted(unknown)} for "
                    f"{spec.get('name', '?')!r}; known: "
                    f"{sorted(_TENANT_KEYS)}"
                )
            spec = TenantSpec(**spec)
        outdir = (outdir or spec.outdir
                  or os.path.join(self.config.outdir, spec.name))
        os.makedirs(outdir, exist_ok=True)
        fsck.startup_check(outdir, label=f"adopt {spec.name}")
        with self._admin_lock:
            if spec.name in self.tenants:
                raise ValueError(
                    f"tenant {spec.name!r} already registered")
            t = TenantRuntime(spec, outdir, resume=True,
                              fault_plan=fault_plan, device=self.device)
            self.tenants[spec.name] = t
            files = t.replay_files()
            if files:
                src = FileReplaySource(
                    t.ring, files, spec.channels, spec.metadata,
                    interrogator=spec.interrogator, engine=spec.engine,
                    wire=spec.wire, realtime_factor=spec.realtime_factor,
                    read_deadline_s=spec.read_deadline_s,
                    fault_plan=fault_plan,
                )
                self.sources[spec.name] = src
                if self._started:
                    src.start()
            elif spec.files:
                # every file already settled elsewhere: close the ring
                # so idle checks (and until_idle runs) terminate
                t.ring.close()
        self.scheduler.add_tenant(t)
        return {"tenant": spec.name, "outdir": outdir,
                "pending": len(files), "settled": len(t.settled)}

    def stop(self) -> None:
        """Tear down the API server (after :meth:`run` returned) and
        restore any observatory process-switch this service flipped on
        at construction (end of the serving lifetime)."""
        self.api.stop()
        for restore in self._restore_switches:
            restore()
        self._restore_switches = []

    def results(self) -> Dict:
        return {name: t.result() for name, t in list(self.tenants.items())}


def serve(config: ServiceConfig | str, until_idle: bool = False,
          install_signal_handlers: bool = True) -> Dict:
    """Run a service to completion: the ``python -m das4whales_tpu_torch
    serve`` body. SIGTERM/SIGINT trigger the graceful drain."""
    if isinstance(config, str):
        config = load_service_config(config)
    svc = DetectionService(config)
    if install_signal_handlers:
        def _handler(signum, _frame):
            log.info("signal %d: draining", signum)
            svc.request_stop()

        signal.signal(signal.SIGTERM, _handler)
        signal.signal(signal.SIGINT, _handler)
    svc.start()
    try:
        return svc.run(until_idle=until_idle)
    finally:
        svc.stop()
