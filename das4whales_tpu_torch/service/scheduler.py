"""Fair multi-stream scheduling over one shared dispatch pipeline (the
port's copy of ``das4whales_tpu.service.scheduler``).

``parallel.dispatch.PipelinedDispatch`` keeps ONE campaign's device
queue non-empty; this module generalizes it to N tenants: every
tenant's slabs ride the same bounded in-flight queue (and the card's one
CUDA stream), interleaved by DEFICIT ROUND-ROBIN, so the copy, compute
and read of *different* tenants' slabs overlap exactly like one
campaign's consecutive slabs do.

Per tenant (:class:`TenantRuntime`), the batch campaign's whole
resilience stack applies independently, through the batch campaign's
own per-slab executor (``workflows.campaign.SlabExecutor``), one a
tenant:

* **admission** — the memory preflight (``utils.memory``) prices every
  candidate ``(bucket, B)`` program against the TENANT's own memory
  share before its first dispatch (after the shared pipe drained, so no
  other tenant's slab in flight is counted), so one tenant's large bank
  pins ITSELF to a leaner rung (or is refused) instead of evicting
  another tenant's steady stream;
* **the downshift ladder, per tenant** — a resource-class failure
  downshifts only the culprit tenant's bucket (sticky, ledgered in that
  tenant's manifest); other tenants stay on their fast rung;
* **classified disposition** — retry/quarantine/timeout/degrade per
  file, through the same ``_Resilience`` machinery, into the same
  per-tenant ``manifest.jsonl`` + ``picks/*.npz`` artifacts the batch
  campaign writes — which is what makes service picks bit-identical to
  each tenant's standalone ``run_campaign_batched`` run.

Fairness (:class:`StreamScheduler`): textbook DRR — each tenant holds a
deficit counter in megasamples; a scheduling round credits each active
tenant its quantum (weighted by ``TenantSpec.weight``) and serves ready
slabs while the deficit covers their cost, so a tenant with 4× the
channels doesn't get 4× the slab slots — byte-fairness, not slab-count
fairness.
"""

from __future__ import annotations

import itertools
import os
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from .. import faults
from .. import fsck
from ..parallel.dispatch import PipelinedDispatch
from ..parallel.dispatch import resolve_watchdogged  # noqa: F401 — the JAX module's name
from ..telemetry import costs as tcosts
from ..telemetry import metrics
from ..telemetry import quality as tquality
from ..telemetry import slo as tslo
from ..utils import artifacts, locks
from ..utils.log import get_logger
from ..workflows import campaign as camp
from ..workflows.planner import DownshiftLadder, family_ladder_stages
# the JAX module's names
from ..workflows.planner import DetectorProgram, program_for  # noqa: F401
from .ingest import IngestItem, RingBuffer, SlabSlicer

log = get_logger("das4whales_tpu_torch.service.scheduler")

_c_slabs = metrics.counter(
    "das_service_slabs_total",
    "slabs resolved by the service scheduler",
    ("tenant",),
)
_c_overlapped = metrics.counter(
    "das_service_overlapped_slabs_total",
    "slabs whose resolve overlapped another in-flight dispatch (the "
    "multi-stream pipelining win; fraction of das_service_slabs_total)",
    ("tenant",),
)
_c_files = metrics.counter(
    "das_service_files_total",
    "files dispositioned by the service, by tenant and status",
    ("tenant", "status"),
)
_g_deficit = metrics.gauge(
    "das_service_deficit_msamples",
    "each tenant's DRR deficit counter (megasamples of credit)",
    ("tenant",),
)


class TenantRuntime:
    """One tenant's continuous detection state: ring → slicer → the
    batch campaign's per-slab executor, running forever.

    ``spec`` is a ``service.runner.TenantSpec``; ``outdir`` is the
    tenant's own manifest/picks directory (resume-compatible with —
    and bit-identical to — a ``run_campaign_batched`` run over the
    same files). ``fault_plan`` injects the chaos harness per tenant.
    ``device`` is where the tenant detects (None: the card; ``"cpu"``:
    the plain versions on the CPU). ``executor`` is the tenant's
    ``workflows.campaign.SlabExecutor``.
    """

    def __init__(self, spec, outdir: str, *, resume: bool = True,
                 fault_plan=None, device=None):
        from ..utils.device import resolve_device

        self.spec = spec
        self.name = spec.name
        self.outdir = outdir
        self.device = resolve_device(device)
        os.makedirs(outdir, exist_ok=True)
        # crash-only startup: sweep orphan tmps, heal a torn manifest
        # tail, refuse to resume over deeper corruption (fsck module)
        fsck.startup_check(outdir, label=f"tenant {spec.name}")
        self.records: List[camp.FileRecord] = []
        self.fault_plan = fault_plan
        self.rz = camp._Resilience(outdir, self.records, spec.max_failures,
                                   spec.retry, spec.health)
        # the tenant's detector family (TenantSpec.family; "mf" default
        # keeps pre-family specs working) — every manifest record,
        # downshift event and watchdog attribution carries it, and the
        # ladder is filtered to the family program's declared stages
        self.family = getattr(spec, "family", "mf")
        self.rz.family = self.family
        self.ladder = DownshiftLadder(self.rz, outdir, batch=spec.batch,
                                      family=self.family,
                                      stages=family_ladder_stages(self.family))
        self.ring = RingBuffer(spec.name, capacity=spec.ring_capacity,
                               policy=spec.overflow)
        self.slicer = SlabSlicer(spec.batch, bucket=spec.bucket,
                                 linger_s=spec.linger_s)
        self.ready: deque = deque()       # BatchSlab | IngestItem(error)
        # guards the snapshot-visible scheduler state below: the DRR
        # deficit and the abort marker are written by the scheduler
        # thread and read by HTTP handler threads through snapshot()
        self._lock = locks.new_lock("tenant-state")
        self.deficit = 0.0
        self.aborted: Optional[str] = None
        self.settled = camp.load_settled(outdir) if resume else set()
        for path in sorted(self.settled):
            rec = camp.FileRecord(path=path, status="skipped")
            self.records.append(rec)
            _c_files.inc(tenant=self.name, status="skipped")
        self._finished = False
        # freshness SLO (telemetry.slo): ring-admission stamps
        # per path (scheduler-thread-confined — pump() writes, the
        # settled hook pops) and the rolling burn-rate evaluator when
        # the tenant configured a target (TenantSLO locks internally
        # for the /slo + /readyz HTTP readers)
        self._ingest_t: Dict[str, float] = {}
        policy = spec.slo_policy() if hasattr(spec, "slo_policy") else None
        self.slo = (tslo.TenantSLO(spec.name, policy)
                    if policy is not None else None)
        # un-named live pushes get a per-tenant monotonic sequence: the
        # name IS the manifest/retry/artifact identity key, so two
        # pushes must never collide (a timestamp can, within one ms)
        self._live_seq = itertools.count()
        # science-quality observatory (telemetry.quality): when armed
        # (ServiceConfig.quality / DAS_QUALITY), this tenant's serving
        # lifetime gets a FRESH drift baseline — one tenant's regime
        # change flips only its own das_quality_drift; None = one
        # attribute check per settled file
        self.quality = (tquality.OBSERVATORY.fresh(spec.name)
                        if tquality.enabled() else None)
        kwargs = dict(spec.detector_kwargs)
        if spec.bank is not None:
            kwargs.setdefault("templates", spec.bank)
        # the batch campaign's per-slab executor, against THIS tenant's
        # memory share (TenantSpec.hbm_share_gb; default the process
        # budget) with every pin or skip in the tenant's own manifest; the
        # scheduler sets its before_probe (drain the shared pipe)
        self.executor = camp.SlabExecutor(
            rz=self.rz, ladder=self.ladder, outdir=outdir, records=self.records,
            family=self.family, batch=spec.batch, wire=spec.wire, channels=spec.channels,
            device=self.device, serial=spec.serial, detector_kwargs=kwargs,
            dispatch_deadline_s=spec.dispatch_deadline_s, fault_plan=fault_plan,
            preflight=spec.admission, use_costs=tcosts.enabled(),
            quality_tenant=spec.name if self.quality is not None else None,
            tenant=spec.name,
            budget_bytes=(int(spec.hbm_share_gb * 2**30)
                          if spec.hbm_share_gb is not None else None),
            on_settled=self._settled,
        )

    def next_live_name(self) -> str:
        return f"{self.name}-live-{next(self._live_seq)}"

    # -- scheduler-visible state (written by the scheduler thread, read
    # -- by HTTP snapshot threads: every mutation goes through _lock) ------

    def credit(self, quantum: float) -> None:
        """One DRR round's credit (weighted by ``TenantSpec.weight``).
        The deficit gauge rides every guarded mutation, so the metric
        and the field can never disagree."""
        with self._lock:
            self.deficit += quantum * self.spec.weight
            _g_deficit.set(round(self.deficit, 3), tenant=self.name)

    def forfeit(self) -> None:
        """Classic DRR: an empty queue forfeits accumulated credit."""
        with self._lock:
            self.deficit = 0.0
            _g_deficit.set(0.0, tenant=self.name)

    def try_spend(self, cost: float) -> bool:
        """Spend ``cost`` megasamples of deficit if covered."""
        with self._lock:
            if cost > self.deficit:
                return False
            self.deficit -= cost
            _g_deficit.set(round(self.deficit, 3), tenant=self.name)
            return True

    def mark_aborted(self, reason: str) -> None:
        with self._lock:
            self.aborted = reason

    # -- ingest side -------------------------------------------------------

    def replay_files(self) -> List[str]:
        """The tenant's file list minus manifest-settled paths (crash
        resume: settled files are skipped at the SOURCE, so a restarted
        service never re-reads them)."""
        return camp.pending_files(self.spec.files, settled=self.settled)

    def pump(self) -> None:
        """Move ring items through the slicer into the ready queue."""
        while True:
            item = self.ring.pop()
            if item is None:
                break
            if item.t_ingest is not None:
                # the ring's admission stamp survives slicing: settled
                # picks look their path up here for the freshness SLO
                self._ingest_t[item.path] = item.t_ingest
            self.ready.extend(self.slicer.offer(item))
        if self.slicer.pending() and (
                self.ring.exhausted() or self.slicer.linger_expired()):
            slab = self.slicer.flush_partial()
            if slab is not None:
                self.ready.append(slab)

    def idle(self) -> bool:
        """Nothing buffered, nothing sliceable, source finished."""
        return (not self.ready and self.slicer.pending() == 0
                and self.ring.exhausted())

    def _drop_ingest_stamp(self, path: str) -> None:
        """Release a file's admission stamp on a TERMINAL non-done
        disposition (failed/quarantined/timeout/admission-skip): those
        are not freshness samples — their own counters track them — but
        the stamp must not outlive the file, or a chronically failing
        source grows ``_ingest_t`` for the process lifetime."""
        self._ingest_t.pop(path, None)

    def _note_pick_settled(self, path: str) -> None:
        """Ingest→pick-settled freshness for one done file: the ring's
        admission stamp to now, into ``das_pick_latency_seconds`` and
        the tenant's burn-rate evaluator (``telemetry.slo``). No stamp
        (live push predating the stamp, resumed file) — no sample."""
        t0 = self._ingest_t.pop(path, None)
        if t0 is None:
            return
        latency = time.monotonic() - t0
        tslo.observe_pick_latency(self.name, latency)
        if self.slo is not None:
            self.slo.observe(latency)

    def slo_snapshot(self) -> Dict:
        """This tenant's ``/slo`` row (a no-target tenant reports
        ``state="ok"`` with no burn windows — the histogram still
        records its latencies)."""
        if self.slo is None:
            return {"tenant": self.name, "target_s": None,
                    "state": "ok", "burn_rates": {}}
        return self.slo.snapshot()

    def quality_snapshot(self) -> Optional[Dict]:
        """This tenant's ``/quality`` row (None when the observatory is
        not armed — the ``/tenants`` block then reads ``null``)."""
        if self.quality is None:
            return None
        return self.quality.snapshot()

    # -- detection side (the batch campaign's per-slab executor) ----------

    def _settled(self, path: str, status: str) -> None:
        """A file's terminal disposition by the executor: its counter, and
        its freshness sample (done) or the release of its stamp."""
        _c_files.inc(tenant=self.name, status=status)
        if status == "done":
            self._note_pick_settled(path)
        else:
            self._drop_ingest_stamp(path)

    def try_dispatch(self, slab):
        """Async K0 launch at the tenant's healthy top rung (the
        multi-stream pipeline's dispatch phase); None routes the slab
        to the synchronous path with identical attribution."""
        with self._lock:
            aborted = self.aborted
        if aborted:
            return None
        return self.executor.try_dispatch(slab)

    def handle_slab(self, slab, inflight=None) -> None:
        """One slab through the elastic ladder, the per-file degradation,
        the health gate and the bookkeeping of each of its files: the
        batch campaign's contract, per tenant (the tenant's
        ``SlabExecutor.handle_slab``). ``inflight`` is the slab's
        dispatched program (:meth:`try_dispatch`), or None."""
        self.executor.handle_slab(slab, inflight)

    def handle_error_item(self, item: IngestItem) -> None:
        """Disposition a source-side read failure at its own position
        (the campaign's SlabReadError contract at ring granularity).
        Transient classes disposition terminally here — the replay
        source has already moved past the file, so the in-run retry is
        structurally impossible; ``failed``/``timeout`` are NOT settled
        statuses, so a service restart re-serves the file: the durable
        analog of the campaign's in-run retry."""
        exc = item.error
        self._drop_ingest_stamp(item.path)   # never settles done
        self.rz.attempt(item.path)
        try:
            fclass = faults.classify_failure(exc)
            if fclass == "fatal":
                raise exc
            if isinstance(exc, faults.DeadlineExceeded):
                faults.count("timeouts")
                self.rz.fail(item.path, exc, status="timeout")
            elif fclass == "data":
                faults.count("quarantined")
                self.rz.fail(item.path, exc, status="quarantined",
                             health=getattr(exc, "stats", None))
            else:
                self.rz.fail(item.path, exc)
            _c_files.inc(tenant=self.name,
                         status=self.records[-1].status)
        except camp.CampaignAborted as aexc:
            self.mark_aborted(str(aexc))

    def cost_summary(self) -> Dict:
        """This tenant's placement footprint (the fleet's bin-packing
        input when this outdir is adopted elsewhere): max priced peak
        and roofline wall across the cost cards of every bucket this
        tenant dispatched. ``priced=False`` means the cost observatory
        was off or nothing dispatched yet — a placer then falls back to
        the declared ``hbm_share_gb``, never a guess."""
        labels = {tcosts.bucket_label(k) for k in list(self.executor.dets)}
        peak, wall, n = 0, 0.0, 0
        if tcosts.enabled() and labels:
            for card in tcosts.REGISTRY.cards():
                if card.bucket not in labels:
                    continue
                n += 1
                peak = max(peak, int(card.peak_bytes + card.argument_bytes))
                wall = max(wall, float(card.predicted_wall_s() or 0.0))
        return {
            "tenant": self.name,
            "priced": n > 0,
            "n_cards": n,
            "peak_bytes": peak,
            "predicted_wall_s": round(wall, 6),
            "hbm_share_gb": self.spec.hbm_share_gb,
        }

    def finish(self) -> None:
        """Flush the end-of-run counters event (idempotent), and leave
        the tenant's placement footprint next to its manifest
        (``cost_card.json``)."""
        if not self._finished:
            self._finished = True
            self.rz.flush_tallies()
            try:
                artifacts.atomic_json(
                    os.path.join(self.outdir, "cost_card.json"),
                    self.cost_summary(),
                )
            except OSError as exc:
                log.warning("tenant %s: cost_card.json not written: %s",
                            self.name, exc)

    # -- reporting ---------------------------------------------------------

    def result(self) -> camp.CampaignResult:
        # list(...) is a C-atomic copy: an HTTP thread's result() while
        # the scheduler appends a record must never tear
        return camp.CampaignResult(outdir=self.outdir,
                                   records=list(self.records))

    def snapshot(self) -> Dict:
        """The /tenants view, safe against the scheduler thread: counts
        come from a C-atomic copy of the records list, sticky rungs
        from the ladder's own copy-on-read (`rung_snapshot`), and the
        lock brackets the mutable scalars (deficit, abort marker) so a
        poll observes one consistent DRR round."""
        res = self.result()
        rungs = self.ladder.rung_snapshot()
        with self._lock:
            aborted = self.aborted
            deficit = self.deficit
        return {
            "tenant": self.name,
            "n_done": res.n_done, "n_failed": res.n_failed,
            "n_skipped": res.n_skipped,
            "n_quarantined": res.n_quarantined, "n_timeout": res.n_timeout,
            "ring_depth": len(self.ring),
            "ring_closed": self.ring.closed,
            "ready_slabs": len(self.ready),
            "aborted": aborted,
            "rungs": {str(k): faults.rung_label(r)
                      for k, r in rungs.items()},
            "deficit_msamples": round(deficit, 3),
            "slo": self.slo_snapshot(),
            "quality": self.quality_snapshot(),
        }


class StreamScheduler:
    """Deficit-round-robin over tenants, one shared in-flight pipeline.

    One :class:`~das4whales_tpu_torch.parallel.dispatch.PipelinedDispatch`
    serves every tenant: slab tokens are ``(tenant_name, slab)``, so
    while tenant A's slab computes, tenant B's next slab is already
    dispatching — the cross-tenant overlap is the same mechanism as the
    single-campaign depth-D pipeline, reached through the public
    ``pending()``/``in_flight()`` accessors. A tenant that leaves its
    top rung (or whose dispatch fails) falls back to the synchronous
    path with the campaign's exact attribution.
    """

    def __init__(self, tenants, dispatch_depth: int | None = None):
        tenants = list(tenants)
        self.tenants: Dict[str, TenantRuntime] = {t.name: t for t in tenants}
        if len(self.tenants) != len(tenants):
            raise ValueError("tenant names must be unique")
        self.pipe = PipelinedDispatch(dispatch_depth)
        for t in tenants:
            t.executor.before_probe = self._drain_pipe
        self._rotation = deque(self.tenants)
        self._base_quantum = 1.0   # megasamples; adapts to the largest slab
        # admin verbs: HTTP threads enqueue add/retire ops; the
        # scheduler thread applies them at the top of each round, so
        # the tenants dict and rotation stay scheduler-thread-confined
        # (handlers never mutate them directly)
        self._admin: deque = deque()
        self._retiring: Dict[str, object] = {}   # name -> threading.Event

    @staticmethod
    def _cost(slab) -> float:
        return float(np.asarray(slab.stack).size) / 1e6

    def _finalize(self, token, inflight) -> None:
        name, slab = token
        t = self.tenants[name]
        overlapped = inflight is not None and self.pipe.in_flight() > 0
        _c_slabs.inc(tenant=name)
        if overlapped:
            _c_overlapped.inc(tenant=name)
        try:
            t.executor.finalize(slab, inflight, tenant=name)
        except camp.CampaignAborted as exc:
            # one tenant's max_failures abort stops THAT stream only
            t.mark_aborted(str(exc))
            log.error("tenant %s aborted: %s", name, exc)

    def _drain_pipe(self) -> None:
        for token, inflight in self.pipe.drain():
            self._finalize(token, inflight)

    def _serve(self, t: TenantRuntime, slab) -> None:
        infl = None if t.aborted else t.try_dispatch(slab)
        if infl is None:
            self._drain_pipe()
            if t.aborted:
                # an aborted tenant's remaining slabs are not detected;
                # their files stay unrecorded (resume-able)
                return
            self._finalize((t.name, slab), None)
        else:
            for token in self.pipe.submit((t.name, slab), infl):
                self._finalize(*token)

    # -- admin verbs (drain one tenant, adopt one) --------------------------

    def add_tenant(self, t: TenantRuntime) -> None:
        """Enqueue a freshly adopted tenant; it joins the rotation at
        the top of the next :meth:`step` (never mid-round)."""
        self._admin.append(("add", t))

    def retire_when_idle(self, name: str, done) -> None:
        """Enqueue a tenant's retirement: once its source is exhausted
        and none of its slabs ride the pipe, it is ``finish()``-ed,
        removed from the rotation, and ``done`` (a threading.Event) is
        set — the ``/drain`` verb's completion gate."""
        self._admin.append(("retire", (name, done)))

    def _apply_admin(self) -> None:
        while self._admin:
            op, payload = self._admin.popleft()
            if op == "add":
                t = payload
                t.executor.before_probe = self._drain_pipe
                self.tenants[t.name] = t
                if t.name not in self._rotation:
                    self._rotation.append(t.name)
            else:
                name, done = payload
                self._retiring[name] = done

    def _check_retiring(self) -> None:
        if not self._retiring:
            return
        busy = {tok[0] for tok in self.pipe.pending()}
        for name in list(self._retiring):
            t = self.tenants.get(name)
            if t is None:
                self._retiring.pop(name).set()
                continue
            t.pump()
            if (t.idle() or t.aborted) and name not in busy:
                t.finish()
                del self.tenants[name]
                try:
                    self._rotation.remove(name)
                except ValueError:
                    pass
                self._retiring.pop(name).set()

    def step(self) -> bool:
        """One DRR round: credit each tenant, serve what the deficits
        cover. Returns True when any slab or error item was served (the
        runner idles briefly on False)."""
        any_work = False
        self._apply_admin()
        self._check_retiring()
        for _ in range(len(self._rotation)):
            name = self._rotation[0]
            self._rotation.rotate(-1)
            t = self.tenants[name]
            t.pump()
            # error items carry no device cost: disposition immediately
            while t.ready and isinstance(t.ready[0], IngestItem):
                t.handle_error_item(t.ready.popleft())
                any_work = True
            if not t.ready:
                t.forfeit()   # classic DRR: empty queue forfeits credit
                continue
            head_cost = self._cost(t.ready[0])
            self._base_quantum = max(self._base_quantum, head_cost)
            t.credit(self._base_quantum)
            while t.ready:
                if isinstance(t.ready[0], IngestItem):
                    t.handle_error_item(t.ready.popleft())
                    any_work = True
                    continue
                if not t.try_spend(self._cost(t.ready[0])):
                    break
                slab = t.ready.popleft()
                self._serve(t, slab)
                any_work = True
        return any_work

    def drain(self) -> None:
        """Finish in-flight slabs (the graceful half of SIGTERM): every
        dispatched-unresolved token resolves through its own tenant's
        executor; nothing new is dispatched."""
        self._drain_pipe()

    def run_until_idle(self, idle_sleep_s: float = 0.01,
                       should_stop=None) -> None:
        """Serve until every tenant's source is exhausted and all work
        is resolved, or ``should_stop()``. In-flight tokens left by a
        stop are the caller's to :meth:`drain` (the runner's graceful
        exit path owns that, plus the per-tenant ``finish()``)."""
        while True:
            if should_stop is not None and should_stop():
                return
            worked = self.step()
            if not worked:
                if self.pipe.in_flight():
                    self._drain_pipe()
                    continue
                if all(t.idle() or t.aborted
                       for t in list(self.tenants.values())):
                    return
                time.sleep(idle_sleep_s)
