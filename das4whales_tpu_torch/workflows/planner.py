"""Family-agnostic resilient route planner (the port's copy of
``das4whales_tpu.workflows.planner``): the executor every detector
family of the campaigns inherits.

* :class:`DetectorProgram` — the per-family adapter: the ladder stages
  the family supports, ``detect(rung, trace)`` (the family's program at
  one ladder rung) and ``dispatch(trace)`` (an async launch, or None).
* :class:`DownshiftLadder` — the sticky per-bucket rung bookkeeping of
  the elastic resource ladder, filtered to the family's declared stages,
  every move a ``downshift`` event in the manifest. A key whose detector
  rides a splittable template bank (decoupled per-template thresholds,
  T >= 2) also gets the bank-split rungs (``faults.BANK_STAGE``): the
  same batch as two T/2 sub-bank dispatches, interleaved after each
  batch size's full-bank rung (``enable_bank_split``).
* :class:`RoutePlanner` — the routed executor: resolves each file
  through the family program at the bucket's sticky rung, bounds every
  dispatch with the watchdog (``faults.call_with_deadline``), fires the
  chaos harness's ``on_dispatch(path, rung)`` hook INSIDE the deadline,
  and absorbs resource-class failures by descending the ladder.
* :func:`program_for` — the family registry: a campaign detector (the
  ``MatchedFilterDetector``, the spectro or Gabor eval adapter, the
  ``LearnedDetector``, or any callable returning ``.picks``) to its
  :class:`DetectorProgram`.

The rungs on one card: ``file`` (the per-file program), ``bank`` (the
per-file program as two sub-bank halves, splittable banks only),
``tiled`` (the
family's memory-lean view — channel-tiled correlation for the matched
filter, smaller spectrogram chunks for spectro, window-row chunks of the
CNN for the learned family), ``timeshard`` (the matched filter's
time-split step over every rank of the world, ``parallel.timeshard``:
offered only where ``viable_time_mesh_size(shape, world size)`` allows,
so never in a world of one; every rank must run the campaign for it)
and ``host`` (the family's detector views with
``device="cpu"``: the design tensors on the CPU, every stage the plain
PyTorch version). The host rung is reached only through a resource-class
failure, and the move is a ``downshift`` event like any other.
"""

from __future__ import annotations

import copy
import os
from typing import Dict, Tuple

import numpy as np
import torch

from .. import faults
from ..ops.mxu import engine_labels
from ..telemetry import trace as telemetry
from ..utils.log import get_logger

log = get_logger("das4whales_tpu_torch.planner")


def _append_event(outdir: str, event: Dict) -> None:
    from .campaign import _append_event as _ev

    _ev(outdir, event)


def thresholds_for(result, picks) -> Dict[str, float]:
    """Per-template thresholds for the picks artifact, from a detector
    result. An ABSENT ``thresholds`` attribute (missing/None: the family
    exposes no threshold metadata) records NaN for every template; a
    PRESENT mapping is trusted as-is even when empty or partial (missing
    names record NaN at save time)."""
    thresholds = getattr(result, "thresholds", None)
    if thresholds is None:
        return {name: float("nan") for name in picks}
    return dict(thresholds)


class DetectorProgram:
    """One detector family's executor contract.

    Subclasses declare the capability flags and implement
    :meth:`detect`; the campaign runners never inspect the detector
    type again — the program IS the family:

    * ``family`` — the manifest/ledger label (``FileRecord.family``).
    * ``stages`` — the ladder stages this family's math supports, in
      ladder order. Must include ``"file"`` (the entry rung) and should
      include ``"host"`` (the rung of last resort).
    * :meth:`dispatch` — launches the program asynchronously (the depth-D
      pipelined campaign dispatch), or returns None where the family has
      no async route; its health stats then come from the host block.
    """

    family = "generic"
    stages: Tuple[str, ...] = ("file", "host")

    def __init__(self, detector):
        self.det = detector

    @property
    def engines(self) -> Dict[str, str]:
        """Resolved execution-engine labels the family's detector rides;
        eval adapters carry them on the wrapped detector — both levels
        are consulted."""
        labels = engine_labels(self.det)
        inner = getattr(self.det, "det", None)
        if inner is not None:
            labels = {**engine_labels(inner), **labels}
        return labels

    # -- the per-rung program ---------------------------------------------

    def _det_at(self, stage: str):
        """The detector view serving ``stage``: the detector's own
        ``host_view()`` at the host rung (the default has no tiled
        view and serves the same detector at every other stage)."""
        if stage == "host":
            view = getattr(self.det, "host_view", None)
            if view is None:
                raise RuntimeError(
                    f"{type(self.det).__name__} has no host_view(): the host "
                    "rung cannot move it to the CPU"
                )
            return view()
        return self.det

    def detect(self, rung, trace, *, n_real=None, with_health: bool = False,
               clip=None):
        """One HOST block's ``(picks, thresholds, stats)`` at ``rung``.
        Raises on failure — including resource exhaustion at this rung,
        which the caller's ladder absorbs. The default runs the generic
        ``det(block) -> .picks`` contract through :meth:`_det_at`."""
        det = self._det_at(rung[0])
        return self._call_detector(det, trace, with_health=with_health, clip=clip)

    def dispatch(self, trace, *, with_health: bool = False, clip=None):
        """Launch the per-file program asynchronously (an
        ``InFlightResult``-style handle whose ``resolve()`` is the one
        sync), or None when the family has no async route."""
        return None

    # -- shared helpers ----------------------------------------------------

    def _host_stats(self, trace, with_health: bool, clip) -> Dict[str, float]:
        if not with_health:
            return {}
        from ..ops import health as health_ops

        return health_ops.host_health_stats(np.asarray(trace), clip_abs=clip)

    def _call_detector(self, det, trace, *, with_health: bool, clip):
        """The generic per-file program: ``det(block)`` -> ``.picks``
        (+ optional ``.thresholds``), host-side health stats."""
        result = det(torch.as_tensor(np.asarray(trace)))
        stats = self._host_stats(trace, with_health, clip)
        return result.picks, thresholds_for(result, result.picks), stats


class GenericProgram(DetectorProgram):
    """Any callable returning ``.picks``: the per-file and host rungs
    (the host rung needs the detector's ``host_view()``)."""


class MatchedFilterProgram(DetectorProgram):
    """The flagship family: every rung of the ladder, fused health on
    the one-program route, async dispatch for the depth-D pipeline, and
    the batched slab route (``run_campaign_batched``)."""

    family = "mf"
    stages = ("file", "tiled", "timeshard", "host")

    def __init__(self, detector):
        super().__init__(detector)
        if getattr(detector, "supports_bank_split", False):
            # a splittable template bank: the ladder gains the bank-split
            # rung, T/2 sub-bank dispatches before the route itself goes
            self.stages = ("file", "bank", "tiled", "timeshard", "host")

    def dispatch(self, trace, *, with_health=False, clip=None):
        """Queue the file's program behind the one in flight. A host
        block bound for the card crosses through pinned memory on a side
        stream (``io.staging.to_device``): a copy from pageable memory
        would first wait for every program already queued."""
        if self.det.device.type == "cuda" and not isinstance(trace, torch.Tensor):
            from ..io.staging import to_device

            trace = to_device(np.asarray(trace), self.det.device)
        return self.det.dispatch_picks(trace, with_health=with_health,
                                       health_clip=clip)

    def detect(self, rung, trace, *, n_real=None, with_health=False,
               clip=None):
        det = self.det
        stage = rung[0]
        if stage == "bank":
            # the bank-split rung: the two sub-bank views, their picks
            # merged — bitwise the full bank's under the per_template scope.
            # The health stats describe the input block: the first half's.
            picks, thresholds, stats = {}, {}, {}
            for i, d in enumerate(det.split_views()):
                res = d.detect_picks(trace, n_real=n_real, with_health=with_health and i == 0,
                                     health_clip=clip)
                picks.update(res.picks)
                thresholds.update(res.thresholds)
                if i == 0:
                    stats = res.health
            return picks, thresholds, stats
        if stage == "timeshard":
            from ..parallel.timeshard import detect_picks_time_sharded, ladder_time_mesh

            mesh = ladder_time_mesh(np.asarray(trace).shape, device=det.device)
            if mesh is None:
                # the resource text moves the ladder on, as in JAX
                raise RuntimeError(
                    "RESOURCE_EXHAUSTED: no viable time-shard mesh for "
                    f"shape {np.asarray(trace).shape}"  # -> next rung (host)
                )
            picks, thresholds = detect_picks_time_sharded(det, trace, mesh, n_real=n_real)
            return picks, thresholds, self._host_stats(trace, with_health, clip)
        if stage == "tiled":
            det = det.tiled_view()
        elif stage == "host":
            det = det.host_view()
        res = det.detect_picks(trace, n_real=n_real, with_health=with_health,
                               health_clip=clip)
        return res.picks, res.thresholds, res.health


class SpectroProgram(DetectorProgram):
    """Spectrogram-correlation family (``eval.SpectroEvalAdapter``):
    per-file, channel-chunk-tiled (smaller spectrogram sweep chunks —
    ``models.spectro.SpectroCorrDetector.tiled_view``) and host rungs.
    Every stage is per-channel math, so the tiled rung's picks are the
    per-file rung's. The batched slab route
    (``parallel.batch.BatchedSpectroDetector``) runs the family's heavy
    stage over the B file axis."""

    family = "spectro"
    stages = ("file", "tiled", "host")

    def _det_at(self, stage):
        if stage == "file":
            return self.det
        adapter = copy.copy(self.det)
        if stage == "tiled":
            adapter.det = self.det.det.tiled_view()
        elif stage == "host":
            adapter.prefilter = self.det.prefilter.host_view()
            adapter.det = self.det.det.host_view()
        return adapter


class GaborProgram(DetectorProgram):
    """Gabor/image family (``eval.GaborEvalAdapter``): per-file and host
    rungs only — the oriented Gabor pair couples about a thousand channels
    of the t-x image, so a channel-tiled rung would change the detection
    at tile seams. The batched slab route
    (``parallel.batch.BatchedGaborDetector``) batches over FILES, where
    no seam arises. The host rung is the adapter's ``host_view``."""

    family = "gabor"
    stages = ("file", "host")
    supports_batched = True


class LearnedProgram(DetectorProgram):
    """Learned CNN family (``models.learned.LearnedDetector``): per-file,
    tiled (the classifier in bounded window-row chunks,
    ``LearnedDetector.tiled_view``) and host (``host_view``) rungs. Scores
    are per window, so every rung picks the same windows. The batched
    slab route (``parallel.batch.BatchedLearnedDetector``) scores a
    slab's files at once; threshold and NMS per file on the host."""

    family = "learned"
    stages = ("file", "tiled", "host")
    supports_batched = True

    def _det_at(self, stage):
        if stage == "tiled":
            return self.det.tiled_view()
        return super()._det_at(stage)


#: family name -> the family's program class (the batched campaign
#: resolves ladder stages and per-file-rung programs through this table;
#: ``program_for`` stays the detector-instance registry)
FAMILY_PROGRAMS = {
    "mf": MatchedFilterProgram,
    "spectro": SpectroProgram,
    "gabor": GaborProgram,
    "learned": LearnedProgram,
}


def family_ladder_stages(family: str) -> Tuple[str, ...]:
    """The downshift-ladder stages a BATCHED route may visit for one
    family: ``"batched"`` plus whatever the family's per-file program
    declares (spectro has no time-shard math, so its ladder skips
    straight to the rungs its program can serve)."""
    cls = FAMILY_PROGRAMS[family]
    return tuple(
        s for s in faults.DOWNSHIFT_STAGES
        if s == "batched" or s in cls.stages
    )


def program_for(detector) -> DetectorProgram:
    """The family registry: any campaign detector -> its
    :class:`DetectorProgram`. A detector already wrapped in a program
    passes through; unknown detector types get the
    :class:`GenericProgram` flat contract (per-file + host rungs, host
    health stats)."""
    if isinstance(detector, DetectorProgram):
        return detector
    from ..eval import GaborEvalAdapter, SpectroEvalAdapter
    from ..models.learned import LearnedDetector
    from ..models.matched_filter import MatchedFilterDetector

    if isinstance(detector, MatchedFilterDetector):
        return MatchedFilterProgram(detector)
    if isinstance(detector, LearnedDetector):
        return LearnedProgram(detector)
    if isinstance(detector, SpectroEvalAdapter):
        return SpectroProgram(detector)
    if isinstance(detector, GaborEvalAdapter):
        return GaborProgram(detector)
    return GenericProgram(detector)


class DownshiftLadder:
    """The elastic resource ladder's sticky bookkeeping.

    One campaign, one ladder: per bucket key it remembers the WINNING
    rung — ``("batched", B)`` at shrinking B (each followed by ``("bank",
    B)`` where the key's bank split is enabled), then ``("file", 1)`` (the
    per-file route; ``("bank", 1)`` after it likewise), ``("tiled", 1)``
    (the family's memory-lean view),
    ``("timeshard", 1)`` (where the world's ranks can split the shape's
    time axis; ``timeshard=False`` never offers it),
    ``("host", 1)`` (the CPU). ``stages`` filters the ladder to the
    family's declared support; ``family`` labels the manifest's
    ``downshift`` events. A resource-class failure advances the bucket's
    rung ONCE and the rung sticks for the rest of the campaign (no
    per-file thrash); every move lands in the manifest's ``downshift``
    ledger.
    """

    def __init__(self, rz, outdir: str, batch: int = 1,
                 write: bool = True, timeshard: bool = True,
                 stages=faults.DOWNSHIFT_STAGES, family: str = "",
                 engines: Dict[str, str] | None = None):
        self.rz = rz
        self.outdir = outdir
        self.batch = int(batch)
        self.write = write
        self.allow_timeshard = timeshard
        self.stages = tuple(stages)
        self.family = family
        self.engines = dict(engines or {})
        self._engines_by_key: Dict = {}
        self.sticky: Dict[tuple, tuple] = {}
        # keys whose detector rides a splittable template bank: only they
        # get the interleaved bank-split rungs
        self._bank_keys: set = set()
        self._bank_all = False

    def enable_bank_split(self, key=None) -> None:
        """Arm the bank-split rung for ``key`` (None: every key — the
        unbatched planner, whose one program serves the whole run)."""
        if key is None:
            self._bank_all = True
        else:
            self._bank_keys.add(key)

    def bank_split_enabled(self, key=None) -> bool:
        return self._bank_all or key in self._bank_keys

    def set_engines(self, key, labels) -> None:
        """Record ``key``'s own resolved engine labels."""
        self._engines_by_key[key] = dict(labels or {})

    def engines_for(self, key) -> Dict[str, str]:
        return self._engines_by_key.get(key, self.engines)

    def rungs(self, key=None, trace_shape=None) -> list:
        bank = self.bank_split_enabled(key)
        out = []
        if "batched" in self.stages:
            b = self.batch
            while b > 1:
                out.append(("batched", b))
                if bank:
                    # the T axis goes before B: the same batch as two T/2
                    # sub-bank dispatches
                    out.append(("bank", b))
                b //= 2
        out.append(("file", 1))
        if bank:
            out.append(("bank", 1))
        if "tiled" in self.stages:
            out.append(("tiled", 1))
        if ("timeshard" in self.stages and self.allow_timeshard
                and trace_shape is not None):
            from ..parallel.timeshard import _world_size, viable_time_mesh_size

            if viable_time_mesh_size(tuple(trace_shape)[-2:], _world_size()):
                out.append(("timeshard", 1))
        if "host" in self.stages:
            out.append(("host", 1))
        return out

    def current(self, key) -> tuple:
        return self.sticky.get(
            key, ("batched", self.batch) if self.batch > 1 else ("file", 1)
        )

    def rung_snapshot(self) -> Dict[tuple, tuple]:
        """A copy of the sticky map for cross-thread readers (the
        service's ``/tenants`` snapshot): ``dict(...)`` of a dict is a
        C-atomic copy, so an HTTP thread never iterates the live map
        while the scheduler thread downshifts it."""
        return dict(self.sticky)

    def _ledger(self, key, from_rung, to_rung, error: str,
                preflight: bool = False) -> None:
        """One downshift ledger move: a ``downshift`` SPAN paired with
        the manifest event, the span's id stamped into the event."""
        if not self.write:
            return
        with telemetry.span(
            "downshift", bucket=str(key), family=self.family,
            from_rung=faults.rung_label(from_rung),
            to_rung=faults.rung_label(to_rung), preflight=preflight,
        ) as sp:
            event = {
                "event": "downshift",
                "bucket": key if isinstance(key, str) else list(key),
                "family": self.family,
                "from": faults.rung_label(from_rung),
                "to": faults.rung_label(to_rung),
                **({"engines": eng} if (eng := self.engines_for(key))
                   else {}),
                "error": error, "sticky": True,
            }
            if preflight:
                event["preflight"] = True
            if sp.span_id is not None:
                event["span_id"] = sp.span_id
            _append_event(self.outdir, event)

    def pin(self, key, rung, reason: str) -> None:
        """Preflight placement: start ``key`` at ``rung`` (no failure
        occurred — ledgered as a preflight downshift when it moves the
        bucket off the top rung)."""
        top = ("batched", self.batch) if self.batch > 1 else ("file", 1)
        self.sticky[key] = rung
        if faults.rung_rank(rung) > faults.rung_rank(top):
            self.rz.tally("downshifts")
            self._ledger(key, top, rung, reason, preflight=True)
            log.info("preflight: bucket %s starts at rung %s (%s)",
                     key, faults.rung_label(rung), reason)

    def downshift(self, key, rung, exc, trace_shape=None):
        """Advance ``key``'s sticky rung past ``rung`` after a
        resource-class failure; returns the new rung, or None when the
        ladder is exhausted (the failure dispositions per-file)."""
        nxt = None
        for cand in self.rungs(key, trace_shape):
            if faults.rung_rank(cand) > faults.rung_rank(rung):
                nxt = cand
                break
        if nxt is None:
            return None
        self.sticky[key] = nxt
        self.rz.tally("downshifts")
        self._ledger(key, rung, nxt, f"{type(exc).__name__}: {exc}")
        log.warning(
            "resource exhaustion at rung %s (%s: %s); downshifting bucket "
            "%s to %s (sticky)", faults.rung_label(rung),
            type(exc).__name__, exc, key, faults.rung_label(nxt),
        )
        return nxt


class RoutePlanner:
    """One campaign's routed, degradable, watchdogged executor over a
    family :class:`DetectorProgram`.

    ``run_file`` resolves one file at the bucket's sticky rung: the
    family program (or a pre-dispatched in-flight handle at the top
    rung) runs inside the dispatch watchdog with the chaos harness's
    ``on_dispatch(path, rung)`` hook firing inside the deadline.
    Resource-class failures descend the family's ladder (sticky,
    ledgered); everything else re-raises for the campaign's classified
    disposition.
    """

    def __init__(self, rz, outdir: str, program: DetectorProgram, *,
                 write: bool = True,
                 dispatch_deadline_s: float | None = None, fault_plan=None):
        self.rz = rz
        self.program = program
        self.fault_plan = fault_plan
        self.deadline_s = dispatch_deadline_s
        self.top = ("file", 1)
        self.ladder = DownshiftLadder(
            rz, outdir, batch=1, write=write,
            stages=program.stages, family=program.family,
            engines=program.engines,
        )
        if "bank" in program.stages:
            # one program serves the whole unbatched run: the split holds
            # for every ladder key
            self.ladder.enable_bank_split()

    def current(self, key: str = "campaign") -> tuple:
        return self.ladder.current(key)

    def run_file(self, path: str, trace, *, n_real=None,
                 with_health: bool = False, clip=None, inflight=None,
                 key: str = "campaign"):
        """One file's ``(picks, thresholds, stats, rung)`` through the
        rung loop. ``inflight`` is the depth-D pipeline's pre-dispatched
        handle for this file: consumed only while the bucket still rides
        the top rung (a downshift between dispatch and resolve abandons
        it); any failure discards it — a handle is never resolved
        twice."""
        from ..parallel import dispatch as dispatch_mod

        recovered = False
        with telemetry.span("file", file=os.path.basename(path),
                            family=self.program.family):
            while True:   # rung loop: resource failures downshift, sticky
                rung = self.ladder.current(key)
                if inflight is not None and rung != self.top:
                    inflight = None

                def fn(inflight=inflight, rung=rung):
                    if inflight is not None:
                        # the pipeline's pre-dispatched program: this is its
                        # packed fetch (the one sync), inside the watchdog
                        res = inflight.resolve()
                        return res.picks, res.thresholds, res.health
                    return self.program.detect(
                        rung, trace, n_real=n_real,
                        with_health=with_health, clip=clip,
                    )

                try:
                    picks, thresholds, stats = \
                        dispatch_mod.resolve_watchdogged(
                            fn, [path], rung, self.deadline_s,
                            self.fault_plan, family=self.program.family,
                        )
                    break
                except Exception as exc:  # noqa: BLE001 — ladder absorbs resource
                    inflight = None   # spent/abandoned: never consume twice
                    if (faults.classify_failure(exc) == "resource"
                            and self.ladder.downshift(key, rung, exc,
                                                      trace_shape=np.shape(trace))):
                        recovered = True
                        continue
                    raise
        if recovered:
            self.rz.tally("oom_recoveries")
        return picks, thresholds, stats, rung
