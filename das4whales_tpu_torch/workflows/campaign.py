"""Fault-tolerant, resumable detection campaigns over file collections
(the port's copy of ``das4whales_tpu.workflows.campaign``, single card).

Two entries process an arbitrary file list to an output directory:
:func:`run_campaign` (one file a program) and :func:`run_campaign_batched`
(``batch`` files a program, the slab route). Both give

* **design-once / detect-many** — one detector per shape bucket, fed by
  the prefetching stream (``io.stream``);
* **per-file fault isolation** — a file that fails to probe, read or
  detect is recorded and skipped; the stream restarts after the culprit
  and the campaign continues (``max_failures`` bounds the tolerance);
* **durable progress** — every file appends a JSON-lines manifest
  record (status, pick counts, wall, error, attempts, health, family,
  rung) and its picks land in a per-file ``.npz`` artifact, both
  through the one durable-write layer (``utils.artifacts``); with
  ``resume=True`` a re-run skips settled files, so a killed campaign
  continues where it stopped. Manifests, picks artifacts and the
  ``summarize_campaign`` report are the JAX package's, byte for byte in
  each manifest line: either package reads the other's output
  directory;
* **classified failure handling** (``faults``) — transient failures
  retry with seeded backoff, corrupt ones disposition ``failed``,
  breaches of the fused health stats ``quarantined``, a hung reader or
  a wedged device call ``timeout``; only fatal failures abort;
* **the elastic downshift ladder** (``workflows.planner``) — a
  resource-class failure (``torch.cuda.OutOfMemoryError``, an allocator
  text such as cuFFT's ``CUFFT_ALLOC_FAILED``) retries the slab at
  ``B -> B/2 -> ... -> 1``, then the per-file route, the channel-tiled
  view and finally the host (the CPU), each move a sticky ``downshift``
  event in the manifest;
* **depth-D pipelined dispatch** (``parallel.dispatch``) — slab k+1's
  program is queued on the card before slab k's packed fetch is taken.

Entries run on the card unless the caller passes ``device="cpu"``; they
resolve the device before reading a file, so a run without a card
raises instead of failing every file.

Not in this slice: the memory preflight (``preflight=True``; ROADMAP
item 'Campaign preflight'), the cost cards and the quality observatory
(``cost_cards=True``, ``quality=True``; 'Service and fleet'), the
sharded and multi-process campaigns ('Multi-GPU'), the gabor and learned
families ('Gabor and learned') and the density plot ('Workflow mains and
plots'). Each raises, naming its item.
"""

from __future__ import annotations

import hashlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np

from .. import faults, fsck
from ..config import as_health_config
from ..config import not_in_slice as _not_in_slice
from ..io.stream import stream_strain_blocks
from ..models.matched_filter import MatchedFilterDetector
from ..telemetry import metrics as tmetrics
from ..telemetry import probes as tprobes
from ..telemetry import trace as telemetry
from ..utils import artifacts
from ..utils.device import resolve_device
from ..utils.log import get_logger
from .planner import (
    DetectorProgram,
    DownshiftLadder,
    RoutePlanner,
    family_ladder_stages,
    program_for,
)

log = get_logger("das4whales_tpu_torch.campaign")

_h_slab_wall = tmetrics.histogram(
    "das_slab_wall_seconds",
    "wall seconds per batched slab (dispatch through bookkeeping)",
)

MANIFEST = "manifest.jsonl"

#: statuses that disposition a file for good — resume skips them (a
#: quarantined file is deterministically unhealthy). "failed" and
#: "timeout" are retried by a resume: they may have been transient.
_SETTLED_STATUSES = ("done", "quarantined")


class CampaignAborted(RuntimeError):
    """Raised when failures exceed ``max_failures``."""

    fault_class = "fatal"


@dataclass
class FileRecord:
    path: str
    #: "done" | "failed" | "skipped" | "quarantined" | "timeout"
    status: str
    n_picks: Dict[str, int] = field(default_factory=dict)
    wall_s: float = 0.0
    error: str = ""
    picks_file: str = ""
    #: how many attempts this file consumed (retried transients > 1)
    attempts: int = 1
    #: data-health stats (ops.health) when the campaign computed them
    health: Dict[str, float] = field(default_factory=dict)
    #: detector family that processed the file ("mf" | "spectro")
    family: str = ""
    #: the route rung that actually executed (faults.rung_label —
    #: "batched:4" / "file" / "tiled" / "host")
    rung: str = ""


@dataclass
class CampaignResult:
    outdir: str
    records: List[FileRecord]

    @property
    def n_done(self) -> int:
        return sum(r.status == "done" for r in self.records)

    @property
    def n_failed(self) -> int:
        return sum(r.status == "failed" for r in self.records)

    @property
    def n_skipped(self) -> int:
        return sum(r.status == "skipped" for r in self.records)

    @property
    def n_quarantined(self) -> int:
        return sum(r.status == "quarantined" for r in self.records)

    @property
    def n_timeout(self) -> int:
        return sum(r.status == "timeout" for r in self.records)


def _manifest_path(outdir: str) -> str:
    return os.path.join(outdir, MANIFEST)


def _load_settled(outdir: str) -> set:
    """Paths whose LAST manifest record settles them (done/quarantined,
    last record wins)."""
    last: Dict[str, str] = {}

    def _warn_bad(lineno: int, verdict: str, _line: str) -> None:
        # torn final line / CRC-failed record from an unclean death:
        # tolerated (the file re-runs) but never silently
        log.warning("manifest %s line %d: %s record skipped by resume",
                    _manifest_path(outdir), lineno, verdict)

    for rec in artifacts.read_records(_manifest_path(outdir), on_bad=_warn_bad):
        if "path" in rec:
            last[rec["path"]] = rec.get("status", "")
    return {p for p, status in last.items() if status in _SETTLED_STATUSES}


def _append_manifest(outdir: str, rec: FileRecord) -> None:
    artifacts.append_record(_manifest_path(outdir), rec.__dict__)


def _append_event(outdir: str, event: Dict) -> None:
    """Append a non-file EVENT record to the manifest (no ``path`` key,
    so resume bookkeeping and per-file consumers skip it): the downshift
    ledger (``event="downshift"``) and the end-of-run resilience
    counters (``event="counters"``); ``summarize_campaign`` aggregates
    them."""
    artifacts.append_record(_manifest_path(outdir), dict(event))


def _picks_path(outdir: str, path: str) -> str:
    """Deterministic artifact path for one file's picks."""
    stem = os.path.splitext(os.path.basename(path))[0]
    # disambiguate same-named files from different directories
    digest = hashlib.sha1(os.path.abspath(path).encode()).hexdigest()[:8]
    return os.path.join(outdir, "picks", f"{stem}-{digest}.npz")


def _save_picks(outdir: str, path: str, picks: Dict[str, np.ndarray],
                thresholds: Dict[str, float]) -> str:
    """Write one file's picks artifact ATOMICALLY (tmp + fsync +
    ``os.replace`` + directory fsync): the manifest's ``done`` record is
    appended only after this returns, so a crash mid-write can never pair
    a torn ``.npz`` with a ``done`` record."""
    out = _picks_path(outdir, path)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    arrays = {f"picks_{name}": np.asarray(pk) for name, pk in picks.items()}
    # a family may expose thresholds for only SOME templates: NaN for the
    # missing names (planner.thresholds_for)
    arrays["thresholds"] = np.asarray(
        [float(thresholds.get(name, float("nan"))) for name in picks]
    )
    arrays["template_names"] = np.asarray(list(picks), dtype="U")
    with artifacts.atomic_file(out, "wb") as fh:
        np.savez(fh, **arrays)
    return out


def load_picks(picks_file: str) -> Dict[str, np.ndarray]:
    """Read one campaign picks artifact back into ``{name: (2, n)}``."""
    with np.load(picks_file) as z:
        return {str(n): z[f"picks_{n}"] for n in z["template_names"]}


def load_settled(outdir: str) -> set:
    """The paths whose last manifest record settles them (done /
    quarantined): the one definition ``resume=True`` reads."""
    return _load_settled(outdir)


def pending_files(files, outdir: str | None = None, *,
                  settled: set | None = None) -> list:
    """The work-list that REMAINS for one campaign outdir — ``files``
    minus the manifest-settled set, in the original order. Pass a
    pre-loaded ``settled`` set to skip the manifest re-read."""
    if settled is None:
        if outdir is None:
            raise ValueError("pending_files needs outdir or settled")
        settled = _load_settled(outdir)
    return [f for f in files if f not in settled]


def _normalize_metas(metadata, files):
    """The stream's metadata convention (None / one-for-all / aligned
    sequence) as an explicit per-file list."""
    if metadata is None:
        return [None] * len(files)
    if isinstance(metadata, (list, tuple)):
        if len(metadata) != len(files):
            raise ValueError(
                f"got {len(metadata)} metadata entries for {len(files)} files"
            )
        return list(metadata)
    return [metadata] * len(files)


def _split_resume(files, outdir: str, resume: bool, records: List[FileRecord]):
    """Partition ``files`` into (pending, pending_indices), appending
    'skipped' records for manifest-settled (done/quarantined) files."""
    done = _load_settled(outdir) if resume else set()
    pending, idx = [], []
    for j, path in enumerate(files):
        if path in done:
            records.append(FileRecord(path=path, status="skipped"))
        else:
            pending.append(path)
            idx.append(j)
    if records and resume:
        log.info("resume: %d/%d files already settled", len(records), len(files))
    return pending, idx


def _failure_recorder(outdir: str, records: List[FileRecord], max_failures,
                      write: bool = True, family: str = ""):
    """Shared per-file failure bookkeeping: manifest record + warning +
    max_failures enforcement (every non-done disposition — failed,
    quarantined, timeout — counts toward the tolerance)."""
    state = {"n": 0}

    def fail(path: str, exc: Exception, status: str = "failed",
             attempts: int = 1, health=None, family=family,
             rung: str = "") -> None:
        state["n"] += 1
        rec = FileRecord(path=path, status=status,
                         error=f"{type(exc).__name__}: {exc}",
                         attempts=max(int(attempts), 1),
                         health=dict(health or {}),
                         family=family, rung=rung)
        records.append(rec)
        if write:
            _append_manifest(outdir, rec)
        log.warning("file %s (%d non-done so far): %s — %s",
                    status, state["n"], path, rec.error)
        if max_failures is not None and state["n"] > max_failures:
            raise CampaignAborted(
                f"{state['n']} failures exceed max_failures={max_failures}"
            ) from exc

    return fail


class _Resilience:
    """One campaign run's classified-failure machinery: the retry state
    over a ``faults.RetryPolicy``, the data-health config, and the
    terminal-disposition recorder."""

    def __init__(self, outdir, records, max_failures, retry, health,
                 write: bool = True):
        self.policy = faults.as_retry_policy(retry)
        self.state = faults.RetryState(self.policy)
        self.health_cfg = as_health_config(health)
        #: family label stamped on this run's failure records
        self.family = ""
        self._fail = _failure_recorder(outdir, records, max_failures,
                                       write=write)
        self.outdir = outdir
        self.write = write
        # per-CAMPAIGN resource-resilience tallies (faults.counters()
        # aggregates across campaigns; these feed this run's manifest
        # "counters" event and summarize_campaign)
        self.tallies: Dict[str, int] = {
            "downshifts": 0, "oom_recoveries": 0, "watchdog_timeouts": 0,
        }

    def fail(self, path: str, exc: Exception, status: str = "failed",
             attempts: int = 1, health=None, rung: str = "") -> None:
        self._fail(path, exc, status=status, attempts=attempts,
                   health=health, family=self.family, rung=rung)

    def tally(self, name: str, n: int = 1) -> None:
        self.tallies[name] = self.tallies.get(name, 0) + n
        faults.count(name, n)

    def flush_tallies(self) -> None:
        """Write the end-of-run counters event — only when nonzero, so a
        healthy campaign's manifest stays pure file records."""
        if self.write and any(self.tallies.values()):
            event = {"event": "counters", **self.tallies}
            sid = telemetry.current_span_id()
            if sid is not None:
                event["span_id"] = sid
            _append_event(self.outdir, event)

    def attempt(self, path: str) -> int:
        return self.state.attempt(path)

    def check_health(self, path: str, stats, rung: str = "") -> None:
        """Raise ``faults.DataHealthError`` (data-class -> quarantine)
        when ``stats`` breach the configured thresholds."""
        if self.health_cfg is None or not stats:
            return
        reason = self.health_cfg.breach(stats)
        if reason:
            exc = faults.DataHealthError(reason, stats)
            exc.campaign_rung = rung
            raise exc

    def dispose(self, path: str, exc: Exception) -> str:
        """Classify a file's failure and either schedule a retry
        (returns ``"retry"`` after the deterministic backoff sleep) or
        record its terminal status (returns ``"next"``). Fatal-class
        failures re-raise — only they abort the campaign."""
        n_att = self.state.n_attempts(path)
        rung = getattr(exc, "campaign_rung", "")
        if isinstance(exc, faults.DeadlineExceeded):
            faults.count("timeouts")
            if isinstance(exc, faults.DispatchDeadlineExceeded):
                # the dispatch watchdog fired (a wedged device call), not
                # the reader deadline
                self.tally("watchdog_timeouts")
            self.fail(path, exc, status="timeout", attempts=n_att, rung=rung)
            return "next"
        fclass = faults.classify_failure(exc)
        if fclass == "fatal":
            raise exc
        if self.state.should_retry(path, fclass):
            delay = self.state.backoff(path, fclass)
            log.warning("%s failure on %s (attempt %d): retrying after "
                        "%.3fs — %s", fclass, path, n_att, delay, exc)
            return "retry"
        if fclass == "data":
            faults.count("quarantined")
            self.fail(path, exc, status="quarantined", attempts=n_att,
                      health=getattr(exc, "stats", None), rung=rung)
        else:
            self.fail(path, exc, attempts=n_att, rung=rung)
        return "next"


FAMILIES = ("mf", "spectro", "gabor", "learned")


def _env_flag(flag, name: str) -> bool:
    if flag is not None:
        return bool(flag)
    return os.environ.get(name, "") not in ("", "0", "false")


def _check_not_in_slice(*, quality=None, cost_cards=None, preflight=None) -> None:
    from ..config import memory_preflight_default

    if _env_flag(quality, "DAS_QUALITY"):
        raise _not_in_slice("quality (the quality observatory)", "Service and fleet")
    if _env_flag(cost_cards, "DAS_COST_CARDS"):
        raise _not_in_slice("cost_cards (the cost observatory)", "Service and fleet")
    if preflight is None:
        preflight = memory_preflight_default()
    if preflight:
        raise _not_in_slice("preflight", "Campaign preflight")


def _load_design(design):
    """A ``design=`` detector kwarg: a ``MatchedFilterDesign`` or the
    path of its checkpoint (``utils.checkpoint.save_design`` of either
    package)."""
    if isinstance(design, (str, os.PathLike)):
        from ..utils.checkpoint import load_design

        return load_design(os.fspath(design))
    return design


def family_detector(family: str, metadata, selected_channels, trace_shape,
                    *, wire: str = "conditioned", device=None, **detector_kwargs):
    """One bucket's PER-FILE detector at the bucket shape, on ``device``
    (None: the card) — the family builder behind
    :func:`run_campaign_batched`. ``detector_kwargs`` are the family
    constructor's: ``MatchedFilterDetector``'s for ``"mf"``, the spectro
    ``campaign_detector``'s for ``"spectro"``.

    ``design=`` (a ``MatchedFilterDesign`` or the path of its checkpoint,
    written by either package's ``save_design``) builds the matched
    filter — or the spectro family's prefilter — on that design instead
    of designing it: the f-k mask's host design is tens of seconds at the
    canonical shape, so a campaign over many days of one cable loads it.
    Its ``trace_shape`` must be the bucket's."""
    design = _load_design(detector_kwargs.pop("design", None))
    if design is not None and tuple(design.trace_shape) != tuple(trace_shape):
        raise ValueError(f"design shape {tuple(design.trace_shape)} != bucket shape "
                         f"{tuple(trace_shape)}")
    if family == "mf":
        if design is not None:
            return MatchedFilterDetector.from_design(design, metadata, wire=wire,
                                                     device=device, **detector_kwargs)
        return MatchedFilterDetector(metadata, selected_channels, trace_shape, wire=wire,
                                     device=device, **detector_kwargs)
    if family == "spectro":
        from .spectrodetect import campaign_detector

        if design is not None:
            from ..eval import SpectroEvalAdapter
            from ..models.spectro import SpectroCorrDetector

            kw = dict(detector_kwargs)
            mf = MatchedFilterDetector.from_design(
                design, metadata, fused_bandpass=kw.pop("fused_bandpass", True),
                device=device)
            return SpectroEvalAdapter(mf, SpectroCorrDetector(
                mf.metadata, threshold=kw.pop("threshold", 14.0), device=mf.device, **kw))
        return campaign_detector(metadata, selected_channels, trace_shape,
                                 device=device, **detector_kwargs)
    if family in ("gabor", "learned"):
        raise _not_in_slice(f"family={family!r}", "Gabor and learned")
    raise ValueError(
        f"unknown detector family {family!r}; expected one of {FAMILIES}"
    )


def run_campaign(
    files: Sequence[str],
    selected_channels,
    outdir: str,
    metadata=None,
    detector: MatchedFilterDetector | None = None,
    resume: bool = True,
    max_failures: int | None = None,
    interrogator: str = "optasense",
    prefetch: int = 2,
    engine: str = "h5py",
    wire: str = "conditioned",
    retry=None,
    health=True,
    read_deadline_s: float | None = None,
    dispatch_deadline_s: float | None = None,
    dispatch_depth: int | None = None,
    trace: bool | None = None,
    quality: bool | None = None,
    fault_plan=None,
    device=None,
    **detector_kwargs,
) -> CampaignResult:
    """Detect over ``files`` one file a program, tolerating per-file
    failures and resuming past completed work.

    ``detector=None`` builds a ``MatchedFilterDetector`` on ``device``
    (None: the card; ``"cpu"``: the plain versions on the CPU) from the
    first readable file's shape/metadata (extra ``detector_kwargs`` pass
    through, ``design=`` among them: :func:`family_detector`).
    ``wire="raw"`` streams stored-dtype counts and conditions them on the
    card — a caller-supplied ``detector`` must have been built with the
    same ``wire``. Returns a :class:`CampaignResult`; durable state lives
    in ``outdir/manifest.jsonl`` + ``outdir/picks/*.npz``.

    Resilience (``faults``): ``retry`` — a ``faults.RetryPolicy``
    (None/True: the env-driven default; False: off) for transient
    failures; ``health`` — a ``config.DataHealthConfig`` (None/True: the
    default, which quarantines any non-finite sample; False: off) checked
    against the health stats fused into the detection program;
    ``read_deadline_s`` — per-file reader deadline;
    ``dispatch_deadline_s`` — the dispatch WATCHDOG (None: the
    ``DAS_DISPATCH_DEADLINE_S`` env default); ``fault_plan`` — a
    ``faults.FaultPlan`` chaos schedule (testing). Resource exhaustion
    downshifts the route through the planner — per-file -> tiled ->
    host — sticky for the rest of the run and ledgered in the manifest.

    ``dispatch_depth`` (None: the ``DAS_DISPATCH_DEPTH`` env default, 2)
    arms depth-D pipelined dispatch on the healthy per-file rung: file
    k+1's program is queued on the card before file k's packed fetch.
    ``trace`` arms the flight recorder (``telemetry.trace``;
    ``<outdir>/trace.json``). ``quality`` is not in this slice: on
    (or ``DAS_QUALITY=1``) it raises.
    """
    from ..config import dispatch_deadline_default
    from ..parallel.dispatch import PipelinedDispatch

    _check_not_in_slice(quality=quality, cost_cards=False, preflight=False)
    if detector is None:
        device = resolve_device(device)   # before any file is read
    if dispatch_deadline_s is None:
        dispatch_deadline_s = dispatch_deadline_default()
    det_wire = getattr(detector, "wire", "conditioned")
    if detector is not None and det_wire != wire:
        raise ValueError(
            f"detector was built with wire={det_wire!r} but the "
            f"campaign streams wire={wire!r}; a conditioned-wire detector "
            "fed raw counts would treat them as strain (no on-device "
            "demean/scale) and silently mis-detect"
        )
    os.makedirs(outdir, exist_ok=True)
    fsck.startup_check(outdir, label="campaign")
    metas = _normalize_metas(metadata, list(files))
    records: List[FileRecord] = []
    pending, pend_idx = _split_resume(list(files), outdir, resume, records)
    pend_metas = [metas[j] for j in pend_idx]
    rz = _Resilience(outdir, records, max_failures, retry, health)
    route: RoutePlanner | None = None
    if detector is not None:
        route = RoutePlanner(
            rz, outdir, program_for(detector),
            dispatch_deadline_s=dispatch_deadline_s, fault_plan=fault_plan,
        )
        rz.family = route.program.family
    else:
        rz.family = "mf"   # detector=None builds a MatchedFilterDetector
    _BUCKET = "campaign"   # one unbatched campaign = one sticky ladder key

    def scale_mismatch(block) -> bool:
        det_meta = getattr(detector, "metadata", None)
        return (wire == "raw" and det_meta is not None
                and block.metadata is not None
                and block.metadata.scale_factor != det_meta.scale_factor)

    def detect_one(path, block, t0, inflight=None):
        """One attempt at the transfer+detect+health half of a file
        (raises on failure; the caller dispositions). ``inflight`` is the
        depth-D pipeline's pre-dispatched program for this file."""
        nonlocal detector, route
        if fault_plan is not None:
            fault_plan.on_transfer(path)
        if detector is None:
            detector = family_detector(
                "mf", block.metadata, selected_channels, np.shape(block.trace),
                wire=wire, device=device, **detector_kwargs)
        if route is None:
            route = RoutePlanner(
                rz, outdir, program_for(detector),
                dispatch_deadline_s=dispatch_deadline_s,
                fault_plan=fault_plan,
            )
            rz.family = route.program.family
        if scale_mismatch(block):
            # the raw wire conditions with the DETECTOR's scale; a file
            # probed with a different factor fails per-file
            raise ValueError(
                f"scale_factor {block.metadata.scale_factor!r} != "
                f"detector scale {detector.metadata.scale_factor!r}; wire='raw' "
                "conditions with one scale — use wire='conditioned' "
                "for heterogeneous file sets"
            )
        if fault_plan is not None:
            fault_plan.on_detect(path)
        clip = rz.health_cfg.clip_abs if rz.health_cfg is not None else None
        with_health = rz.health_cfg is not None
        picks, thresholds, stats, rung = route.run_file(
            path, block.trace, with_health=with_health, clip=clip,
            inflight=inflight, key=_BUCKET,
        )
        rz.check_health(path, stats, rung=faults.rung_label(rung))
        if fault_plan is not None:
            fault_plan.detect_succeeded()
        rec = FileRecord(
            path=path, status="done",
            n_picks={k: int(v.shape[1]) for k, v in picks.items()},
            wall_s=round(time.perf_counter() - t0, 3),
            picks_file=_save_picks(outdir, path, picks, thresholds),
            attempts=rz.state.n_attempts(path), health=dict(stats or {}),
            family=route.program.family, rung=faults.rung_label(rung),
        )
        # manifest BEFORE the in-memory record: a retried block must not
        # leave a phantom record
        _append_manifest(outdir, rec)
        records.append(rec)
        tprobes.note_file_ok()

    pipe = PipelinedDispatch(dispatch_depth)

    def try_dispatch_file(path, block):
        """The pipeline's dispatch phase: queue this file's program on
        the card when the family has an async route and the campaign
        rides the healthy per-file rung. None -> the synchronous path
        (also taken for the first file, which builds the detector, and
        for a family whose ``dispatch`` returns None)."""
        if not pipe.enabled or route is None or rz.health_cfg is None:
            return None
        if route.current(_BUCKET) != ("file", 1):
            return None
        if scale_mismatch(block):
            return None   # detect_one fails it per-file on the sync path
        try:
            return route.program.dispatch(
                block.trace, with_health=True, clip=rz.health_cfg.clip_abs,
            )
        except Exception:  # noqa: BLE001 — surfaces on the sync path
            return None

    def finalize_file(path, block, t0, infl) -> None:
        while True:  # transfer+detect attempts (block already read)
            rz.attempt(path)
            try:
                detect_one(path, block, t0, inflight=infl)
            except Exception as exc:  # noqa: BLE001
                infl = None   # retries re-dispatch synchronously
                if rz.dispose(path, exc) == "retry":
                    continue
            break

    def drain_pipe() -> None:
        for tok, queued in pipe.drain():
            finalize_file(*tok, queued)

    with telemetry.campaign_trace(outdir, trace, kind="per-file",
                                  n_files=len(files), family=rz.family):
        i = 0
        while i < len(pending):
            # one stream per contiguous run of healthy files; a failure
            # mid-stream kills the generator, so restart it after the
            # culprit — or AT it, when its failure class earned a retry
            stream = stream_strain_blocks(
                pending[i:], selected_channels, pend_metas[i:],
                interrogator=interrogator, prefetch=prefetch, engine=engine,
                as_numpy=True, wire=wire, read_deadline_s=read_deadline_s,
                fault_plan=fault_plan,
            )
            while True:
                path = pending[i] if i < len(pending) else None
                try:
                    block = next(stream)
                except StopIteration:
                    i = len(pending)
                    break
                except Exception as exc:  # noqa: BLE001 — per-file isolation
                    # queued in-flight files are earlier, healthy reads:
                    # finalize them first so their records precede the
                    # culprit's
                    drain_pipe()
                    rz.attempt(path)
                    if rz.dispose(path, exc) == "next":
                        i += 1
                    break  # restart the stream either way
                t0 = time.perf_counter()
                infl = try_dispatch_file(path, block)
                if infl is None:
                    drain_pipe()
                    finalize_file(path, block, t0, None)
                else:
                    for tok, queued in pipe.submit((path, block, t0), infl):
                        finalize_file(*tok, queued)
                i += 1
            stream.close()
        drain_pipe()   # end of segment: the one remaining sync
        rz.flush_tallies()
    return CampaignResult(outdir=outdir, records=records)


def run_campaign_batched(
    files: Sequence[str],
    selected_channels,
    outdir: str,
    metadata=None,
    batch: int = 4,
    bucket="pow2",
    resume: bool = True,
    max_failures: int | None = None,
    interrogator: str = "optasense",
    prefetch: int = 2,
    engine: str = "h5py",
    wire: str = "conditioned",
    family: str = "mf",
    in_flight: int = 2,
    serial: bool | None = None,
    persistent_cache: bool | str = True,
    retry=None,
    health=True,
    read_deadline_s: float | None = None,
    dispatch_deadline_s: float | None = None,
    preflight: bool | None = None,
    dispatch_depth: int | None = None,
    trace: bool | None = None,
    cost_cards: bool | None = None,
    quality: bool | None = None,
    fault_plan=None,
    device=None,
    **detector_kwargs,
) -> CampaignResult:
    """Single-card BATCHED campaign: ``batch`` files a program step.

    The slab assembler (``io.stream.stream_batched_slabs``) coalesces
    consecutive same-bucket files into one ``[B, channel, time]`` stack on
    ``device`` (None: the card, through pinned memory; ``"cpu"``: the
    plain versions on the CPU), and the batched facade
    (``parallel.batch.batched_detector_for``) detects the whole slab in
    one program and one packed read. ``family`` is ``"mf"`` (the
    default) or ``"spectro"``; spectro requires ``wire="conditioned"``
    and buckets exactly (its thresholds depend on the record's own
    maximum, so a padded record would change its picks).
    ``detector_kwargs`` go to :func:`family_detector` (``design=`` loads
    a design checkpoint instead of designing). ``serial`` picks the
    facade's mode (None: serial on the CPU, batched on the card).

    Manifest/resume/picks-artifact contract, per-file fault isolation and
    ``max_failures`` are exactly :func:`run_campaign`'s. A whole-slab
    device failure retries the slab's files through the unbatched
    per-file route on the assembler's host blocks before failing any of
    them, so one poisoned file costs one file, not a slab. Resource
    exhaustion rides the elastic downshift ladder: ``B -> B/2 -> ... ->
    1`` (sub-slabs rebuilt from the host blocks), then the per-file
    route, the tiled view and the host; the winning rung is STICKY per
    bucket, one ``downshift`` event a move, and per-file picks are
    bitwise equal at every card rung of one facade mode.

    ``dispatch_depth`` (None: ``DAS_DISPATCH_DEPTH``, 2) arms depth-D
    pipelined dispatch: while a bucket rides its top rung, slab k+1's
    program is queued on the card BEFORE slab k's packed fetch, and the
    fetch waits on slab k's own event. The card then holds up to
    ``dispatch_depth`` slabs in flight on top of the stream's
    ``in_flight`` stacks. ``dispatch_deadline_s`` arms the dispatch
    watchdog; a wedged dispatch becomes ``status="timeout"``.

    ``persistent_cache`` is accepted so callers' code runs and does
    nothing: eager PyTorch compiles no program per shape, and the
    kernels' build directory persists on its own; nothing is written.
    ``preflight``, ``cost_cards`` and ``quality`` are not in this slice:
    on (or on by their env defaults) they raise, naming their item.
    """
    from ..config import dispatch_deadline_default
    from ..io.stream import SlabReadError, stream_batched_slabs, subdivide_slab
    from ..parallel.batch import batched_detector_for, trim_picks
    from ..parallel.dispatch import PipelinedDispatch, resolve_watchdogged

    if family not in FAMILIES:
        raise ValueError(
            f"unknown detector family {family!r}; batched campaigns serve "
            f"{', '.join(FAMILIES)}"
        )
    if family in ("gabor", "learned"):
        raise _not_in_slice(f"family={family!r}", "Gabor and learned")
    if family != "mf" and wire != "conditioned":
        raise ValueError(
            f"family={family!r} requires wire='conditioned': the family's "
            "prefilter consumes strain, not stored-dtype counts (got "
            f"wire={wire!r})"
        )
    if family != "mf" and bucket != "exact":
        log.info("family=%s campaigns bucket exactly (overriding "
                 "bucket=%r): padded records would change data-dependent "
                 "thresholds", family, bucket)
        bucket = "exact"
    _check_not_in_slice(quality=quality, cost_cards=cost_cards, preflight=preflight)
    device = resolve_device(device)   # before any file is read
    if dispatch_deadline_s is None:
        dispatch_deadline_s = dispatch_deadline_default()
    os.makedirs(outdir, exist_ok=True)
    fsck.startup_check(outdir, label="campaign")
    metas = _normalize_metas(metadata, list(files))
    records: List[FileRecord] = []
    pending, pend_idx = _split_resume(list(files), outdir, resume, records)
    pend_metas = [metas[j] for j in pend_idx]
    rz = _Resilience(outdir, records, max_failures, retry, health)
    rz.family = family
    fail = rz.fail
    with_health = rz.health_cfg is not None
    clip = rz.health_cfg.clip_abs if with_health else None
    ladder = DownshiftLadder(rz, outdir, batch=batch, family=family,
                             stages=family_ladder_stages(family))

    dets: Dict[tuple, object] = {}       # bucket -> batched facade
    progs: Dict[tuple, DetectorProgram] = {}   # per-file-rung programs

    def _bucket_key(slab) -> tuple:
        return (int(slab.stack.shape[1]), slab.bucket_ns,
                np.dtype(np.asarray(slab.blocks[0].trace).dtype).name)

    def detector_for(slab):
        key = _bucket_key(slab)
        bdet = dets.get(key)
        if bdet is None:
            per_file_det = family_detector(
                family, slab.blocks[0].metadata, selected_channels,
                (key[0], slab.bucket_ns), wire=wire, device=device,
                **detector_kwargs,
            )
            bdet = batched_detector_for(per_file_det, serial=serial,
                                        trace_shape=(key[0], slab.bucket_ns))
            dets[key] = bdet
            progs[key] = program_for(per_file_det)
            ladder.set_engines(key, progs[key].engines)
        return bdet

    def dispatched(paths, rung, fn):
        """One watchdogged device dispatch (the chaos dispatch hook fires
        inside the deadline, ``parallel.dispatch.resolve_watchdogged``)."""
        return resolve_watchdogged(fn, paths, rung, dispatch_deadline_s,
                                   fault_plan, family=family)

    def padded_block(slab, k):
        tr = np.asarray(slab.blocks[k].trace)
        padded = np.zeros((tr.shape[0], slab.bucket_ns), tr.dtype)
        padded[:, : tr.shape[1]] = tr
        return padded

    def per_file_fallback(slab, k, prog, rung=("file", 1)):
        """The unbatched per-file route on the assembler's host block
        (never the device slab): the packed-overflow exact path AND the
        degradation ladder's second rung, at the bucket's sticky rung."""
        padded = padded_block(slab, k)

        def fn():
            return prog.detect(rung, padded, n_real=slab.n_real[k],
                               with_health=with_health, clip=clip)

        return dispatched([slab.paths[k]], rung, fn)

    def run_rung(slab, rung, bdet, ok, inflight=None):
        """The whole slab's entries at one ladder rung — aligned with
        ``range(slab.n_valid)``; raises on the rung's failure (resource
        -> the caller downshifts). ``inflight`` (the depth-D pipeline's
        dispatched handle) short-circuits the top batched rung: the
        watchdogged call is its packed fetch."""
        prog = progs[_bucket_key(slab)]
        stage, b = rung
        if stage == "batched":
            if b >= batch:
                if inflight is not None:
                    return dispatched(list(slab.paths), rung, inflight.resolve)
                subs = [slab]
            else:
                # re-bucket from the assembler's HOST blocks
                subs = subdivide_slab(slab, b)
            entries = []
            for sub in subs:
                def fn(sub=sub):
                    return bdet.detect_batch(
                        sub.stack, n_real=sub.n_real, n_valid=sub.n_valid,
                        with_health=with_health, health_clip=clip,
                    )
                entries.extend(dispatched(list(sub.paths), rung, fn)[: sub.n_valid])
            return entries
        entries = []
        for k in range(slab.n_valid):
            if not ok[k]:
                entries.append(None)   # dispositioned by the scale guard
                continue
            padded = padded_block(slab, k)

            def fn(padded=padded, k=k):
                return prog.detect(rung, padded, n_real=slab.n_real[k],
                                   with_health=with_health, clip=clip)
            entries.append(dispatched([slab.paths[k]], rung, fn))
        return entries

    def handle_slab(slab, inflight=None) -> None:
        bdet = detector_for(slab)
        det = bdet.det
        key = _bucket_key(slab)
        ok = []
        for k in range(slab.n_valid):
            meta_k = slab.blocks[k].metadata
            if (wire == "raw" and meta_k is not None
                    and meta_k.scale_factor != det.metadata.scale_factor):
                fail(slab.paths[k], ValueError(
                    f"scale_factor {meta_k.scale_factor!r} != detector "
                    f"scale {det.metadata.scale_factor!r}; wire='raw' "
                    "conditions with one scale — use wire='conditioned' "
                    "for heterogeneous file sets"
                ))
                ok.append(False)
            else:
                ok.append(True)
        t0 = time.perf_counter()
        degraded = False
        recovered = False
        results = None
        rung = ladder.current(key)
        try:
            if fault_plan is not None:
                # the slab is one transfer and one program: a planned
                # transfer/detect fault against ANY of its files fails
                # the slab (the ladder then isolates the culprit), and
                # the culprit's slab-level firing IS one of its attempts
                for k in range(slab.n_valid):
                    if ok[k]:
                        try:
                            fault_plan.on_transfer(slab.paths[k])
                            fault_plan.on_detect(slab.paths[k])
                        except Exception:
                            rz.attempt(slab.paths[k])
                            raise
            if inflight is not None and rung != ("batched", batch):
                # the bucket downshifted between this slab's dispatch and
                # its resolve: abandon the handle, run at the sticky rung
                inflight = None
            while True:   # the elastic ladder: downshift on resource
                try:
                    results = run_rung(slab, rung, bdet, ok, inflight=inflight)
                    break
                except Exception as exc:  # noqa: BLE001
                    # never reuse a handle past a failure
                    inflight = None
                    fclass = faults.classify_failure(exc)
                    if fclass == "fatal":
                        raise
                    if fclass == "resource":
                        nxt = ladder.downshift(key, rung, exc)
                        if nxt is not None:
                            rung = nxt
                            recovered = True
                            continue
                    raise   # non-resource / exhausted: degrade per-file
        except Exception as exc:  # noqa: BLE001 — degradation ladder
            if faults.classify_failure(exc) == "fatal":
                raise
            faults.count("degradations")
            log.warning(
                "batched slab of %d files failed (%s: %s); degrading to "
                "the unbatched per-file route", slab.n_valid,
                type(exc).__name__, exc,
            )
            degraded = True
        wall = time.perf_counter() - t0
        _h_slab_wall.observe(wall)
        for k in range(slab.n_valid):
            if not ok[k]:
                continue  # its slot computed with the wrong scale: discard
            path = slab.paths[k]
            use_fallback = degraded or results[k] is None
            # the fallback honors the bucket's sticky placement: never
            # below the per-file rung, never above a rung that ran out
            pf_rung = max(("file", 1), ladder.current(key), key=faults.rung_rank)
            file_recovered = recovered
            while True:
                rz.attempt(path)
                try:
                    if use_fallback:
                        if fault_plan is not None and degraded:
                            fault_plan.on_transfer(path)
                            fault_plan.on_detect(path)
                        picks, thresholds, stats = per_file_fallback(
                            slab, k, progs[key], rung=pf_rung)
                        exec_rung = pf_rung
                    else:
                        entry = results[k]
                        picks, thresholds = entry[0], entry[1]
                        stats = entry[2] if with_health and len(entry) > 2 else {}
                        exec_rung = rung
                    rz.check_health(path, stats, rung=faults.rung_label(exec_rung))
                    picks = trim_picks(picks, slab.n_real[k])
                    if fault_plan is not None:
                        fault_plan.detect_succeeded()
                    _file_record(
                        outdir, path, picks, thresholds,
                        round(wall / max(slab.n_valid, 1), 3), records,
                        attempts=rz.state.n_attempts(path),
                        health=dict(stats or {}), family=bdet.family,
                        rung=faults.rung_label(exec_rung),
                    )
                    if file_recovered:
                        rz.tally("oom_recoveries")
                except Exception as exc:  # noqa: BLE001 — per-file isolation
                    if use_fallback and faults.classify_failure(exc) == "resource":
                        # resource exhaustion in the fallback too: keep
                        # descending (a route change, not a retry — refund
                        # the attempt)
                        nxt = ladder.downshift(key, pf_rung, exc)
                        if nxt is not None:
                            rz.state.unattempt(path)
                            pf_rung = nxt
                            file_recovered = True
                            continue
                    if rz.dispose(path, exc) == "retry":
                        # the already-fetched batch entry would fail
                        # identically: retries take the per-file route
                        use_fallback = True
                        continue
                break

    pipe = PipelinedDispatch(dispatch_depth)

    def try_dispatch(slab):
        """The pipeline's dispatch phase: queue the slab's program on the
        card when its bucket rides the healthy top rung. None (-> the
        synchronous path) for downshifted buckets, batch=1 campaigns and
        dispatch-time failures, which the sync path re-raises at this
        slab's own turn."""
        if not pipe.enabled or batch < 2:
            return None
        try:
            bdet = detector_for(slab)
            if ladder.current(_bucket_key(slab)) != ("batched", batch):
                return None
            return bdet.dispatch_batch(
                slab.stack, n_real=slab.n_real, n_valid=slab.n_valid,
                with_health=with_health, health_clip=clip,
            )
        except CampaignAborted:
            raise
        except Exception:  # noqa: BLE001 — surfaces on the sync path
            return None

    def finalize(slab, inflight) -> None:
        try:
            with telemetry.span("slab", index0=slab.index0, n_files=slab.n_valid,
                                bucket_ns=slab.bucket_ns,
                                pipelined=inflight is not None):
                handle_slab(slab, inflight)
        except CampaignAborted:
            raise
        except Exception as exc:  # noqa: BLE001 — slab-level guard
            # a whole-slab failure the ladder could not absorb (detector
            # build, fatal-class program error) fails each of its files
            # not already dispositioned this run
            if faults.classify_failure(exc) == "fatal":
                raise
            dispositioned = {r.path for r in records}
            for path in slab.paths:
                if path not in dispositioned:
                    fail(path, exc)

    def drain_pipe() -> None:
        for queued_slab, queued_infl in pipe.drain():
            finalize(queued_slab, queued_infl)

    # the transfer pipeline must keep at least `depth` slabs moving or the
    # dispatch pipeline starves waiting on the copy
    stream_in_flight = max(in_flight, pipe.depth) if pipe.enabled else in_flight

    with telemetry.campaign_trace(outdir, trace, kind="batched",
                                  n_files=len(files), batch=batch, family=family):
        i = 0
        while i < len(pending):
            slabs = stream_batched_slabs(
                pending[i:], selected_channels, pend_metas[i:], batch=batch,
                bucket=bucket, interrogator=interrogator, prefetch=prefetch,
                engine=engine, wire=wire, in_flight=stream_in_flight,
                read_deadline_s=read_deadline_s, fault_plan=fault_plan,
                device=device,
            )
            try:
                for slab in slabs:
                    infl = try_dispatch(slab)
                    if infl is None:
                        # ineligible slab: flush the queue (FIFO — manifest
                        # order is file order) and run it synchronously
                        drain_pipe()
                        finalize(slab, None)
                    else:
                        for tok in pipe.submit(slab, infl):
                            finalize(*tok)
                    del slab
                drain_pipe()
            except SlabReadError as exc:
                # the assembler attributes the culprit's index: transient
                # earns a retry AT the culprit, timeout / corrupt / data
                # disposition it and resume past; queued slabs hold earlier
                # (healthy) files and are finalized first
                drain_pipe()
                path = pending[i + exc.index]
                rz.attempt(path)
                if rz.dispose(path, exc.cause) == "retry":
                    i = i + exc.index
                else:
                    i = i + exc.index + 1
                continue
            finally:
                slabs.close()
            i = len(pending)
        rz.flush_tallies()
    return CampaignResult(outdir=outdir, records=records)


def _compact_batch_picks(positions, selected, n_samples: int, capacity: int):
    """Per-(template, file) slot picks ``[nT, B, C, K]`` -> packed
    ``(chan [nT, B, cap], time [nT, B, cap], count [nT, B])`` on the
    device (``ops.peaks.compact_picks_rowmajor``), with the time-padding
    mask ``positions < n_samples`` applied first, in row-major order —
    the sharded campaigns' pick transfer."""
    from ..ops import peaks as peak_ops

    nT, B, C, K = positions.shape
    sel = selected & (positions < n_samples)
    rows, times, cnt = peak_ops.compact_picks_rowmajor(
        positions.reshape(nT * B, C, K), sel.reshape(nT * B, C, K), capacity
    )
    return (rows.reshape(nT, B, capacity), times.reshape(nT, B, capacity),
            cnt.reshape(nT, B))


def _probe_healthy(pairs, interrogator, fail, expect_shape=None, rz=None):
    """Probe (path, metadata) pairs; returns ``(healthy [(path, spec)],
    spec0)``. ``expect_shape=(nx, ns)`` routes shape mismatches to
    ``fail`` (one step serves one shape). ``rz`` (a :class:`_Resilience`)
    adds the classified contract at probe granularity: transient probe
    failures retry with backoff, the rest disposition per class."""
    from ..io.stream import _probe

    healthy, spec0 = [], None
    for path, meta_j in pairs:
        while True:
            if rz is not None:
                rz.attempt(path)
            try:
                spec = _probe(path, interrogator, meta_j)
                shape = (spec.meta.nx, spec.meta.ns)
                want = expect_shape or (
                    (spec0.meta.nx, spec0.meta.ns) if spec0 is not None else shape
                )
                if shape != want:
                    raise ValueError(
                        f"file shape {shape} != campaign shape {want} "
                        "(one step serves one shape; run mismatched files "
                        "in their own campaign)"
                    )
                if spec0 is None:
                    spec0 = spec
                healthy.append((path, spec))
            except Exception as exc:  # noqa: BLE001 — per-file isolation
                if rz is not None:
                    if rz.dispose(path, exc) == "retry":
                        continue
                else:
                    fail(path, exc)
            break
    return healthy, spec0


def _file_record(outdir, path, picks, thresholds, wall_s, records,
                 write: bool = True, attempts: int = 1,
                 health=None, family: str = "", rung: str = "") -> FileRecord:
    """One completed file's bookkeeping — artifact + manifest + record.
    ``family``/``rung`` stamp the detector family and the route rung
    that actually executed."""
    if write:
        picks_file = _save_picks(outdir, path, picks, thresholds)
    else:
        picks_file = _picks_path(outdir, path)
    rec = FileRecord(
        path=path, status="done",
        n_picks={n: int(p.shape[1]) for n, p in picks.items()},
        wall_s=wall_s, picks_file=picks_file,
        attempts=max(int(attempts), 1), health=dict(health or {}),
        family=family, rung=rung,
    )
    # manifest BEFORE the in-memory record: a retried call must not leave
    # a phantom record
    if write:
        _append_manifest(outdir, rec)
    records.append(rec)
    tprobes.note_file_ok()
    return rec


def run_campaign_sharded(*args, **kwargs):
    """The SPMD campaign over a device mesh; not in this slice."""
    raise _not_in_slice("run_campaign_sharded", "Multi-GPU")


def run_campaign_multiprocess(*args, **kwargs):
    """The multi-host campaign; not in this slice."""
    raise _not_in_slice("run_campaign_multiprocess", "Multi-GPU")


def summarize_campaign(outdir: str) -> dict:
    """Aggregate a campaign's manifest + picks artifacts into a report
    dict: per-file status/pick counts, totals per template, and a
    ``[file x channel]`` detection-count matrix."""
    recs = artifacts.read_records(_manifest_path(outdir))
    events = [r for r in recs if "path" not in r and "event" in r]
    downshift_events = [e for e in events if e["event"] == "downshift"]
    mesh_events = [e for e in events if e["event"] == "mesh_downshift"]
    counters = {"downshifts": 0, "oom_recoveries": 0, "watchdog_timeouts": 0}
    for e in events:
        if e["event"] == "counters":
            for k in counters:
                counters[k] += int(e.get(k, 0))
    # keep only each path's LAST record: resume runs and retried files
    # append fresh records
    latest = {r["path"]: r for r in recs if "path" in r}
    by_family: Dict[str, Dict[str, int]] = {}
    for r in latest.values():
        fam = by_family.setdefault(r.get("family", ""), {})
        fam[r["status"]] = fam.get(r["status"], 0) + 1
    rungs: Dict[str, int] = {}
    for r in latest.values():
        if r["status"] == "done":
            label = r.get("rung", "") or "?"
            rungs[label] = rungs.get(label, 0) + 1
    done = [r for r in latest.values() if r["status"] == "done"]
    failed = [r for r in latest.values() if r["status"] == "failed"]
    quarantined = [r for r in latest.values() if r["status"] == "quarantined"]
    timeout = [r for r in latest.values() if r["status"] == "timeout"]

    totals: Dict[str, int] = {}
    density = {}                  # name -> [n_files x nx] counts
    nx = 0
    for rec in done:
        picks = load_picks(rec["picks_file"])
        for name, pk in picks.items():
            totals[name] = totals.get(name, 0) + pk.shape[1]
            if pk.shape[1]:
                nx = max(nx, int(pk[0].max()) + 1)
    for name in totals:
        density[name] = np.zeros((len(done), nx), dtype=np.int32)
    for fi, rec in enumerate(done):
        picks = load_picks(rec["picks_file"])
        for name, pk in picks.items():
            if pk.shape[1]:
                np.add.at(density[name][fi], pk[0].astype(int), 1)
    return {
        "n_done": len(done),
        "n_failed": len(failed),
        "n_quarantined": len(quarantined),
        "n_timeout": len(timeout),
        "total_attempts": sum(int(r.get("attempts", 1)) for r in latest.values()),
        "downshifts": counters["downshifts"],
        "oom_recoveries": counters["oom_recoveries"],
        "watchdog_timeouts": counters["watchdog_timeouts"],
        "downshift_ledger": downshift_events,
        "mesh_downshifts": mesh_events,
        "by_family": by_family,
        "rungs": rungs,
        "failed_paths": [r["path"] for r in failed],
        "quarantined_paths": [r["path"] for r in quarantined],
        "timeout_paths": [r["path"] for r in timeout],
        "total_picks": totals,
        "files": [{"path": r["path"], "n_picks": r["n_picks"],
                   "wall_s": r["wall_s"], "family": r.get("family", ""),
                   "rung": r.get("rung", "")} for r in done],
        "density": density,
    }


def plot_campaign_density(summary: dict, dx_km: float = 2.042e-3, show=None):
    """Detection-density heatmaps of a :func:`summarize_campaign` dict;
    not in this slice."""
    raise _not_in_slice("plot_campaign_density", "Workflow mains and plots")
