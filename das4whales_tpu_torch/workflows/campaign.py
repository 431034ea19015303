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
  ``B -> B/2 -> ... -> 1`` (a splittable template bank first as two T/2
  sub-bank dispatches at each B), then the per-file route, the
  channel-tiled view and finally the host (the CPU), each move a sticky
  ``downshift`` event in the manifest;
* **depth-D pipelined dispatch** (``parallel.dispatch``) — slab k+1's
  program is queued on the card before slab k's packed fetch is taken.

Entries run on the card unless the caller passes ``device="cpu"``; they
resolve the device before reading a file, so a run without a card
raises instead of failing every file.

Three switches observe or place a run without changing its picks:
``preflight`` (the memory preflight, ``utils.memory``: each bucket
starts at the largest rung whose program fits ``DAS_HBM_BUDGET_GB``),
``cost_cards`` (``telemetry.costs``: a card a priced program,
``<outdir>/cost_cards.json``) and ``quality`` (``telemetry.quality``: a
manifest ``quality`` event and ``<outdir>/quality.json``).

:func:`plot_campaign_density` draws a summary's density figure
(matplotlib, imported where it draws). The sharded and multi-process
campaigns run over a device mesh
(:func:`run_campaign_sharded`, :func:`run_campaign_multiprocess`; every
rank calls them, ``parallel.mesh``).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import time
from dataclasses import dataclass, field
from typing import Dict, List, Sequence

import numpy as np

from .. import faults, fsck
from ..config import as_health_config
from ..io.stream import stream_strain_blocks
from ..models.matched_filter import MatchedFilterDetector
from ..telemetry import costs as tcosts
from ..telemetry import metrics as tmetrics
from ..telemetry import probes as tprobes
from ..telemetry import quality as tquality
from ..telemetry import trace as telemetry
from ..utils import artifacts
from ..utils.device import resolve_device
from ..utils.log import get_logger
from .planner import (  # noqa: F401 — MatchedFilterProgram: the JAX module's name
    DetectorProgram,
    DownshiftLadder,
    MatchedFilterProgram,
    RoutePlanner,
    family_ladder_stages,
    program_for,
)

log = get_logger("das4whales_tpu_torch.campaign")

_h_slab_wall = tmetrics.histogram(
    "das_slab_wall_seconds",
    "wall seconds per batched slab (dispatch through bookkeeping)",
)
_g_preflight_hwm = tmetrics.gauge(
    "das_preflight_hbm_peak_bytes",
    "largest measured program memory peak seen by the memory preflight",
)

MANIFEST = "manifest.jsonl"

#: the quality observatory's tenant label for (single-stream) campaign
#: runs — the service uses real tenant names (service/scheduler.py)
QUALITY_TENANT = "campaign"

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
    #: detector family that processed the file ("mf" | "spectro" | "gabor" |
    #: "learned")
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
    quarantined, timeout — counts toward the tolerance). ``write`` may be
    a callable, asked at each record (a mesh's writer can change)."""
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
        if write() if callable(write) else write:
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
                                       write=lambda: self.write)
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


def _price_rung(bdet, batch: int, dtype, key, program: str, *, with_health: bool,
                clip, use_costs: bool):
    """Price one rung's program (``utils.memory``): with cost cards on, the
    same probe registers the program's card. Feeds the preflight's
    high-water gauge. None off the card."""
    from ..utils import memory as memutils

    if use_costs:
        st = tcosts.capture_batched(bdet, batch, dtype, bucket=tcosts.bucket_label(key),
                                    program=program, with_health=with_health,
                                    health_clip=clip)
    else:
        st = memutils.batched_program_memory(bdet, batch, dtype, with_health=with_health,
                                             health_clip=clip)
    if st is not None:
        _g_preflight_hwm.max(float(st.peak))
    return st


def _preflight_bucket(ladder, key, bdet, dtype, *, batch: int, budget: int, family: str,
                      with_health: bool, clip, use_costs: bool, tenant: str | None = None):
    """The memory preflight of one bucket before its first dispatch: the
    first rung in ladder order whose program fits ``budget`` — the full
    bank at each B, then a splittable bank's T/2 sub-banks at the same B
    (``bank:B``) — pins the bucket's ladder (``DownshiftLadder.pin``,
    ledgered as a preflight downshift); where none fits, the matched
    filter's tiled per-file program is priced, and a family's per-file
    ladder takes over. Returns the reason a bucket fits at no rung (the
    caller skips it), else None. ``tenant`` names the service tenant
    whose share ``budget`` is; the ledgered reasons are the JAX
    package's words for the campaign and for the service."""
    from ..parallel.batch import BatchedMatchedFilterDetector
    from ..utils import memory as memutils

    def price(bd, b_, program):
        return _price_rung(bd, b_, dtype, key, program, with_health=with_health, clip=clip,
                           use_costs=use_costs)

    cands, b = [], batch
    while b >= 1:
        cands.append(b)
        b //= 2
    split = getattr(bdet.det, "supports_bank_split", False)
    rung_cands = []
    for b_ in cands:
        rung_cands.append(("batched", b_))
        if split:
            rung_cands.append(("bank", b_))

    def price_rung(rung_):
        stage_, b_ = rung_
        # the LARGER (ceil) T/2 sub-bank certifies the split pair
        bd = bdet.split_views()[0] if stage_ == "bank" else bdet
        return price(bd, b_, faults.rung_label(rung_))

    gib = f"{budget / 2**30:.2f}"
    svc = tenant is not None
    best = memutils.first_fitting(price_rung, rung_cands, budget)
    if best is not None:
        stage_, b_ = best
        if stage_ == "bank":
            n_t = int(bdet.det.design.templates.shape[0])
            ladder.pin(key, ("bank", b_), (
                f"admission: tenant {tenant} full T={n_t} bank over its {gib} GiB share at "
                f"B={b_}; T/2 sub-banks fit" if svc else
                f"preflight: full T={n_t} bank over budget at B={b_}; T/2 sub-banks fit "
                f"{gib} GiB"))
        elif b_ < batch:
            ladder.pin(key, ("batched", b_) if b_ > 1 else ("file", 1), (
                f"admission: tenant {tenant} largest fitting batch B={b_} under its {gib} GiB "
                "share" if svc else f"preflight: largest fitting batch B={b_} under {gib} GiB"))
        return None
    if family != "mf":
        # family facades have no batched-tiled program to price: the
        # per-file rung starts the family's own ladder
        ladder.pin(key, ("file", 1), (
            f"admission: no (bucket, B) {family} program fits tenant {tenant}'s {gib} GiB "
            "share; per-file ladder takes over" if svc else
            f"preflight: no (bucket, B) {family} program fits {gib} GiB; per-file ladder takes "
            "over"))
        return None
    tiled = BatchedMatchedFilterDetector(bdet.det.tiled_view(), serial=bdet.serial)
    tstats = price(tiled, 1, "tiled")
    if tstats is None or tstats.fits(budget):
        ladder.pin(key, ("tiled", 1), (
            f"admission: tenant {tenant} only the tiled per-file program fits its {gib} GiB "
            "share" if svc else f"preflight: only the tiled per-file program fits {gib} GiB"))
        return None
    need = ("more than the card holds" if tstats.exhausted
            else f"{tstats.peak / 2**30:.2f} GiB")
    if svc:
        return (f"admission: no (bucket, B) program shape fits tenant {tenant}'s HBM share "
                f"({gib} GiB); smallest candidate needs {need} — stream refused before "
                "dispatch")
    return (f"preflight: no (bucket, B) program shape fits DAS_HBM_BUDGET_GB ({gib} GiB); "
            f"smallest candidate needs {need} — skipped before dispatch")


def _ensure_start_card(ladder, key, bdet, dtype, *, with_health: bool, clip) -> None:
    """The bucket's STARTING rung always has a cost card, preflight or not
    (the preflight walk already captured the rungs it priced)."""
    rung0 = ladder.current(key)
    stage0, b0 = rung0
    if stage0 in ("batched", "bank", "file"):
        bd0 = bdet.split_views()[0] if stage0 == "bank" else bdet
        tcosts.ensure_batched_card(bd0, max(1, int(b0)), dtype, bucket=tcosts.bucket_label(key),
                                   program=faults.rung_label(rung0), with_health=with_health,
                                   health_clip=clip)


def _observe_quality(tenant, det, path, picks, thresholds, stats, n_time_samples) -> None:
    """Feed the science-quality observatory one done file: the record is
    derived from the artifacts already in hand — pick counts, the
    fetched thresholds (whose base recovers the envelope peak) and the
    fused health stats. Shared by both campaign entries and the service
    scheduler. A telemetry failure never costs the file record."""
    try:
        design = getattr(det, "design", None)
        fs = float(getattr(design, "fs", 0.0) or 0.0) or float(
            getattr(getattr(det, "metadata", None), "fs", 0.0) or 0.0)
        tquality.OBSERVATORY.observe(tenant, tquality.file_quality(
            path=path, picks=picks, thresholds=thresholds, stats=stats,
            duration_s=(float(n_time_samples) / fs if fs else None),
            thr_factors=tquality.threshold_factor_map(design),
            thr_scope=str(getattr(det, "threshold_scope", "global")),
        ))
    except Exception:  # noqa: BLE001 — observability never costs a record
        log.debug("quality observe failed for %s", path, exc_info=True)


def _flush_quality(outdir: str, tenants) -> None:
    """End-of-run quality surfaces: one manifest ``quality`` event and the
    durable ``quality.json`` next to the manifest."""
    try:
        snap = tquality.OBSERVATORY.snapshot(tenants=tenants)
        if not snap["tenants"]:
            return
        _append_event(outdir, {"event": "quality", "tenants": snap["tenants"],
                               "drifting": snap["drifting"]})
        tquality.export_json(os.path.join(outdir, "quality.json"), tenants=tenants)
    except OSError:
        pass   # the campaign outcome wins
    except Exception:  # noqa: BLE001 — decorative surfaces only
        log.debug("quality flush failed for %s", outdir, exc_info=True)


def _export_cards(outdir: str) -> None:
    if tcosts.REGISTRY.cards():
        try:
            tcosts.export_json(os.path.join(outdir, "cost_cards.json"))
        except OSError:
            pass   # the campaign outcome wins


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
    constructor's: ``MatchedFilterDetector``'s for ``"mf"``, the
    ``campaign_detector``'s of ``workflows.spectrodetect`` and
    ``workflows.gabordetect`` for ``"spectro"`` and ``"gabor"``; for
    ``"learned"`` either ``params=`` and ``cfg=`` or ``pretrained=``
    (default ``"fin_cnn"``, ``models.learned.load_pretrained``) plus
    ``LearnedDetector``'s keyword arguments.

    ``design=`` (a ``MatchedFilterDesign`` or the path of its checkpoint,
    written by either package's ``save_design``) builds the matched
    filter — or the spectro or Gabor family's prefilter — on that design instead
    of designing it: the f-k mask's host design is tens of seconds at the
    canonical shape, so a campaign over many days of one cable loads it.
    Its ``trace_shape`` must be the bucket's."""
    design = _load_design(detector_kwargs.pop("design", None))
    if design is not None and tuple(design.trace_shape) != tuple(trace_shape):
        raise ValueError(f"design shape {tuple(design.trace_shape)} != bucket shape "
                         f"{tuple(trace_shape)}")
    if family == "mf":
        # the campaign configuration: sparse picks, no kept correlograms
        kw = dict(pick_mode="sparse", keep_correlograms=False, **detector_kwargs)
        if design is not None:
            return MatchedFilterDetector.from_design(design, metadata, wire=wire,
                                                     device=device, **kw)
        return MatchedFilterDetector(metadata, selected_channels, trace_shape, wire=wire,
                                     device=device, **kw)
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
    if family == "gabor":
        from .gabordetect import campaign_detector

        return campaign_detector(metadata, selected_channels, trace_shape, device=device,
                                 design=design, **detector_kwargs)
    if family != "learned":
        raise ValueError(
            f"unknown detector family {family!r}; expected one of {FAMILIES}"
        )
    if design is not None:
        raise ValueError("family='learned' has no f-k design; design= does not apply")
    from ..models.learned import LearnedDetector, load_pretrained

    kw = dict(detector_kwargs)
    if "params" in kw and "cfg" in kw:
        params, cfg = kw.pop("params"), kw.pop("cfg")
    else:
        params, cfg = load_pretrained(kw.pop("pretrained", "fin_cnn"))
    return LearnedDetector(params, cfg, device=device, **kw)


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
    family: str = "mf",
    preflight: bool | None = None,
    cost_cards: bool | None = None,
    **detector_kwargs,
) -> CampaignResult:
    """Detect over ``files`` one file a program, tolerating per-file
    failures and resuming past completed work.

    ``detector=None`` builds the ``family``'s detector (``"mf"``: a
    ``MatchedFilterDetector``; ``"spectro"``, ``"gabor"``: the family's
    eval adapter; ``"learned"``: a ``LearnedDetector``, the pretrained
    ``fin_cnn`` by default; all but ``"mf"`` on the conditioned wire
    only) on ``device`` (None: the card; ``"cpu"``: the plain versions
    on the CPU) from the first readable
    file's shape/metadata (extra ``detector_kwargs`` pass through,
    ``design=`` among them: :func:`family_detector`). The JAX package's
    ``run_campaign`` has no ``family``: a family's detector comes there
    as ``detector=``, which this one takes too.
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
    ``<outdir>/trace.json``). ``quality`` (None: the ``DAS_QUALITY`` env
    default) arms the science-quality observatory exactly like
    :func:`run_campaign_batched`. ``preflight`` (None:
    ``DAS_MEMORY_PREFLIGHT``) prices the per-file program at the first
    file's shape and starts the run at the first rung of the family's
    ladder (per-file, bank split, tiled, host) whose program fits
    ``DAS_HBM_BUDGET_GB``; ``cost_cards`` (None: ``DAS_COST_CARDS``)
    registers the starting rung's cost card and writes
    ``<outdir>/cost_cards.json``. The JAX package's ``run_campaign``
    takes ``quality`` only. None of the three changes a pick.
    """
    from ..config import dispatch_deadline_default, hbm_budget_bytes, memory_preflight_default
    from ..parallel.batch import batched_detector_for
    from ..parallel.dispatch import PipelinedDispatch
    from ..utils import memory as memutils

    if preflight is None:
        preflight = memory_preflight_default()
    use_costs = tcosts.resolve_enabled(cost_cards)
    use_quality = tquality.resolve_enabled(quality)
    if use_quality:
        # one campaign run = one drift baseline
        tquality.OBSERVATORY.fresh(QUALITY_TENANT)
    if detector is None:
        if family not in FAMILIES:
            raise ValueError(f"unknown detector family {family!r}; expected one of {FAMILIES}")
        if family != "mf" and wire != "conditioned":
            raise ValueError(f"family={family!r} requires wire='conditioned' (got "
                             f"wire={wire!r})")
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
        rz.family = family   # detector=None builds the family's detector
    _BUCKET = "campaign"   # one unbatched campaign = one sticky ladder key

    placed = False
    skip_reason: str | None = None   # the preflight: no card rung fits

    def place_route(block) -> None:
        """The preflight and the starting rung's cost card, once, at the
        first file's shape (the route's one ladder key). The preflight
        prices the card's rungs only: the host rung is the ladder's
        out-of-memory recovery, never a placement. Where no card rung fits,
        the run is skipped before dispatch (a ``preflight_skip`` event;
        every file ``failed``), as a batched bucket is."""
        nonlocal placed, skip_reason
        placed = True
        if not (preflight or use_costs):
            return
        shape = tuple(int(v) for v in np.shape(block.trace))
        dt = np.asarray(block.trace).dtype
        key = (shape[0], shape[1], np.dtype(dt).name)
        with_health = rz.health_cfg is not None
        clip = rz.health_cfg.clip_abs if with_health else None

        def facade(rung):
            stage = rung[0]
            if stage == "bank":
                # the LARGER (ceil) T/2 sub-bank certifies the split pair
                return facade(("file", 1)).split_views()[0]
            det_r = route.program._det_at(stage)
            if stage == "tiled" and route.program.family == "mf":
                det_r = det_r.tiled_view()
            return batched_detector_for(det_r, serial=True, trace_shape=shape)

        priced = {}

        def price_rung(rung):
            priced[rung] = _price_rung(facade(rung), 1, dt, key, faults.rung_label(rung),
                                       with_health=with_health, clip=clip, use_costs=use_costs)
            return priced[rung]

        if preflight:
            budget = hbm_budget_bytes()
            cands = [r for r in route.ladder.rungs(_BUCKET) if r[0] != "host"]
            with telemetry.span("preflight", bucket=str(key)):
                best = memutils.first_fitting(price_rung, cands, budget)
                if best is None:
                    last = priced[cands[-1]]
                    need = ("more than the card holds" if last.exhausted
                            else f"{last.peak / 2**30:.2f} GiB")
                    skip_reason = (
                        f"preflight: no program shape fits DAS_HBM_BUDGET_GB "
                        f"({budget / 2**30:.2f} GiB); smallest candidate needs {need} — "
                        "skipped before dispatch")
                    event = {"event": "preflight_skip", "bucket": list(key),
                             "reason": skip_reason}
                    sid = telemetry.current_span_id()
                    if sid is not None:
                        event["span_id"] = sid
                    _append_event(outdir, event)
                    log.warning("campaign: %s", skip_reason)
                    return
            if best != route.current(_BUCKET):
                route.ladder.pin(_BUCKET, best, (
                    f"preflight: the per-file program over {budget / 2**30:.2f} GiB; "
                    f"{faults.rung_label(best)} is the first rung that fits"))
        rung0 = route.current(_BUCKET)
        if use_costs and rung0[0] != "host":
            tcosts.ensure_batched_card(facade(rung0), 1, dt, bucket=tcosts.bucket_label(key),
                                       program=faults.rung_label(rung0),
                                       with_health=with_health, health_clip=clip)

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
                family, block.metadata, selected_channels, np.shape(block.trace),
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
        if not placed:
            place_route(block)
        if skip_reason is not None:
            rz.fail(path, RuntimeError(skip_reason))
            return
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
        if use_quality:
            _observe_quality(QUALITY_TENANT, detector, path, picks, thresholds, stats,
                             np.asarray(block.trace).shape[-1])

    pipe = PipelinedDispatch(dispatch_depth)

    def try_dispatch_file(path, block):
        """The pipeline's dispatch phase: queue this file's program on
        the card when the family has an async route and the campaign
        rides the healthy per-file rung. None -> the synchronous path
        (also taken for the first file, which builds the detector, and
        for a family whose ``dispatch`` returns None)."""
        if not pipe.enabled or not placed or skip_reason is not None or rz.health_cfg is None:
            return None
        if not route.program.supports_fused_health or route.current(_BUCKET) != ("file", 1):
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
        if use_costs:
            _export_cards(outdir)
        if use_quality:
            _flush_quality(outdir, [QUALITY_TENANT])
    return CampaignResult(outdir=outdir, records=records)


class SlabExecutor:
    """The batched per-slab executor: a bucket's batched facade and
    per-file program, built at its first slab; the memory preflight before
    that slab's first dispatch; the elastic downshift ladder; the per-file
    degradation; the health gate; the manifest and picks bookkeeping.
    :func:`run_campaign_batched` drives one over its slab stream, and the
    service (``service.scheduler.TenantRuntime``) one a tenant, so a
    tenant's picks are bitwise its standalone campaign's.

    ``rz``, ``ladder``, ``outdir`` and ``records`` are the run's (or the
    tenant's) resilience, ladder and durable state; ``family``, ``wire``,
    ``channels``, ``device`` and ``detector_kwargs`` build each bucket's
    detector (:func:`family_detector`), ``serial`` its facade's mode.
    ``preflight`` prices each bucket against
    ``budget_bytes`` (None: ``DAS_HBM_BUDGET_GB`` when it runs), after
    ``before_probe()`` (the caller drains its dispatch pipe there).
    ``quality_tenant`` is the observatory label a done file feeds (None:
    off). ``tenant`` names a service tenant (None: a campaign): its pins
    and skips take the service's words. ``on_settled(path,
    status)`` hears each terminal disposition the executor writes.
    """

    def __init__(self, *, rz, ladder, outdir: str, records: List[FileRecord], family: str,
                 batch: int, wire: str, channels, device, serial, detector_kwargs,
                 dispatch_deadline_s, fault_plan, preflight: bool, use_costs: bool,
                 quality_tenant: str | None = None, tenant: str | None = None,
                 budget_bytes: int | None = None, before_probe=None, on_settled=None):
        self.rz, self.ladder, self.outdir, self.records = rz, ladder, outdir, records
        self.family, self.batch, self.wire, self.channels = family, int(batch), wire, channels
        self.device, self.serial = device, serial
        self.detector_kwargs = dict(detector_kwargs)
        self.dispatch_deadline_s, self.fault_plan = dispatch_deadline_s, fault_plan
        self.preflight, self.use_costs = bool(preflight), bool(use_costs)
        self.quality_tenant, self.tenant = quality_tenant, tenant
        self.budget_bytes, self.before_probe, self.on_settled = budget_bytes, before_probe, on_settled
        self.with_health = rz.health_cfg is not None
        self.clip = rz.health_cfg.clip_abs if self.with_health else None
        self.dets: Dict[tuple, object] = {}            # bucket -> batched facade
        self.progs: Dict[tuple, DetectorProgram] = {}  # per-file-rung programs
        self.skip_buckets: Dict[tuple, str] = {}       # preflight: nothing fits
        self._stager = None

    def _fail(self, path: str, exc: Exception, **kw) -> None:
        self.rz.fail(path, exc, **kw)
        self._settled(path, self.records[-1].status)

    def _settled(self, path: str, status: str) -> None:
        if self.on_settled is not None:
            self.on_settled(path, status)

    @staticmethod
    def bucket_key(slab) -> tuple:
        return (int(slab.stack.shape[1]), slab.bucket_ns,
                np.dtype(np.asarray(slab.blocks[0].trace).dtype).name)

    def _preflight(self, key, bdet, slab) -> None:
        """The bucket's memory preflight (:func:`_preflight_bucket`): a
        pin, or a skip ledgered as ``preflight_skip`` (a campaign) or
        ``admission_skip`` (a tenant)."""
        from ..config import hbm_budget_bytes

        if self.before_probe is not None:
            self.before_probe()
        budget = self.budget_bytes if self.budget_bytes is not None else hbm_budget_bytes()
        reason = _preflight_bucket(
            self.ladder, key, bdet, np.asarray(slab.blocks[0].trace).dtype, batch=self.batch,
            budget=budget, family=self.family, with_health=self.with_health, clip=self.clip,
            use_costs=self.use_costs, tenant=self.tenant)
        if reason is None:
            return
        self.skip_buckets[key] = reason
        if self.tenant is None:
            event = {"event": "preflight_skip", "bucket": list(key), "reason": reason}
            sid = telemetry.current_span_id()   # the enclosing preflight span
            if sid is not None:
                event["span_id"] = sid
        else:
            event = {"event": "admission_skip", "tenant": self.tenant, "bucket": list(key),
                     "reason": reason}
        _append_event(self.outdir, event)
        log.warning("%sbucket %s: %s", f"tenant {self.tenant} " if self.tenant else "", key,
                    reason)

    def detector_for(self, slab):
        """The slab's bucket facade, built (and preflighted) at its first
        slab."""
        from ..parallel.batch import batched_detector_for

        key = self.bucket_key(slab)
        bdet = self.dets.get(key)
        if bdet is not None:
            return bdet
        per_file_det = family_detector(
            self.family, slab.blocks[0].metadata, self.channels, (key[0], slab.bucket_ns),
            wire=self.wire, device=self.device, **self.detector_kwargs)
        bdet = batched_detector_for(per_file_det, serial=self.serial,
                                    trace_shape=(key[0], slab.bucket_ns))
        self.dets[key] = bdet
        self.progs[key] = program_for(per_file_det)
        self.ladder.set_engines(key, self.progs[key].engines)
        if getattr(bdet.det, "supports_bank_split", False):
            # a splittable template bank: this bucket's ladder gains the
            # bank-split rungs (T/2 sub-banks before B shrinks)
            self.ladder.enable_bank_split(key)
        if self.preflight:
            span_kw = {} if self.tenant is None else {"tenant": self.tenant}
            with telemetry.span("preflight", bucket=str(key), **span_kw):
                self._preflight(key, bdet, slab)
        if self.use_costs and key not in self.skip_buckets:
            _ensure_start_card(self.ladder, key, bdet, np.asarray(slab.blocks[0].trace).dtype,
                               with_health=self.with_health, clip=self.clip)
        return bdet

    def try_dispatch(self, slab):
        """The pipeline's dispatch phase: queue the slab's program on the
        card when its bucket rides the healthy top rung. None (-> the
        synchronous path) for downshifted or skipped buckets, batch-1 runs
        and dispatch-time failures, which the sync path re-raises at this
        slab's own turn."""
        if self.batch < 2:
            return None
        try:
            bdet = self.detector_for(slab)
            key = self.bucket_key(slab)
            if key in self.skip_buckets or self.ladder.current(key) != ("batched", self.batch):
                return None
            stack = slab.stack
            if isinstance(stack, np.ndarray) and self.device.type == "cuda":
                # a host slab (the service's slicer) crosses through pinned
                # buffers on a side stream: a pageable copy would wait for
                # every program already queued
                from ..io.staging import PinnedStager

                if self._stager is None:
                    self._stager = PinnedStager(self.device, n_buffers=2)
                stack = PinnedStager.hand_over(*self._stager.place(stack))
            return bdet.dispatch_batch(stack, n_real=slab.n_real, n_valid=slab.n_valid,
                                       with_health=self.with_health, health_clip=self.clip)
        except CampaignAborted:
            raise
        except Exception:  # noqa: BLE001 — surfaces on the sync path
            return None

    def _dispatched(self, paths, rung, fn):
        """One watchdogged device dispatch (the chaos dispatch hook fires
        inside the deadline, ``parallel.dispatch.resolve_watchdogged``)."""
        from ..parallel.dispatch import resolve_watchdogged

        return resolve_watchdogged(fn, paths, rung, self.dispatch_deadline_s, self.fault_plan,
                                   family=self.family)

    def _per_file(self, slab, k, prog, rung):
        """File ``k`` through the unbatched per-file route on the
        assembler's host block (never the device slab), at ``rung``."""
        tr = np.asarray(slab.blocks[k].trace)
        padded = np.zeros((tr.shape[0], slab.bucket_ns), tr.dtype)
        padded[:, : tr.shape[1]] = tr

        def fn():
            return prog.detect(rung, padded, n_real=slab.n_real[k],
                               with_health=self.with_health, clip=self.clip)

        return self._dispatched([slab.paths[k]], rung, fn)

    def _run_rung(self, slab, rung, bdet, ok, inflight=None):
        """The whole slab's entries at one ladder rung — aligned with
        ``range(slab.n_valid)``; raises on the rung's failure (resource
        -> the caller downshifts). ``inflight`` (the depth-D pipeline's
        dispatched handle) short-circuits the top batched rung: the
        watchdogged call is its packed fetch."""
        from ..io.stream import subdivide_slab

        with_health, clip = self.with_health, self.clip
        stage, b = rung
        if stage == "batched":
            if b >= self.batch:
                if inflight is not None:
                    return self._dispatched(list(slab.paths), rung, inflight.resolve)
                subs = [slab]
            else:
                # re-bucket from the assembler's HOST blocks
                subs = subdivide_slab(slab, b)
            entries = []
            for sub in subs:
                def fn(sub=sub):
                    return bdet.detect_batch(sub.stack, n_real=sub.n_real, n_valid=sub.n_valid,
                                             with_health=with_health, health_clip=clip)
                entries.extend(self._dispatched(list(sub.paths), rung, fn)[: sub.n_valid])
            return entries
        if stage == "bank":
            # the bank-split rung: the same batch as two T/2 sub-bank
            # dispatches (``split_views``), their picks merged — bitwise the
            # full bank's under the per_template scope. Only the first half
            # computes the health stats: they describe the input block.
            subs = [slab] if b >= self.batch else subdivide_slab(slab, b)
            half_a, half_b = bdet.split_views()
            entries = []
            for sub in subs:
                halves = []
                for j, hdet in enumerate((half_a, half_b)):
                    def fn(sub=sub, hdet=hdet, j=j):
                        return hdet.detect_batch(
                            sub.stack, n_real=sub.n_real, n_valid=sub.n_valid,
                            with_health=with_health and j == 0, health_clip=clip)
                    halves.append(self._dispatched(list(sub.paths), rung, fn)[: sub.n_valid])
                for ea, eb in zip(*halves):
                    if ea is None or eb is None:
                        entries.append(None)   # overflow: the exact per-file route
                        continue
                    merged = ({**ea[0], **eb[0]}, {**ea[1], **eb[1]})
                    entries.append(merged + (ea[2],) if with_health else merged)
            return entries
        prog = self.progs[self.bucket_key(slab)]
        return [self._per_file(slab, k, prog, rung) if ok[k] else None   # None: scale guard
                for k in range(slab.n_valid)]

    def handle_slab(self, slab, inflight=None) -> None:
        """One slab through the elastic ladder, the per-file degradation,
        the health gate and the bookkeeping of each of its files."""
        from ..parallel.batch import trim_picks

        bdet = self.detector_for(slab)
        det = bdet.det
        key = self.bucket_key(slab)
        fault_plan = self.fault_plan
        rz, ladder = self.rz, self.ladder
        if key in self.skip_buckets:
            for k in range(slab.n_valid):
                self._fail(slab.paths[k], RuntimeError(self.skip_buckets[key]))
            return
        ok = []
        for k in range(slab.n_valid):
            meta_k = slab.blocks[k].metadata
            if (self.wire == "raw" and meta_k is not None
                    and meta_k.scale_factor != det.metadata.scale_factor):
                self._fail(slab.paths[k], ValueError(
                    f"scale_factor {meta_k.scale_factor!r} != detector "
                    f"scale {det.metadata.scale_factor!r}; wire='raw' "
                    "conditions with one scale — use wire='conditioned' "
                    "for heterogeneous file sets"))
                ok.append(False)
            else:
                ok.append(True)
        t0 = time.perf_counter()
        degraded = recovered = False
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
            if inflight is not None and rung != ("batched", self.batch):
                # the bucket downshifted between this slab's dispatch and
                # its resolve: abandon the handle, run at the sticky rung
                inflight = None
            while True:   # the elastic ladder: downshift on resource
                try:
                    results = self._run_rung(slab, rung, bdet, ok, inflight=inflight)
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
                "%sbatched slab of %d files failed (%s: %s); degrading to "
                "the unbatched per-file route", f"tenant {self.tenant}: " if self.tenant else "",
                slab.n_valid, type(exc).__name__, exc,
            )
            degraded = True
        wall = time.perf_counter() - t0
        _h_slab_wall.observe(wall)
        if self.use_costs and not degraded and results is not None:
            # live utilization: this slab's wall against its rung's card
            tcosts.note_slab_resolved(tcosts.bucket_label(key), faults.rung_label(rung),
                                      tcosts._program_engine(bdet), wall, device=self.device)
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
                        picks, thresholds, stats = self._per_file(slab, k, self.progs[key],
                                                                  pf_rung)
                        exec_rung = pf_rung
                    else:
                        entry = results[k]
                        picks, thresholds = entry[0], entry[1]
                        stats = entry[2] if self.with_health and len(entry) > 2 else {}
                        exec_rung = rung
                    rz.check_health(path, stats, rung=faults.rung_label(exec_rung))
                    picks = trim_picks(picks, slab.n_real[k])
                    if fault_plan is not None:
                        fault_plan.detect_succeeded()
                    _file_record(
                        self.outdir, path, picks, thresholds,
                        round(wall / max(slab.n_valid, 1), 3), self.records,
                        attempts=rz.state.n_attempts(path),
                        health=dict(stats or {}), family=bdet.family,
                        rung=faults.rung_label(exec_rung),
                    )
                    self._settled(path, "done")
                    if self.quality_tenant is not None:
                        _observe_quality(self.quality_tenant, det, path, picks, thresholds,
                                         stats, slab.n_real[k])
                    if file_recovered:
                        rz.tally("oom_recoveries")
                except CampaignAborted:
                    raise
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
                    self._settled(path, self.records[-1].status)
                break

    def finalize(self, slab, inflight=None, **span) -> None:
        """:meth:`handle_slab` under a ``slab`` span (``span`` adds its
        attributes), with the slab-level guard: a whole-slab failure the
        ladder could not absorb (detector build, fatal-class program
        error) fails each of its files not already dispositioned this
        run. A ``CampaignAborted`` passes through."""
        try:
            with telemetry.span("slab", **span, index0=slab.index0, n_files=slab.n_valid,
                                bucket_ns=slab.bucket_ns, pipelined=inflight is not None):
                self.handle_slab(slab, inflight)
        except CampaignAborted:
            raise
        except Exception as exc:  # noqa: BLE001 — slab-level guard
            if faults.classify_failure(exc) == "fatal":
                raise
            dispositioned = {r.path for r in self.records}
            for path in slab.paths:
                if path not in dispositioned:
                    self._fail(path, exc)


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
    default), ``"spectro"``, ``"gabor"`` or ``"learned"``; all but
    ``"mf"`` require ``wire="conditioned"`` and bucket exactly (their
    picks depend on the record's own samples and length, so a padded
    record would change them).
    ``detector_kwargs`` go to :func:`family_detector` (``design=`` loads
    a design checkpoint instead of designing). ``serial`` picks the
    facade's mode (None: serial on the CPU, batched on the card).

    Manifest/resume/picks-artifact contract, per-file fault isolation and
    ``max_failures`` are exactly :func:`run_campaign`'s. A whole-slab
    device failure retries the slab's files through the unbatched
    per-file route on the assembler's host blocks before failing any of
    them, so one poisoned file costs one file, not a slab. Resource
    exhaustion rides the elastic downshift ladder: ``B -> B/2 -> ... ->
    1`` (sub-slabs rebuilt from the host blocks; with a splittable
    template bank each B first as two T/2 sub-bank dispatches, ``bank:B``),
    then the per-file route, the tiled view and the host; the winning rung is STICKY per
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

    ``preflight`` (None: the ``DAS_MEMORY_PREFLIGHT`` env default) runs
    the memory preflight per bucket before its first dispatch
    (``utils.memory``: each candidate program measured once on the card,
    after the dispatch pipe drained): the bucket starts at the first
    rung in ladder order whose program fits ``DAS_HBM_BUDGET_GB`` (the
    move ledgered as a ``downshift`` event with ``"preflight": true``),
    and a bucket no rung fits is skipped before dispatch
    (``preflight_skip`` event; its files ``failed``). On the CPU nothing
    is priced and every bucket starts at the top rung. ``cost_cards``
    (None: ``DAS_COST_CARDS``) registers a cost card a priced program
    (``telemetry.costs``), the live roofline gauges a resolved slab, and
    ``<outdir>/cost_cards.json``. ``quality`` (None: ``DAS_QUALITY``)
    feeds the science-quality observatory a done file
    (``telemetry.quality``), then a manifest ``quality`` event and
    ``<outdir>/quality.json``. None of the three changes a pick.
    """
    from ..config import dispatch_deadline_default, memory_preflight_default
    from ..io.stream import SlabReadError, stream_batched_slabs
    from ..parallel.dispatch import PipelinedDispatch

    if family not in FAMILIES:
        raise ValueError(
            f"unknown detector family {family!r}; batched campaigns serve "
            f"{', '.join(FAMILIES)}"
        )
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
    if preflight is None:
        preflight = memory_preflight_default()
    use_costs = tcosts.resolve_enabled(cost_cards)
    use_quality = tquality.resolve_enabled(quality)
    device = resolve_device(device)   # before any file is read
    if use_quality:
        # one campaign run = one drift baseline
        tquality.OBSERVATORY.fresh(QUALITY_TENANT)
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
    ladder = DownshiftLadder(rz, outdir, batch=batch, family=family,
                             stages=family_ladder_stages(family))

    ex = SlabExecutor(
        rz=rz, ladder=ladder, outdir=outdir, records=records, family=family, batch=batch,
        wire=wire, channels=selected_channels, device=device, serial=serial,
        detector_kwargs=detector_kwargs, dispatch_deadline_s=dispatch_deadline_s,
        fault_plan=fault_plan, preflight=preflight, use_costs=use_costs,
        quality_tenant=QUALITY_TENANT if use_quality else None,
    )
    pipe = PipelinedDispatch(dispatch_depth)

    def try_dispatch(slab):
        return ex.try_dispatch(slab) if pipe.enabled else None

    def drain_pipe() -> None:
        for queued_slab, queued_infl in pipe.drain():
            ex.finalize(queued_slab, queued_infl)

    # a preflight's probe must see no other slab's buffers: finish the queue
    ex.before_probe = drain_pipe

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
                        ex.finalize(slab, None)
                    else:
                        for tok in pipe.submit(slab, infl):
                            ex.finalize(*tok)
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
        if use_costs:
            _export_cards(outdir)
        if use_quality:
            _flush_quality(outdir, [QUALITY_TENANT])
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


# per-(template, file) pack capacity for the sharded campaigns' pick
# transfer; counts above it take the exact full-grid route
_PICK_PACK_CAP = 1 << 18


def _adaptive_sharded_steps(factory, design, mesh, pick_k0: int = 64, max_peaks: int = 256,
                            **kw):
    """``(K0 pack, full-capacity topk)`` step pair over ``mesh``: the
    adaptive-K policy of ``ops.peaks.picks_with_escalation`` across the
    mesh's programs. The full-capacity step is built lazily, only if a
    batch saturates; :func:`_run_adaptive` decides the rerun for every
    rank at once."""
    step_k0 = factory(design, mesh, outputs="picks", max_peaks=pick_k0, pick_method="pack",
                      **kw)
    full: dict = {}

    def step_full(stack):
        if "fn" not in full:
            full["fn"] = factory(design, mesh, outputs="picks", max_peaks=max_peaks,
                                 pick_method="topk", **kw)
        return full["fn"](stack)

    return step_k0, step_full


def _run_adaptive(step_k0, step_full, stack, mesh):
    """One batch through the adaptive pair IN LOCKSTEP: the K0 step, then
    the saturation flag all-reduced (MAX) over the whole mesh, and the
    full-capacity rerun on every rank when any row of any rank saturated
    (a rank that reran alone would leave its peers in other collectives).
    Returns ``(picks, thresholds, escalated)``."""
    import torch

    from ..parallel import collectives as coll

    sp_picks, thres = step_k0(stack)
    flag = sp_picks.saturated.any().to(torch.int32).reshape(1)
    faults.count("syncs")
    if int(coll.pmax(flag, mesh, None).item()):
        sp_picks, thres = step_full(stack)
        return sp_picks, thres, True
    return sp_picks, thres, False


def _read_local(spec, sel, wire: str, engine: str, interrogator: str):
    """One file's block of this rank's channel slice (host numpy)."""
    blk = next(stream_strain_blocks([spec.path], sel.to_list(), [spec.meta],
                                    interrogator=interrogator, engine=engine,
                                    as_numpy=True, wire=wire))
    return blk.trace


def _mesh_campaign(files, selected_channels, outdir, mesh, *, metadata, batch, resume,
                   max_failures, interrogator, engine, relative_threshold, hf_factor,
                   fused_bandpass, wire, retry, design, rung, on_read_error, elastic):
    """The campaign over a ``(file, channel)`` mesh, on every rank (the
    body of :func:`run_campaign_sharded` and
    :func:`run_campaign_multiprocess`)."""
    import types
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from ..config import ChannelSelection
    from ..io.stream import _local_selection
    from ..models.matched_filter import design_matched_filter
    from ..ops.peaks import compacted_to_host
    from ..parallel import collectives as coll
    from ..parallel.mesh import Sharding
    from ..parallel.pipeline import make_sharded_mf_step
    from ..eval import sharded_picks_to_dict

    writer = mesh.rank == 0
    if writer:
        os.makedirs(outdir, exist_ok=True)
        # only the writer repairs (a torn tail, stray tmps); the others
        # read the manifest after it
        fsck.startup_check(outdir, label="campaign")
        # an earlier run's elastic check-ins would seal this run's at once
        shutil.rmtree(os.path.join(outdir, ELASTIC_DIR), ignore_errors=True)
    coll.barrier(mesh)
    metas = _normalize_metas(metadata, list(files))
    records: List[FileRecord] = []
    pending, pend_idx = _split_resume(list(files), outdir, resume, records)
    pend_metas = [metas[j] for j in pend_idx]
    rz = _Resilience(outdir, records, max_failures, retry, health=False, write=writer)
    rz.family = "mf"
    fail = rz.fail
    # every rank probes every pending file (an attribute read for HDF5),
    # and keeps only what every rank could probe: the healthy lists must
    # be the same on every rank, or the ranks fall out of lockstep
    healthy_specs, spec0 = _probe_healthy(zip(pending, pend_metas), interrogator, fail, rz=rz)
    ok_probe = torch.tensor([p in {q for q, _ in healthy_specs} for p in pending],
                            dtype=torch.int32, device=mesh.device)
    if pending:
        ok_probe = coll.pmin(ok_probe, mesh, None).cpu().numpy().astype(bool)
        mine = {q for q, _ in healthy_specs}
        for p, good in zip(pending, ok_probe):
            if not good and p in mine:
                fail(p, RuntimeError("probe failed on another rank of the mesh"))
        healthy_specs = [(p, sp) for p, sp in healthy_specs
                         if ok_probe[pending.index(p)]]
        spec0 = healthy_specs[0][1] if healthy_specs else None
    if wire == "raw" and healthy_specs:
        # the raw wire conditions with ONE scale (spec0's); another one
        # fails at probe granularity
        for p, sp in healthy_specs:
            if sp.meta.scale_factor != spec0.meta.scale_factor:
                fail(p, ValueError(
                    f"scale_factor {sp.meta.scale_factor!r} != campaign scale "
                    f"{spec0.meta.scale_factor!r}; wire='raw' conditions with one scale "
                    "— use wire='conditioned' for heterogeneous file sets"))
        healthy_specs = [(p, sp) for p, sp in healthy_specs
                         if sp.meta.scale_factor == spec0.meta.scale_factor]
    if not healthy_specs:
        rz.flush_tallies()
        coll.barrier(mesh)
        return CampaignResult(outdir=outdir, records=records)

    sel = ChannelSelection.from_list(selected_channels)
    C, ns = sel.n_channels(spec0.meta.nx), spec0.meta.ns
    design = _load_design(design)
    if design is None:
        design = design_matched_filter((C, ns), selected_channels, spec0.meta)
    elif tuple(design.trace_shape) != (C, ns):
        raise ValueError(f"design for {tuple(design.trace_shape)} does not fit the "
                         f"campaign's [{C} x {ns}] files")
    pf = mesh.shape.get("file", 1)
    if batch is None:
        batch = max(int(pf), 1)
    if batch % pf:
        raise ValueError(f"batch {batch} not divisible by the mesh's file axis {pf}")
    wire_kw = {"wire": "raw", "scale_factor": spec0.meta.scale_factor} if wire == "raw" else {}
    fac_vec, _ = design.resolve_threshold_policy(hf_factor)
    names = design.template_names

    def layout(mesh):
        """This rank's part of a batch on ``mesh``: its file slots, its
        channel slice, and the adaptive step pair."""
        per = batch // mesh.shape.get("file", 1)
        lo = per * mesh.coords.get("file", 0)
        local_sel = _local_selection(sel, spec0.meta.nx, Sharding(mesh, ("channel", None)), 0) \
            if "channel" in mesh.shape else sel
        c_local = C // mesh.shape.get("channel", 1)
        steps = _adaptive_sharded_steps(
            make_sharded_mf_step, design, mesh, relative_threshold=relative_threshold,
            hf_factor=hf_factor, fused_bandpass=fused_bandpass, **wire_kw)
        return types.SimpleNamespace(mesh=mesh, per=per, lo=lo, local_sel=local_sel,
                                     c_off=c_local * mesh.coords.get("channel", 0),
                                     steps=steps, writer=mesh.rank == 0)

    def read_group(group, lay):
        """This rank's slots of a batch: ``{slot: trace | exception}``."""
        out = {}
        for k in range(lay.lo, min(lay.lo + lay.per, len(group))):
            try:
                out[k] = _read_local(group[k][1], lay.local_sel, wire, engine, interrogator)
            except Exception as exc:  # noqa: BLE001 — settled in lockstep below
                out[k] = exc
        return out

    def run_batch(group, got, lay):
        """One batch in lockstep on ``lay.mesh``: the read status, the step,
        the gathered picks, the records (the writer alone writes)."""
        mesh, per, lo, c_off = lay.mesh, lay.per, lay.lo, lay.c_off
        t0 = time.perf_counter()
        n_real = len(group)
        ok_local = torch.ones(batch, dtype=torch.int32, device=mesh.device)
        errs = {}
        for k, v in got.items():
            if isinstance(v, Exception):
                ok_local[k] = 0
                errs[k] = f"{type(v).__name__}: {v}"
        ok = coll.pmin(ok_local, mesh, None).cpu().numpy().astype(bool)
        if on_read_error == "abort" and not ok[:n_real].all():
            bad = [group[k][0] for k in range(n_real) if not ok[k]]
            raise RuntimeError(f"read failed after a clean probe on {bad} "
                               f"({errs or 'on another rank'}); a half-read batch "
                               "cannot be attributed, the run stops")
        like = next((v for v in got.values() if not isinstance(v, Exception)), None)
        c_local = C // mesh.shape.get("channel", 1)
        stack = np.zeros((per, c_local, ns), like.dtype if like is not None else np.float32)
        for k, v in got.items():
            if not isinstance(v, Exception):
                stack[k - lo] = v
        x = torch.from_numpy(stack).to(mesh.device)
        sp_picks, thres, _esc = _run_adaptive(*lay.steps, x, mesh)
        nT, _B, Cr, K = sp_picks.positions.shape
        cap = min(Cr * K, _PICK_PACK_CAP)
        rows_d, times_d, cnt_d = _compact_batch_picks(sp_picks.positions,
                                                      sp_picks.selected, ns, cap)
        faults.count("syncs")
        packed = compacted_to_host(rows_d, times_d, cnt_d, cap)
        host_picks = None
        if packed is None:     # pack overflow: the exact full-grid route
            host_picks = types.SimpleNamespace(
                positions=sp_picks.positions.cpu().numpy(),
                selected=sp_picks.selected.cpu().numpy())
        base = thres.detach().cpu().numpy().astype(np.float32)
        local = {}
        for k in range(lo, min(lo + per, n_real)):
            j = k - lo
            if host_picks is None:
                rows_np, times_np, cnt = packed
                pk = {name: np.asarray([rows_np[i, j, :cnt[i, j]] + c_off,
                                        times_np[i, j, :cnt[i, j]]])
                      for i, name in enumerate(names)}
            else:
                pk = {name: v + np.array([[c_off], [0]])
                      for name, v in sharded_picks_to_dict(
                          host_picks, names, file_index=j, n_samples=ns).items()}
            thr = {name: float(base[i, j] if base.ndim == 2 else base[j]) * float(fac_vec[i])
                   for i, name in enumerate(names)}
            local[k] = (pk, thr)
        parts = coll.all_gather_object((mesh.coords.get("channel", 0), local), mesh)
        wall = time.perf_counter() - t0
        # an elastic rerun replays the whole in-flight batch: a file already
        # recorded gains no second record
        recorded = {r.path for r in records}
        for k in range(n_real):
            path = group[k][0]
            if path in recorded:
                continue
            if not ok[k]:
                fail(path, RuntimeError(errs.get(k, "read failed (see the owning "
                                                    "rank's log)")))
                continue
            shards = sorted((c, loc[k]) for c, loc in parts if k in loc)
            picks = {name: np.concatenate([pt[0][name] for _, pt in shards], axis=1)
                     .astype(np.int64) for name in names}
            _file_record(outdir, path, picks, shards[0][1][1],
                         round(wall / max(n_real, 1), 3), records, write=lay.writer,
                         family="mf", rung=rung)

    lay = layout(mesh)
    groups = [healthy_specs[s:s + batch] for s in range(0, len(healthy_specs), batch)]
    rebuilds, gi = 0, 0
    with ThreadPoolExecutor(max_workers=1, thread_name_prefix="das-mesh-read") as pool:
        nxt = pool.submit(read_group, groups[0], lay)
        while gi < len(groups):
            got = nxt.result()
            if gi + 1 < len(groups):
                nxt = pool.submit(read_group, groups[gi + 1], lay)   # read ahead
            try:
                run_batch(groups[gi], got, lay)
            except Exception as exc:
                if not elastic or faults.classify_failure(exc) == "fatal":
                    raise
                if rebuilds >= _MAX_MESH_REBUILDS:
                    log.error("elastic recovery exhausted after %d mesh rebuilds", rebuilds)
                    raise
                rebuilds += 1
                if gi + 1 < len(groups):
                    nxt.result()             # the read-ahead was laid out for the old mesh
                new_mesh = _rebuild_mesh_after_device_loss(lay.mesh, C, exc, outdir, rebuilds)
                lay = layout(new_mesh)
                rz.write = lay.writer
                nxt = pool.submit(read_group, groups[gi], lay)   # only this batch reruns
                continue
            gi += 1
    rz.flush_tallies()
    # the writer's artifacts are complete before any rank returns
    coll.barrier(lay.mesh)
    return CampaignResult(outdir=outdir, records=records)


#: the elastic campaign's survivor check-ins, under the outdir
ELASTIC_DIR = ".elastic"

#: the elastic campaign gives up after this many mesh rebuilds: a failure
#: that survives repeated shrinking is not a lost device
_MAX_MESH_REBUILDS = 4

#: a rank's bound on probing its own device; a survivor waits for the
#: others to check in this long past the process group's collective
#: timeout (a peer still blocked in a collective with the failed rank gets
#: there within it): a wedged card neither fails nor answers, and a dead
#: rank never checks in
_DEVICE_PROBE_DEADLINE_S = 30.0


def _probe_own_device(device) -> bool:
    """Whether this rank's device answers a transfer and compute round
    trip within :data:`_DEVICE_PROBE_DEADLINE_S` (a lost card raises, a
    wedged one times out; the probe thread is abandoned). On a card the
    probe first returns the allocator's cache."""
    import torch

    def probe():
        if torch.device(device).type == "cuda":
            # the check-in's wait can be long: the cache goes back to the
            # card, which other processes may share
            torch.cuda.empty_cache()
        x = torch.ones(8, dtype=torch.float32).to(device)
        return float(x.sum().cpu()) == 8.0

    try:
        return bool(faults.call_with_deadline(probe, _DEVICE_PROBE_DEADLINE_S, str(device)))
    except Exception:  # noqa: BLE001 — a dead or wedged device: this rank drops out
        return False


def _survivors(outdir: str, incarnation: int, old_world: int, rank: int,
               healthy: bool, wait_s: float) -> list:
    """The survivor check-in of mesh incarnation ``incarnation``: through
    files under ``outdir`` (a store no single rank hosts), every rank whose
    device probed healthy checks in, then waits for the rest of the old
    world for ``wait_s``; the first rank to finish waiting seals the list
    (an atomic link: first wins) and every rank reads the sealed one, so
    all survivors agree. Returns the sealed sorted old ranks."""
    import json

    d = os.path.join(outdir, ELASTIC_DIR, f"mesh{incarnation}")
    os.makedirs(d, exist_ok=True)

    def checked_in():
        return sorted(int(f[len("rank"):]) for f in os.listdir(d)
                      if f.startswith("rank") and f[len("rank"):].isdigit())

    if healthy:
        tmp = os.path.join(d, f".rank{rank}.tmp")
        with open(tmp, "w") as fh:
            fh.write(str(rank))
        os.replace(tmp, os.path.join(d, f"rank{rank}"))
    sealed = os.path.join(d, "survivors.json")
    t_end = time.monotonic() + wait_s
    while (time.monotonic() < t_end and len(checked_in()) < old_world
           and not os.path.exists(sealed)):
        time.sleep(0.05)
    if not os.path.exists(sealed):
        tmp = os.path.join(d, f".survivors.{rank}.tmp")
        with open(tmp, "w") as fh:
            json.dump(checked_in(), fh)
        try:
            os.link(tmp, sealed)
        except FileExistsError:
            pass
        os.remove(tmp)
    with open(sealed) as fh:
        return json.load(fh)


def _rebuild_mesh_after_device_loss(mesh, n_channels: int, exc, outdir: str,
                                    incarnation: int):
    """The elastic mesh downshift after a step failure, on every rank that
    is still alive: each probes its own device and checks in
    (:func:`_survivors`). A rank whose peer failed alone sits in its next
    collective until the process group's timeout, then comes here too, so
    the check-in waits that timeout plus :data:`_DEVICE_PROBE_DEADLINE_S`.
    Where every rank of the old world checks in, the failure was not a
    device loss and ``exc`` is raised. Else the survivors form a new
    process group (a file rendezvous under ``outdir``, the old group's
    timeout) of the largest count that divides the channel axis, on a
    ``(1, n)`` mesh with the old axis names, and its rank 0 appends the
    ``mesh_downshift`` event. Returns the new mesh. A rank left out of it
    (it checked in after the list was sealed, or the new mesh has no room
    for it) raises, as does every rank where no survivor configuration
    exists: no rank returns a campaign it did not finish."""
    import torch.distributed as dist

    from ..parallel import collectives as coll
    from ..parallel import distributed
    from ..parallel.mesh import make_mesh

    old = mesh.size
    timeout_s = distributed.collective_timeout_s() if mesh.backend else 0.0
    healthy = _probe_own_device(mesh.device)
    alive = _survivors(outdir, incarnation, old, mesh.rank, healthy,
                       timeout_s + _DEVICE_PROBE_DEADLINE_S)
    if len(alive) == old:
        # every device answers: a program or data error would fail the same
        # way on a rebuilt mesh of the same size; surface it instead
        log.error("all %d mesh devices probe healthy; step failure is not device loss — "
                  "re-raising", old)
        raise exc
    n = next((c for c in range(len(alive), 0, -1) if n_channels % c == 0), 0)
    if n < 1:
        log.error("no surviving device configuration divides the channel axis (%d "
                  "survivors of %d)", len(alive), old)
        raise exc
    keep = alive[:n]
    backend = mesh.backend
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    if mesh.rank not in keep:
        why = ("it checked in after the survivors were sealed" if mesh.rank not in alive
               else "the new mesh has no room for it")
        raise RuntimeError(f"elastic recovery: rank {mesh.rank} is not in the rebuilt mesh "
                           f"of ranks {keep} ({why}); its campaign is incomplete") from exc
    new_rank = keep.index(mesh.rank)
    devices = [str(mesh.device)]
    if n > 1:
        rendezvous = os.path.join(outdir, ELASTIC_DIR, f"mesh{incarnation}", "rendezvous")
        distributed.initialize(f"file://{rendezvous}", n, new_rank, backend=backend,
                               timeout_s=timeout_s)
        devices = [None] * n
        dist.all_gather_object(devices, str(mesh.device))
    new_mesh = make_mesh(shape=(1, n), axis_names=tuple(mesh.axis_names), devices=devices,
                         backend=backend if n > 1 else None)
    if new_mesh.rank == 0:
        _append_event(outdir, {"event": "mesh_downshift", "from_devices": old,
                               "to_devices": n, "error": f"{type(exc).__name__}: {exc}"})
    log.warning("elastic recovery: mesh rebuilt on %d/%d devices after %s: %s", n, old,
                type(exc).__name__, exc)
    coll.barrier(new_mesh)
    return new_mesh


def run_campaign_sharded(
    files: Sequence[str],
    selected_channels,
    outdir: str,
    mesh,
    metadata=None,
    batch: int | None = None,
    resume: bool = True,
    max_failures: int | None = None,
    interrogator: str = "optasense",
    prefetch: int = 2,
    engine: str = "h5py",
    relative_threshold: float = 0.5,
    hf_factor: float | None = None,
    fused_bandpass: bool = True,
    wire: str = "conditioned",
    retry=None,
    elastic: bool = True,
    design=None,
) -> CampaignResult:
    """The campaign over a device mesh: every rank of ``mesh``
    (``parallel.mesh.make_mesh``, a ``(file, channel)`` layout) calls it
    with the same arguments; each batch of ``batch`` files (default: the
    file axis's size) detects in ONE lockstep step
    (``parallel.pipeline.make_sharded_mf_step``), data-parallel over
    files and channel-parallel within each. Same manifest, resume and
    picks-artifact contract as :func:`run_campaign`; rung ``"sharded"``.

    Each rank reads only its file slots of each batch and its channel
    slice (one batch read ahead on a thread). The K0 = 64 ``pack`` step
    runs first and the K = 256 ``topk`` rerun follows on every rank when
    any rank saturated (the flag is all-reduced first). The packed picks
    (a few kB) are gathered to every rank; rank 0 alone writes the
    manifest and the picks, and every rank returns the same records.

    Fault isolation is at the probe, as in JAX: every rank probes every
    pending file and unprobeable ones are recorded failed before any batch
    forms; a read error after a clean probe stops the run on every rank.
    ``wire="raw"`` conditions on the mesh with the probed scale factor.
    ``design`` takes a ``MatchedFilterDesign`` of the files' shape or its
    checkpoint path (default: designed here, on every rank). ``prefetch``
    is the JAX signature's (one batch is read ahead).

    ``elastic=True`` is JAX's mesh downshift after a device loss, in the
    multi-controller world: a batch's failure that is not ``"fatal"``
    (``faults.classify_failure``; a peer rank's death fails the next
    collective; a peer of a rank that failed alone waits in its collective
    until the group's timeout) sends every live rank to a survivor check-in
    through files under ``outdir``, each probing its own device within
    ``_DEVICE_PROBE_DEADLINE_S``; the check-in waits the group's timeout
    plus that deadline. Where every rank of the old world checks in, the
    failure was not a device loss and re-raises, as JAX's does. Otherwise
    the survivors form a new process group of the largest count that
    divides the channel axis, at mesh shape ``(1, n)``, append the
    ``mesh_downshift`` event (``from_devices``, ``to_devices``, ``error``),
    rebuild the step pair and rerun the in-flight batch only; at most
    ``_MAX_MESH_REBUILDS`` times. A live rank left out of the new mesh
    raises. ``elastic=False`` re-raises the step's own error."""
    if wire not in ("conditioned", "raw"):
        raise ValueError(f"unknown wire {wire!r}; expected 'conditioned' or 'raw'")
    return _mesh_campaign(files, selected_channels, outdir, mesh, metadata=metadata,
                          batch=batch, resume=resume, max_failures=max_failures,
                          interrogator=interrogator, engine=engine,
                          relative_threshold=relative_threshold, hf_factor=hf_factor,
                          fused_bandpass=fused_bandpass, wire=wire, retry=retry,
                          design=design, rung="sharded", on_read_error="abort",
                          elastic=elastic)


def run_campaign_multiprocess(
    files: Sequence[str],
    selected_channels,
    outdir: str,
    metadata=None,
    resume: bool = True,
    max_failures: int | None = None,
    interrogator: str = "optasense",
    relative_threshold: float = 0.5,
    hf_factor: float | None = None,
    fused_bandpass: bool = True,
    wire: str = "conditioned",
    design=None,
    device=None,
) -> CampaignResult:
    """The multi-host campaign: every rank of the world
    (``parallel.distributed.initialize_from_env``; a world of one without
    torchrun's variables) calls it with the same arguments, on the
    DCN-friendly ``parallel.distributed.global_mesh`` (the file axis
    process-major, one file shard a host). Each host reads only its own
    files; only the packed picks cross hosts. The file list and
    ``outdir`` must be on storage every rank reads; rank 0 alone writes.
    A read failure after a clean probe becomes a zero slot and a
    ``failed`` record on every rank (the ranks stay in lockstep); rung
    ``"multihost"``. ``device``: every rank's device (None: its card by
    ``LOCAL_RANK``; ``"cpu"``). ``wire="raw"`` and per-template banks are
    refused, as in JAX."""
    from ..parallel import distributed

    if wire != "conditioned":
        raise ValueError(
            "run_campaign_multiprocess supports wire='conditioned' only "
            "(raw dtype must be known identically on every process)"
        )
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if device is not None:
        resolve_device(device)
    mesh = distributed.global_mesh(devices=None if device is None else [device] * world)
    d = _load_design(design)
    if d is not None and d.resolve_threshold_policy(hf_factor)[1] == "per_template":
        raise ValueError(
            "run_campaign_multiprocess does not support threshold_scope='per_template' "
            "banks yet; use the single-device, batched or single-host sharded campaign, "
            "or a global-scope bank")
    return _mesh_campaign(files, selected_channels, outdir, mesh, metadata=metadata,
                          batch=int(mesh.shape["file"]), resume=resume,
                          max_failures=max_failures, interrogator=interrogator,
                          engine="h5py", relative_threshold=relative_threshold,
                          hf_factor=hf_factor, fused_bandpass=fused_bandpass, wire=wire,
                          retry=False, design=d, rung="multihost", on_read_error="fail",
                          elastic=False)


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
    """Detection-density heatmaps (file index x cable distance) from a
    :func:`summarize_campaign` dict — one panel per template. Returns the
    matplotlib Figure (headless-safe, like ``viz.plot``)."""
    import matplotlib

    if not show:
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    names = list(summary["density"])
    fig, axes = plt.subplots(1, max(len(names), 1), figsize=(7 * max(len(names), 1), 5),
                             squeeze=False)
    for ax, name in zip(axes[0], names):
        d = summary["density"][name]
        im = ax.imshow(d, aspect="auto", origin="lower", cmap="turbo",
                       extent=[0, d.shape[1] * dx_km, -0.5, d.shape[0] - 0.5])
        ax.set_xlabel("Distance [km]")
        ax.set_ylabel("File index")
        ax.set_title(f"{name}: {summary['total_picks'][name]} picks")
        fig.colorbar(im, ax=ax, label="picks per channel")
    fig.tight_layout()
    if show:
        plt.show()
    return fig
