"""Failure taxonomy, classified retry, and deterministic fault injection
(the port's copy of ``das4whales_tpu.faults``).

At campaign scale, partial failure is the steady state: a multi-day run
WILL see NFS blips, truncated files, NaN-poisoned records, hung readers
and device memory pressure. This module gives the campaign runners
(``workflows.campaign``) the vocabulary to handle each:

* :func:`classify_failure` — every exception maps to one of five
  classes: ``transient`` (retry with backoff), ``corrupt`` (the file is
  bad; disposition ``failed`` immediately), ``data`` (the content is
  bad; disposition ``quarantined``), ``resource`` (the card ran out of
  memory for this program shape: the elastic downshift ladder takes
  over), ``fatal`` (abort the campaign). On the card, resource failures
  arrive as ``torch.cuda.OutOfMemoryError`` (classified by type) or as
  a ``RuntimeError`` whose text names an allocator failure — cuFFT's
  ``CUFFT_ALLOC_FAILED`` among them.
* :class:`RetryPolicy` / :class:`RetryState` — config-driven attempt
  ceilings, exponential backoff with deterministic seeded jitter, and
  per-class campaign-wide retry budgets.
* :class:`DeadlineExceeded` — a per-file wall-clock reader deadline
  (enforced by ``io.stream``'s prefetch threads), and
  :class:`DispatchDeadlineExceeded` with :func:`call_with_deadline`, the
  dispatch watchdog: a hung reader or a wedged device call becomes
  ``status="timeout"`` + campaign-continues.
* :data:`DOWNSHIFT_STAGES`, :func:`rung_rank`, :func:`rung_label` — the
  rung vocabulary of the resource ladder (``workflows.planner``).
* :class:`FaultPlan` — a SEEDED fault schedule injected at the reader /
  transfer / detector / dispatch boundaries, so the whole resilience
  contract is provable under fuzzed fault schedules. It draws the JAX
  package's schedule for the same seed and file names.
* :func:`counters` — process-wide resilience counters (retries,
  degradations, quarantined, timeouts, downshifts, oom_recoveries,
  watchdog_timeouts).
"""

from __future__ import annotations

import errno
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Mapping

import numpy as np

from . import crashpoints  # noqa: F401  (re-export: faults.crashpoints)
from .telemetry import metrics, probes, trace

FAULT_CLASSES = ("transient", "corrupt", "data", "resource", "fatal")

# ---------------------------------------------------------------------------
# Failure taxonomy
# ---------------------------------------------------------------------------

#: OS errnos that name a condition expected to clear on retry (I/O layer
#: blips: NFS staleness, interrupted syscalls, exhausted transient
#: resources) — NOT conditions that name a bad file (ENOENT, EISDIR).
_TRANSIENT_ERRNOS = frozenset(
    getattr(errno, name)
    for name in (
        "EIO", "EAGAIN", "EBUSY", "EINTR", "ESTALE", "ETIMEDOUT",
        "ENETDOWN", "ENETUNREACH", "ENETRESET", "ECONNABORTED",
        "ECONNRESET", "ECONNREFUSED", "EHOSTDOWN", "EHOSTUNREACH",
        "ENOBUFS", "EREMOTEIO", "EDEADLK",
    )
    if hasattr(errno, name)
)

#: Substrings (lowercased) that mark an error text as transient when the
#: exception type alone is ambiguous (h5py and the device runtimes both
#: surface rich conditions as bare OSError/RuntimeError text).
_TRANSIENT_MARKERS = (
    "timed out", "timeout", "temporarily unavailable", "stale file handle",
    "resource busy", "connection reset", "transfer failed", "try again",
    "unavailable: ", "deadline exceeded",
)

#: Substrings (lowercased) that mark a device-side allocation failure in
#: an error's text. These are the ``resource`` class: retrying the SAME
#: program would run out of memory identically, but a smaller batch /
#: the tiled route / the host would succeed — the campaign's elastic
#: downshift ladder handles them (``workflows.planner``). The first
#: group is the JAX package's (its runtime's ``RESOURCE_EXHAUSTED``
#: status and allocator messages; the ladder itself raises that text);
#: the second is the card's libraries: cuFFT's plan allocation
#: (``CUFFT_ALLOC_FAILED``, which PyTorch surfaces as a bare
#: ``RuntimeError``) and cuBLAS's workspace.
_RESOURCE_MARKERS = (
    "resource_exhausted", "resource exhausted", "out of memory",
    "failed to allocate", "allocation failure", "allocating",
    "exceeds the hbm", "hbm space", "exhausts hbm",
    "cufft_alloc_failed", "cublas_status_alloc_failed",
)

#: Exception type names whose message is scanned for the resource markers
#: even where they do not subclass RuntimeError.
_RESOURCE_EXC_NAMES = frozenset({"XlaRuntimeError", "JaxRuntimeError",
                                 "OutOfMemoryError"})


def _oom_types() -> tuple:
    """PyTorch's out-of-memory exception types (``torch.OutOfMemoryError``
    and ``torch.cuda.OutOfMemoryError``, one class on current releases),
    or ``()`` when torch was never imported — this module imports no
    torch."""
    import sys

    torch = sys.modules.get("torch")
    if torch is None:
        return ()
    found = (getattr(torch, "OutOfMemoryError", None),
             getattr(getattr(torch, "cuda", None), "OutOfMemoryError", None))
    return tuple({t for t in found if isinstance(t, type)})


class DataHealthError(RuntimeError):
    """A block's on-device health stats breached the configured
    thresholds (``ops.health``): the file read fine but its CONTENT is
    unusable (NaN-poisoned, ADC-clipped, dead). Classified ``data`` —
    the campaign dispositions it ``quarantined``, never ``done``."""

    fault_class = "data"

    def __init__(self, reason: str, stats: dict | None = None):
        super().__init__(reason)
        self.stats = dict(stats or {})


class DeadlineExceeded(TimeoutError):
    """A file's read exceeded the campaign's per-file wall-clock
    deadline (``io.stream`` ``read_deadline_s``). The campaign records
    ``status="timeout"`` and continues; the hung worker thread is
    abandoned (it cannot be killed) and a fresh stream restarts past the
    culprit."""

    stage = "read"

    def __init__(self, path: str, deadline_s: float | None):
        self.path = path
        self.deadline_s = float(deadline_s) if deadline_s is not None else None
        super().__init__(
            f"{path}: {self.stage} exceeded the "
            f"{self.deadline_s if self.deadline_s is not None else '?'}s "
            f"per-file {self.stage} deadline"
        )


class DispatchDeadlineExceeded(DeadlineExceeded):
    """A device DISPATCH (program launch / the packed fetch) exceeded the
    campaign's ``dispatch_deadline_s`` — the watchdog's complement to the
    read deadline: a wedged CUDA runtime becomes ``status="timeout"`` + campaign-continues instead of a
    stalled run. The hung dispatch thread is abandoned, exactly like a
    hung reader (``call_with_deadline``)."""

    stage = "dispatch"


def call_with_deadline(fn, deadline_s: float | None, path: str):
    """Run ``fn()`` bounded by ``deadline_s`` (None: call inline).

    The dispatch watchdog primitive: ``fn`` runs on a daemon thread and a
    wall-clock deadline bounds the wait, mirroring the reader deadline in
    ``io.stream``. On violation raises :class:`DispatchDeadlineExceeded`
    (the campaign dispositions ``status="timeout"``) and ABANDONS the
    worker — a hung CUDA call cannot be cancelled; its memory returns
    if/when the runtime ever answers. The worker runs on the caller's
    CUDA stream (``parallel.dispatch.resolve_watchdogged`` sets it). ``fn``'s own exception (including a
    ``TimeoutError`` it raised itself) re-raises unchanged.
    """
    if deadline_s is None:
        return fn()
    from concurrent.futures import ThreadPoolExecutor
    from concurrent.futures import TimeoutError as _FutTimeout

    # named so a wedged, abandoned dispatch is attributable in a stack
    # dump / trace (the thread may outlive the campaign by design)
    ex = ThreadPoolExecutor(max_workers=1, thread_name_prefix="das-watchdog")
    try:
        fut = ex.submit(fn)
        try:
            return fut.result(deadline_s)
        except _FutTimeout as exc:
            # py3.11+: concurrent.futures.TimeoutError IS builtin
            # TimeoutError — distinguish fn's own TimeoutError from the
            # wait deadline (same guard as io.stream's read deadline)
            if fut.done() and fut.exception() is exc:
                raise
            raise DispatchDeadlineExceeded(path, deadline_s)
    finally:
        # NEVER join on teardown: the worker may be wedged in the CUDA
        # runtime forever
        ex.shutdown(wait=False, cancel_futures=True)


class FaultInjected(Exception):
    """Marker mixin: this exception came from a :class:`FaultPlan`."""


class InjectedReadError(FaultInjected, OSError):
    """Injected transient I/O failure at the reader boundary."""

    fault_class = "transient"


class InjectedCorruptFile(FaultInjected, OSError):
    """Injected truncated/garbage-file failure (persists across
    attempts, like a real bad file on disk)."""

    fault_class = "corrupt"


class InjectedTransferError(FaultInjected, ConnectionError):
    """Injected host->device transfer failure."""

    fault_class = "transient"


class InjectedDetectorError(FaultInjected, RuntimeError):
    """Injected device-program failure at the detector boundary."""

    fault_class = "transient"


class InjectedResourceExhausted(FaultInjected, RuntimeError):
    """Injected device OOM (``RESOURCE_EXHAUSTED``) at the dispatch
    boundary — fires while the dispatch rung outranks the file's planned
    ``ok_rung`` (the chaos model of a shape that fits a smaller batch)."""

    fault_class = "resource"


class InjectedCrash(FaultInjected, RuntimeError):
    """Injected fatal mid-run crash (the crash-resume drill)."""

    fault_class = "fatal"


def classify_failure(exc: BaseException) -> str:
    """Map an exception to its failure class.

    ``transient`` — expected to clear on retry (I/O blips, transfer
    failures); ``corrupt`` — the FILE is bad, disposition immediately
    (the safe default for anything unrecognized: retrying an unknown
    failure risks an unbounded loop, and pre-taxonomy campaigns failed
    everything immediately, so unknown==corrupt preserves behavior);
    ``data`` — the CONTENT is bad, quarantine; ``resource`` — the
    DEVICE ran out of memory for this program shape
    (``torch.cuda.OutOfMemoryError`` by type; a ``RESOURCE_EXHAUSTED``,
    allocator or ``CUFFT_ALLOC_FAILED`` text): never retried
    identically, but recoverable by the elastic downshift ladder
    (smaller batch, tiled route, host — ``workflows.planner``);
    ``fatal`` — abort the campaign. An exception may self-classify via a
    ``fault_class`` attribute (the injected fault types above and
    :class:`DataHealthError` do).
    """
    declared = getattr(exc, "fault_class", None)
    if declared in FAULT_CLASSES:
        return declared
    oom = _oom_types()
    if oom and isinstance(exc, oom):
        # the caching allocator's failure, whatever its text says
        return "resource"
    if isinstance(exc, (MemoryError, KeyboardInterrupt, SystemExit)):
        return "fatal"
    if (isinstance(exc, RuntimeError)
            or type(exc).__name__ in _RESOURCE_EXC_NAMES):
        # device exhaustion must not land in `corrupt`, which would burn
        # the file with no downshift
        text = str(exc).lower()
        if any(m in text for m in _RESOURCE_MARKERS):
            return "resource"
    if isinstance(exc, (FloatingPointError,)):
        return "data"
    if isinstance(exc, (ConnectionError, InterruptedError, TimeoutError)):
        return "transient"
    if isinstance(exc, OSError):
        if exc.errno in _TRANSIENT_ERRNOS:
            return "transient"
        text = str(exc).lower()
        if any(m in text for m in _TRANSIENT_MARKERS):
            return "transient"
        # h5py surfaces truncated/garbage files as errno-less OSError
        # ("file signature not found", "truncated file", ...)
        return "corrupt"
    return "corrupt"


# ---------------------------------------------------------------------------
# Classified retry with deterministic backoff
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Backoff:
    """One reusable exponential-backoff schedule: "sleep a growing,
    jittered delay until a deadline" — the campaign's transient retries
    (:class:`RetryPolicy`) delegate to it. Delay for 1-based ``attempt`` is
    ``min(base_s * factor**(attempt-1), cap_s)`` scaled by a
    DETERMINISTIC seeded jitter in ``[1-jitter, 1+jitter]`` (seeded by
    ``(seed, key, attempt)`` exactly like :meth:`RetryPolicy.delay_s`,
    so reruns sleep the same schedule while distinct keys decorrelate —
    no thundering herd against a recovering worker). ``deadline_s``
    TRUNCATES: a delay never overshoots the schedule's total budget,
    and :meth:`delays` stops yielding once the budget is spent.
    """

    base_s: float = 0.05
    factor: float = 2.0
    jitter: float = 0.25
    cap_s: float = 2.0
    deadline_s: float | None = None
    seed: int = 0

    def delay_s(self, attempt: int, key: str = "",
                elapsed_s: float = 0.0) -> float:
        """The jittered delay before attempt ``attempt + 1``, truncated
        so ``elapsed_s + delay`` never exceeds ``deadline_s``."""
        base = min(self.base_s * self.factor ** max(attempt - 1, 0),
                   self.cap_s)
        rng = random.Random(f"{self.seed}|{key}|{attempt}")
        delay = max(0.0, base * (1.0 + self.jitter * rng.uniform(-1.0, 1.0)))
        if self.deadline_s is not None:
            delay = min(delay, max(0.0, self.deadline_s - elapsed_s))
        return delay

    def delays(self, key: str = ""):
        """Generator of successive delays (attempt 1, 2, ...) until the
        deadline budget is spent; unbounded when ``deadline_s`` is None
        — the CALLER owns any attempt ceiling. The yielded values sum
        to at most ``deadline_s``, so ``for d in b.delays(): sleep(d)``
        is a bounded wait loop by construction."""
        elapsed = 0.0
        attempt = 0
        while True:
            attempt += 1
            if self.deadline_s is not None and elapsed >= self.deadline_s:
                return
            d = self.delay_s(attempt, key, elapsed_s=elapsed)
            yield d
            elapsed += d


@dataclass(frozen=True)
class RetryPolicy:
    """Config-driven retry for transient-class failures.

    ``max_attempts`` is the TOTAL attempts per file (1 = never retry).
    Backoff for attempt ``a`` (1-based) is
    ``min(base_delay_s * 2**(a-1), max_delay_s)`` scaled by a
    DETERMINISTIC seeded jitter in ``[1-jitter, 1+jitter]`` — seeded by
    ``(seed, key, attempt)``, so a rerun of the same campaign sleeps the
    same schedule (reproducible walls) while distinct files decorrelate
    (no thundering herd against a recovering filesystem).
    ``budgets`` caps the campaign-wide number of RETRIES per class
    (``None`` = unbounded); once a class's budget is spent, further
    failures of that class disposition immediately.
    """

    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    jitter: float = 0.25
    seed: int = 0
    retry_classes: tuple = ("transient",)
    budgets: Mapping[str, int | None] = field(
        default_factory=lambda: {"transient": None}
    )

    def delay_s(self, key: str, attempt: int) -> float:
        # delegate to the shared Backoff schedule (same seeding string,
        # so pre-Backoff campaigns sleep bit-identical walls)
        return self.backoff().delay_s(attempt, key)

    def backoff(self) -> Backoff:
        """This policy's schedule as the shared :class:`Backoff`."""
        return Backoff(base_s=self.base_delay_s, factor=2.0,
                       jitter=self.jitter, cap_s=self.max_delay_s,
                       seed=self.seed)

    @classmethod
    def from_env(cls) -> "RetryPolicy":
        """The campaign default, overridable per deployment:
        ``DAS_RETRY_MAX_ATTEMPTS`` / ``DAS_RETRY_BASE_DELAY_S`` /
        ``DAS_RETRY_MAX_DELAY_S`` / ``DAS_RETRY_BUDGET`` (campaign-wide
        transient retry cap, empty = unbounded)."""
        budget = os.environ.get("DAS_RETRY_BUDGET", "")
        return cls(
            max_attempts=int(os.environ.get("DAS_RETRY_MAX_ATTEMPTS", 3)),
            base_delay_s=float(os.environ.get("DAS_RETRY_BASE_DELAY_S", 0.05)),
            max_delay_s=float(os.environ.get("DAS_RETRY_MAX_DELAY_S", 2.0)),
            budgets={"transient": int(budget) if budget else None},
        )


def as_retry_policy(retry) -> RetryPolicy | None:
    """Accept a :class:`RetryPolicy`, ``None``/``True`` (the env-driven
    default), or ``False`` (retries off)."""
    if isinstance(retry, RetryPolicy):
        return retry
    if retry is None or retry is True:
        return RetryPolicy.from_env()
    if retry is False:
        return None
    raise TypeError(f"retry must be a RetryPolicy, bool or None, got {retry!r}")


class RetryState:
    """One campaign's mutable retry bookkeeping over a
    :class:`RetryPolicy`: per-file attempt counts and per-class spent
    budgets."""

    def __init__(self, policy: RetryPolicy | None):
        self.policy = policy
        self.attempts: Dict[str, int] = {}
        self.spent: Dict[str, int] = {}

    def attempt(self, key: str) -> int:
        """Record one attempt for ``key``; returns the 1-based count."""
        self.attempts[key] = self.attempts.get(key, 0) + 1
        return self.attempts[key]

    def unattempt(self, key: str) -> None:
        """Refund one attempt: a resource-class downshift retry is a
        ROUTE change, not a retry of the same program — it must not
        spend the file's transient-retry budget (the ladder is bounded
        by its rung count, never by ``max_attempts``)."""
        if self.attempts.get(key, 0) > 0:
            self.attempts[key] -= 1

    def n_attempts(self, key: str) -> int:
        return self.attempts.get(key, 0)

    def should_retry(self, key: str, fclass: str) -> bool:
        pol = self.policy
        if pol is None or fclass not in pol.retry_classes:
            return False
        if self.attempts.get(key, 0) >= pol.max_attempts:
            return False
        budget = pol.budgets.get(fclass) if pol.budgets else None
        return budget is None or self.spent.get(fclass, 0) < budget

    def backoff(self, key: str, fclass: str, sleep=time.sleep) -> float:
        """Spend one retry (budget + counter) and sleep the deterministic
        backoff for ``key``'s next attempt; returns the delay slept."""
        self.spent[fclass] = self.spent.get(fclass, 0) + 1
        count("retries")
        delay = self.policy.delay_s(key, self.attempts.get(key, 1))
        with trace.span("retry", file=os.path.basename(key),
                        fault_class=fclass,
                        attempt=self.attempts.get(key, 1)):
            if delay > 0:
                sleep(delay)
        return delay


# ---------------------------------------------------------------------------
# Process-wide resilience counters
# ---------------------------------------------------------------------------
# The counter STORAGE is the telemetry metrics registry
# (telemetry.metrics "das_resilience_events_total{kind=...}"), so the same
# numbers ride the Prometheus exposition and JSON snapshot; these three
# functions are the view over it.


def count(name: str, n: int = 1) -> None:
    """Increment a process-wide resilience counter."""
    metrics.count_resilience(name, n)
    # probe signals ride the same call sites (telemetry.probes): a
    # watchdog trip degrades liveness, a quarantine degrades readiness
    if name == "watchdog_timeouts":
        probes.note_watchdog_timeout()
    elif name == "quarantined":
        probes.note_quarantine()


def counters() -> Dict[str, int]:
    """Snapshot of the process-wide resilience counters."""
    return metrics.resilience_counters()


def counters_delta(before: Mapping[str, int]) -> Dict[str, int]:
    """Counters accrued since a :func:`counters` snapshot."""
    return metrics.resilience_delta(before)


# ---------------------------------------------------------------------------
# Elastic downshift rungs (shared vocabulary of the resource ladder)
# ---------------------------------------------------------------------------

#: The canonical downshift order of the resource ladder
#: (``workflows.planner``):
#: batched slabs at shrinking B, then the per-file route, then the
#: family's tiled (memory-lean) view, then the time-sharded route
#: (multi-chip only), then the host. A rung is ``(stage, batch)`` —
#: batch is 1 for every non-batched stage. Each detector family
#: declares the SUBSET of stages its math supports
#: (``planner.DetectorProgram.stages``); every family's ladder starts
#: at ``file`` and ends at ``host``, so the order here totally orders
#: any family's rungs.
#:
#: The BANK-SPLIT stage (``"bank"``, splittable template banks only —
#: ``models.templates.TemplateBank.splittable``) interleaves: a
#: ``("bank", b)`` rung runs the SAME batch ``b`` as two T/2 sub-bank
#: dispatches, and sits between ``("batched", b)`` and
#: ``("batched", b/2)`` — the T axis is sacrificed before B is;
#: ``("bank", 1)`` is the per-file analog, between
#: ``file`` and ``tiled``. :func:`rung_rank` owns that interleaving.
DOWNSHIFT_STAGES = ("batched", "file", "tiled", "timeshard", "host")

#: stages a family may declare beyond :data:`DOWNSHIFT_STAGES` — the
#: interleaved bank-split stage (see above).
BANK_STAGE = "bank"


def rung_rank(rung) -> tuple:
    """Sort key placing rungs in ladder order: earlier (hungrier) rungs
    rank lower. Within the ``batched`` stage larger batches come first
    (``('batched', 8) < ('batched', 4) < ... < ('file', 1)``); a
    bank-split rung ranks just past its batch's full-bank rung
    (``('batched', 4) < ('bank', 4) < ('batched', 2)``; ``('file', 1)
    < ('bank', 1) < ('tiled', 1)``)."""
    stage, batch = rung
    b = int(batch)
    if stage == BANK_STAGE:
        if b > 1:
            return (0, -b, 1)
        return (DOWNSHIFT_STAGES.index("file"), -1, 1)
    return (DOWNSHIFT_STAGES.index(stage), -b, 0)


def rung_label(rung) -> str:
    """Human/manifest form of a rung: ``"batched:4"`` / ``"bank:4"`` /
    ``"bank"`` / ``"tiled"``."""
    stage, batch = rung
    if stage == "batched" or (stage == BANK_STAGE and int(batch) > 1):
        return f"{stage}:{int(batch)}"
    return stage


# ---------------------------------------------------------------------------
# Deterministic chaos harness
# ---------------------------------------------------------------------------

#: kind -> (site, exception factory or None for non-raising kinds)
FAULT_KINDS = ("oserror", "truncated", "transfer", "nan", "hang")
#: device resource-pressure kinds (opt into them explicitly — they model
#: HBM exhaustion and wedged dispatches, exercised by the batched
#: campaign's downshift ladder + dispatch watchdog)
DISPATCH_FAULT_KINDS = ("oom", "hang_dispatch")
_KIND_SITE = {
    "oserror": "read", "truncated": "read", "hang": "read", "nan": "read",
    "transfer": "transfer", "detect": "detect", "crash": "detect",
    "oom": "dispatch", "hang_dispatch": "dispatch",
}
#: kinds whose fault persists across attempts: a bad file stays bad, and
#: a hung mount stays hung (also keeps the chaos oracle deterministic —
#: an abandoned prefetch worker past a timeout may consume read-site
#: hits the consumer never observes)
_PERSISTENT_KINDS = frozenset({"truncated", "nan", "hang",
                               "oom", "hang_dispatch"})


@dataclass
class FaultSpec:
    """One file's planned fault: ``kind`` at ``site``, failing the first
    ``n_times`` attempts (persistent kinds fail every attempt).
    ``ok_rung`` applies to ``kind="oom"`` only: the first downshift rung
    (``(stage, batch)``, see :func:`rung_rank`) at which the dispatch
    stops OOMing — every hungrier rung raises
    :class:`InjectedResourceExhausted`, deterministically, however the
    campaign groups files into slabs."""

    kind: str
    site: str
    n_times: int
    ok_rung: tuple | None = None


class FaultPlan:
    """A seeded, deterministic fault schedule over a campaign.

    For each file the plan draws — seeded by ``(seed, basename)`` only,
    so the schedule is stable across tmp directories, call order, stream
    restarts and resume — whether to inject a fault, which ``kind``, and
    for transient kinds how many attempts fail before the file recovers
    (``1..max_transient_repeats``; keep it below the retry policy's
    ``max_attempts`` to model recoverable blips). Kinds:

    * ``"oserror"`` — transient ``EIO`` at the reader.
    * ``"truncated"`` — persistent corrupt-file error at the reader.
    * ``"transfer"`` — transient host->device transfer failure.
    * ``"nan"`` — the read succeeds but the block comes back
      NaN-poisoned (integer blocks: ADC-saturated) — exercises the
      on-device health quarantine, not an exception path.
    * ``"hang"`` — the reader sleeps ``hang_s`` (pair with a stream
      ``read_deadline_s`` below it to exercise the timeout path).
    * ``"oom"`` — device memory exhaustion at the dispatch boundary: the
      dispatch raises ``RESOURCE_EXHAUSTED`` while its downshift rung
      outranks the file's drawn ``ok_rung`` (``("file", 1)`` or
      ``("tiled", 1)``), and succeeds from that rung on — the
      deterministic model of a shape that fits a smaller batch
      (exercises every rung of the campaign's elastic ladder). Not in
      the default ``kinds``; opt in via ``kinds=faults
      .DISPATCH_FAULT_KINDS`` or a mixed tuple.
    * ``"hang_dispatch"`` — the dispatch wedges for ``hang_s`` (pair
      with a campaign ``dispatch_deadline_s`` below it to exercise the
      watchdog timeout path). Not in the default ``kinds``.
    * ``"crash"`` (only via ``crash_after``) — a one-shot FATAL fault at
      the detector boundary after N successful detects: the mid-run
      crash of the crash-resume drill.

    ``crash_point=`` / ``crash_mode=`` / ``crash_skip=`` arm a
    durability crash point (:mod:`das4whales_tpu_torch.crashpoints`) at
    plan construction — the SIGKILL / injected-ENOSPC unclean-death
    drill of the crash-only durability contract.

    ``pinned`` (``{basename: FaultSpec}``) replaces the draw for the
    named files with a chosen fault — e.g. an ``oom`` whose ``ok_rung``
    is ``("batched", 2)``, which the draw never gives; every other file
    keeps the seeded draw. Without it the schedule is the JAX package's
    for the same seed and file names.

    Injection sites are the hooks ``io.stream`` and
    ``workflows.campaign`` call: :meth:`on_read` / :meth:`poison_read`
    (reader boundary, runs on the prefetch worker), :meth:`on_transfer`
    (before the host->device copy), :meth:`on_detect` (before the
    detection program), :meth:`on_dispatch` (inside the watchdog).
    """

    def __init__(self, seed: int, rate: float = 0.4,
                 kinds=FAULT_KINDS, hang_s: float = 0.25,
                 max_transient_repeats: int = 2,
                 crash_after: int | None = None,
                 crash_point: str | None = None,
                 crash_mode: str = "kill",
                 crash_skip: int = 0,
                 pinned: Mapping[str, FaultSpec] | None = None):
        for k in kinds:
            if k not in _KIND_SITE or k == "crash":
                raise ValueError(f"unknown fault kind {k!r}")
        if crash_point is not None:
            # arm the durability crash-point matrix (crashpoints module)
            # from the plan, so chaos schedules and unclean-death drills
            # compose in one object
            crashpoints.arm(crash_point, crash_mode, crash_skip)
        self.seed = int(seed)
        self.rate = float(rate)
        self.kinds = tuple(kinds)
        self.hang_s = float(hang_s)
        self.max_transient_repeats = int(max_transient_repeats)
        self.crash_after = crash_after
        self.pinned = dict(pinned or {})
        for name, spec in self.pinned.items():
            if spec.kind not in _KIND_SITE or spec.site != _KIND_SITE[spec.kind]:
                raise ValueError(f"pinned fault for {name!r}: {spec} is not a "
                                 "known kind at its site")
        self._lock = threading.Lock()
        self._hits: Dict[tuple, int] = {}   # (site, basename) -> injections
        self._detect_ok = 0                 # successful detects (crash_after)
        self._crashed = False

    def spec_for(self, path: str) -> FaultSpec | None:
        """The (deterministic) fault planned for ``path``, if any."""
        name = os.path.basename(path)
        if name in self.pinned:
            return self.pinned[name]
        rng = random.Random(f"{self.seed}|{name}")
        if not self.kinds or rng.random() >= self.rate:
            return None
        kind = self.kinds[rng.randrange(len(self.kinds))]
        n = (10**9 if kind in _PERSISTENT_KINDS
             else 1 + rng.randrange(self.max_transient_repeats))
        ok_rung = None
        if kind == "oom":
            # where the shape starts fitting: the per-file route or one
            # rung further (the tiled route) — both recover to "done"
            ok_rung = ("file", 1) if rng.random() < 0.5 else ("tiled", 1)
        return FaultSpec(kind=kind, site=_KIND_SITE[kind], n_times=n,
                         ok_rung=ok_rung)

    def _fire(self, site: str, path: str) -> FaultSpec | None:
        """Consume one planned injection at ``site`` for ``path`` (None
        when the plan holds no fault there or it is spent)."""
        spec = self.spec_for(path)
        if spec is None or spec.site != site:
            return None
        key = (site, os.path.basename(path))
        with self._lock:
            hits = self._hits.get(key, 0)
            if hits >= spec.n_times:
                return None
            self._hits[key] = hits + 1
        return spec

    # -- hooks ------------------------------------------------------------

    def on_read(self, path: str) -> None:
        """Reader boundary (prefetch worker): raise or hang per plan.
        (``nan`` faults do not raise — they fire in :meth:`poison_read`.)"""
        if self._peek_nan(path):
            return
        spec = self._fire("read", path)
        if spec is None:
            return
        if spec.kind == "hang":
            time.sleep(self.hang_s)
        elif spec.kind == "truncated":
            raise InjectedCorruptFile(
                f"injected: truncated HDF5 (file signature not found): {path}"
            )
        else:
            raise InjectedReadError(
                errno.EIO, f"injected: transient I/O error reading {path}"
            )

    def poison_read(self, path: str, arr: np.ndarray) -> np.ndarray:
        """Reader boundary, after a successful read: NaN-poison (float)
        or ADC-saturate (integer) a stripe of the block per plan."""
        spec = self._fire("read", path) if self._peek_nan(path) else None
        if spec is None:
            return arr
        out = np.array(arr)
        n_bad = max(1, out.shape[-1] // 8)
        if np.issubdtype(out.dtype, np.floating):
            out[..., :n_bad] = np.nan
        else:
            out[..., :n_bad] = np.iinfo(out.dtype).max
        return out

    def _peek_nan(self, path: str) -> bool:
        spec = self.spec_for(path)
        return spec is not None and spec.kind == "nan"

    def on_transfer(self, path: str) -> None:
        """Host->device boundary: raise a transient transfer fault."""
        if self._fire("transfer", path) is not None:
            raise InjectedTransferError(
                f"injected: transfer failed for {path}"
            )

    def on_dispatch(self, path: str, rung: tuple = ("file", 1)) -> None:
        """Device-dispatch boundary (inside the campaign's watchdog
        wrapper): ``oom`` raises ``RESOURCE_EXHAUSTED`` while ``rung``
        outranks the file's planned ``ok_rung`` (condition-based, not
        count-based — deterministic however the campaign slices slabs);
        ``hang_dispatch`` wedges for ``hang_s`` every time (pair with a
        ``dispatch_deadline_s`` below it)."""
        spec = self.spec_for(path)
        if spec is None or spec.site != "dispatch":
            return
        if spec.kind == "hang_dispatch":
            time.sleep(self.hang_s)
            return
        ok = spec.ok_rung or ("file", 1)
        if rung_rank(rung) < rung_rank(ok):
            raise InjectedResourceExhausted(
                f"injected: RESOURCE_EXHAUSTED: out of memory while "
                f"trying to allocate the {rung_label(rung)} program for "
                f"{path} (fits from {rung_label(ok)})"
            )

    def on_detect(self, path: str) -> None:
        """Detector boundary: the one-shot fatal crash (``crash_after``),
        then any planned detect-site fault."""
        with self._lock:
            if (self.crash_after is not None and not self._crashed
                    and self._detect_ok >= self.crash_after):
                self._crashed = True
                raise InjectedCrash(
                    f"injected: campaign crashed before detecting {path}"
                )
        if self._fire("detect", path) is not None:
            raise InjectedDetectorError(
                f"injected: device program failed for {path}"
            )

    def detect_succeeded(self) -> None:
        """Campaign bookkeeping for ``crash_after``."""
        with self._lock:
            self._detect_ok += 1

    def expected_disposition(self, path: str,
                             policy: RetryPolicy | None) -> str:
        """The status this plan predicts for ``path`` under ``policy`` —
        the chaos fuzz oracle. ``"done"`` when the fault recovers within
        the retry budget (or there is none), else the fault class's
        terminal status.

        Preconditions the oracle assumes (assert them in the fuzz, not
        here): ``"hang"`` needs a stream ``read_deadline_s`` below
        ``hang_s``; ``"hang_dispatch"`` needs a campaign
        ``dispatch_deadline_s`` below ``hang_s``; ``"oom"`` needs the
        downshift ladder (on by default in the campaign runners for
        EVERY detector family — ``workflows.planner``; the ladder
        always reaches a rung at or past the plan's ``ok_rung``:
        unbatched routes start AT the per-file rung, so an ``ok_rung``
        at or above it never even fires there, and a family lacking the
        ``tiled`` stage recovers at its next declared rung — the host —
        which outranks every drawable ``ok_rung``); ``"nan"`` needs a
        health gate that can
        SEE the poison — the default ``DataHealthConfig`` catches the
        NaN stripe on float wires, but an integer (raw-wire) block is
        poisoned by ADC saturation, which only a configured ``clip_abs``
        / ``max_clip_frac`` gate flags.
        """
        spec = self.spec_for(path)
        if spec is None:
            return "done"
        if spec.kind == "truncated":
            return "failed"
        if spec.kind == "nan":
            return "quarantined"
        if spec.kind in ("hang", "hang_dispatch"):
            return "timeout"
        if spec.kind == "oom":
            return "done"   # the ladder downshifts to spec.ok_rung
        max_attempts = policy.max_attempts if policy is not None else 1
        return "done" if spec.n_times < max_attempts else "failed"
