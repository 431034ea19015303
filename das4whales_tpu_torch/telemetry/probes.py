"""Liveness / readiness probes driven by the campaign's own signals (the
port's copy of ``das4whales_tpu.telemetry.probes``).

A service needs two answers a load balancer can poll:

* :func:`liveness` — is the process making dispatch progress, or is the
  device runtime wedged? Driven by the dispatch WATCHDOG: a
  ``DispatchDeadlineExceeded`` (``faults.count("watchdog_timeouts")``)
  bumps a consecutive-trip streak; any successful counted fetch/sync
  (``parallel.dispatch.fetch``/``sync``) resets it. Not live once the
  streak reaches the threshold — a wedged CUDA runtime answers nothing,
  so the probe is the only honest signal.
* :func:`readiness` — should traffic route here? Not ready when not
  live, and not ready while the health QUARANTINE streak (consecutive
  quarantined files with no healthy ``done`` file between them —
  ``ops.health`` breaches) reaches its threshold: the input stream is
  unusable even though the process is fine.

The truth table:

==================  ========  =========
state               liveness  readiness
==================  ========  =========
healthy             ok        ok
watchdog-tripped    FAIL      FAIL
quarantine-breached ok        FAIL
==================  ========  =========

The signals arrive through the ``note_*`` hooks, which ``faults.count``
and ``parallel.dispatch`` call — nothing here polls. The streaks are
mirrored into the metrics registry (``das_probe_*`` gauges) so the
Prometheus exposition carries them too.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Dict

from . import metrics

__all__ = [
    "ProbeResult", "liveness", "note_dispatch_ok", "note_file_ok",
    "note_quarantine", "note_watchdog_timeout", "readiness", "reset",
    "snapshot",
]

_lock = threading.Lock()
_state = {
    "watchdog_streak": 0,     # consecutive watchdog trips, reset by progress
    "quarantine_streak": 0,   # consecutive quarantines, reset by a done file
    "dispatch_ok_total": 0,
    "last_progress_mono": None,   # time.monotonic() of the last ok dispatch
}

_g_watchdog = metrics.gauge(
    "das_probe_watchdog_streak",
    "consecutive dispatch-watchdog timeouts since the last counted fetch/sync",
)
_g_quarantine = metrics.gauge(
    "das_probe_quarantine_streak",
    "consecutive quarantined files since the last done file",
)
_c_progress = metrics.counter(
    "das_dispatch_progress_total",
    "successful counted fetch/sync completions (the liveness heartbeat)",
)


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


# -- the signal hooks (called by faults.count / parallel.dispatch) ----------


def note_dispatch_ok() -> None:
    """A counted fetch/sync completed: the device runtime answers.
    Rides every counted fetch/sync — the streak gauge only writes on an
    actual recovery, keeping the steady-state cost to one lock."""
    with _lock:
        tripped = _state["watchdog_streak"] != 0
        _state["watchdog_streak"] = 0
        _state["dispatch_ok_total"] += 1
        _state["last_progress_mono"] = time.monotonic()
    if tripped:
        _g_watchdog.set(0)
    _c_progress.inc()


def note_watchdog_timeout() -> None:
    """The dispatch watchdog fired (a wedged dispatch was abandoned)."""
    with _lock:
        _state["watchdog_streak"] += 1
        streak = _state["watchdog_streak"]
    _g_watchdog.set(streak)


def note_quarantine() -> None:
    """A file breached the on-device health gate (quarantined)."""
    with _lock:
        _state["quarantine_streak"] += 1
        streak = _state["quarantine_streak"]
    _g_quarantine.set(streak)


def note_file_ok() -> None:
    """A file dispositioned ``done`` (healthy content made it through)."""
    with _lock:
        _state["quarantine_streak"] = 0
    _g_quarantine.set(0)


def reset() -> None:
    """Clear the probe state (tests / service restart)."""
    with _lock:
        _state.update(watchdog_streak=0, quarantine_streak=0,
                      dispatch_ok_total=0, last_progress_mono=None)
    _g_watchdog.set(0)
    _g_quarantine.set(0)


# -- the probe surfaces ------------------------------------------------------


@dataclass(frozen=True)
class ProbeResult:
    """A probe verdict that is truthy/falsy AND explains itself — a
    service endpoint maps ``ok`` to 200/503 and serves ``detail`` as the
    body."""

    ok: bool
    reason: str
    detail: Dict = field(default_factory=dict)

    def __bool__(self) -> bool:
        return self.ok


def _snapshot() -> Dict:
    with _lock:
        return dict(_state)


def snapshot() -> Dict:
    """Both verdicts plus the raw streak state in one dict — the
    service's ``/tenants`` surface embeds this so an operator sees the
    probe picture without a second request."""
    live = liveness()
    ready = readiness()
    return {
        "live": bool(live), "live_reason": live.reason,
        "ready": bool(ready), "ready_reason": ready.reason,
        "state": _snapshot(),
    }


def liveness(max_watchdog_streak: int | None = None) -> ProbeResult:
    """Is the process making dispatch progress?

    Fails once ``max_watchdog_streak`` consecutive dispatch-watchdog
    timeouts have fired with no counted fetch/sync completing between
    them (default 1 — one abandoned wedged dispatch marks the runtime
    suspect; ``DAS_PROBE_WATCHDOG_STREAK`` overrides). Recovers the
    moment any dispatch completes."""
    if max_watchdog_streak is None:
        max_watchdog_streak = _env_int("DAS_PROBE_WATCHDOG_STREAK", 1)
    st = _snapshot()
    if st["watchdog_streak"] >= max_watchdog_streak:
        return ProbeResult(False, "watchdog-tripped", st)
    return ProbeResult(True, "ok", st)


def readiness(max_watchdog_streak: int | None = None,
              max_quarantine_streak: int | None = None) -> ProbeResult:
    """Should traffic route here? Not ready when not live, and not
    ready while ``max_quarantine_streak`` consecutive files quarantined
    with no healthy file between (default 4;
    ``DAS_PROBE_QUARANTINE_STREAK`` overrides)."""
    live = liveness(max_watchdog_streak)
    if not live:
        return ProbeResult(False, live.reason, live.detail)
    if max_quarantine_streak is None:
        max_quarantine_streak = _env_int("DAS_PROBE_QUARANTINE_STREAK", 4)
    st = _snapshot()
    if st["quarantine_streak"] >= max_quarantine_streak:
        return ProbeResult(False, "quarantine-breached", st)
    return ProbeResult(True, "ok", st)
