"""Per-tenant serving SLOs: pick freshness, error budgets, burn rates
(the port's copy of ``das4whales_tpu.telemetry.slo``).

* **freshness** — every ``IngestItem`` is stamped at
  ``RingBuffer.push`` (ring admission is the service's "data arrived"
  moment); when the item's file settles ``done`` the scheduler observes
  ingest→pick-settled latency into ``das_pick_latency_seconds{tenant}``.
* **objective** — ``TenantSpec.slo_p95_s``: the tenant's freshness
  target. The implicit objective is "``slo_objective`` (default 95%) of
  picks settle within ``slo_p95_s``"; the ERROR BUDGET is the
  complement (default 5% of picks may breach).
* **multi-window burn rates** — over each window in
  ``slo_windows`` (default 60 s and 600 s) the breach fraction divided
  by the budget is the BURN RATE: 1.0 consumes the budget exactly at
  the sustainable rate; 20 means every pick is breaching a 95%
  objective. A tenant is ``burning`` when EVERY window burns >= 1 (a
  short spike alone does not page, a long slow leak alone does not page
  immediately), ``warn`` when any single window does, ``ok`` otherwise.
  Exported as ``das_slo_burn_rate{tenant,window}``, refreshed at every
  burn-rate EVALUATION (``/slo``, ``/readyz`` detail, the ``/metrics``
  scrape) rather than per settled pick — the gauge decays with the
  window even when a tenant stops producing picks, and the per-pick hot
  path stays O(1).

The service surfaces this as ``GET /slo`` (per-tenant verdicts) and as
``slo_burning`` detail on ``/readyz`` — burn state never flips
readiness and never touches picks. Pure stdlib at import.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, Optional, Tuple

from . import metrics

__all__ = [
    "DEFAULT_OBJECTIVE", "DEFAULT_WINDOWS", "SLOPolicy", "TenantSLO",
    "observe_pick_latency", "window_label",
]

DEFAULT_OBJECTIVE = 0.95
DEFAULT_WINDOWS: Tuple[float, ...] = (60.0, 600.0)

#: ring-admission -> pick-settled freshness runs ~ms (backfill) to
#: minutes (realtime replay of 60 s files): span-flavored buckets fit.
_h_latency = metrics.histogram(
    "das_pick_latency_seconds",
    "ingest->pick-settled freshness per tenant: RingBuffer.push stamp "
    "to the done manifest record",
    ("tenant",),
)
_g_burn = metrics.gauge(
    "das_slo_burn_rate",
    "error-budget burn rate per tenant and window (breach fraction / "
    "budget; 1.0 = budget consumed exactly at the sustainable rate)",
    ("tenant", "window"),
)

#: observations kept per tenant regardless of window span (a bound on
#: memory for very fast backfills; windows bound it in time anyway)
_MAX_OBS = 50_000


def window_label(w: float) -> str:
    """The metric label for a window span (``60s``, ``600s``)."""
    return f"{int(round(w))}s"


def observe_pick_latency(tenant: str, latency_s: float) -> None:
    """The histogram half, policy or not: every settled pick's
    freshness lands in ``das_pick_latency_seconds{tenant}``."""
    _h_latency.observe(max(0.0, float(latency_s)), tenant=tenant)


@dataclass(frozen=True)
class SLOPolicy:
    """One tenant's freshness objective (from ``TenantSpec``)."""

    target_s: float
    objective: float = DEFAULT_OBJECTIVE
    windows: Tuple[float, ...] = DEFAULT_WINDOWS

    @property
    def budget(self) -> float:
        """The error budget: the breach fraction the objective allows."""
        return max(1e-9, 1.0 - float(self.objective))


class TenantSLO:
    """One tenant's rolling SLO evaluation.

    ``observe`` is called by the scheduler thread per settled pick;
    ``burn_rates``/``state``/``snapshot`` by HTTP handler threads
    (``/slo``, ``/readyz`` detail, ``/tenants``) — the deque and the
    running counters are only touched under ``_lock``."""

    def __init__(self, tenant: str, policy: SLOPolicy):
        self.tenant = tenant
        self.policy = policy
        self._lock = threading.Lock()
        # (monotonic stamp, breached) per settled pick, trimmed to the
        # longest window on every observe — bounded however long the
        # service runs
        self._obs: Deque[Tuple[float, bool]] = deque()
        self._n_observed = 0
        self._n_breached = 0

    def observe(self, latency_s: float,
                now: Optional[float] = None) -> None:
        """Record one settled pick — O(1) amortized on the scheduler
        thread (append + trim; burn evaluation and gauge export happen
        at READ time — ``/slo``/``/readyz``/``/metrics`` — not per
        pick, so a fast backfill never pays per-settle window scans)."""
        now = time.monotonic() if now is None else now
        breached = float(latency_s) > self.policy.target_s
        horizon = max(self.policy.windows)
        with self._lock:
            self._obs.append((now, breached))
            self._n_observed += 1
            self._n_breached += int(breached)
            while self._obs and (self._obs[0][0] < now - horizon
                                 or len(self._obs) > _MAX_OBS):
                self._obs.popleft()

    def burn_rates(self, now: Optional[float] = None) -> Dict[float, float]:
        """Burn rate per window: breach fraction over the window /
        error budget (0.0 with no observations in the window). Every
        evaluation also refreshes ``das_slo_burn_rate`` — the gauge is
        as fresh as the last read, so breaches aging OUT of a window
        with no new picks still decay it back toward 0 on the next
        scrape (``/metrics`` evaluates before rendering) instead of
        latching the last per-pick value forever."""
        now = time.monotonic() if now is None else now
        with self._lock:
            obs = list(self._obs)
        out: Dict[float, float] = {}
        for w in self.policy.windows:
            sel = [bad for (t, bad) in obs if t >= now - w]
            frac = (sum(sel) / len(sel)) if sel else 0.0
            out[w] = frac / self.policy.budget
            _g_burn.set(round(out[w], 4), tenant=self.tenant,
                        window=window_label(w))
        return out

    @staticmethod
    def _classify(rates: Dict[float, float]) -> str:
        if rates and all(r >= 1.0 for r in rates.values()):
            return "burning"
        if any(r >= 1.0 for r in rates.values()):
            return "warn"
        return "ok"

    def state(self, now: Optional[float] = None) -> str:
        """``burning`` (every window >= 1), ``warn`` (any window >= 1),
        or ``ok`` — the multi-window rule in one word."""
        return self._classify(self.burn_rates(now))

    def snapshot(self, now: Optional[float] = None) -> Dict:
        """The ``/slo`` row for this tenant — ONE burn evaluation (one
        deque copy + window scan) feeds both the rates and the state."""
        now = time.monotonic() if now is None else now
        rates = self.burn_rates(now)
        with self._lock:
            n_obs, n_bad = self._n_observed, self._n_breached
        return {
            "tenant": self.tenant,
            "target_s": self.policy.target_s,
            "objective": self.policy.objective,
            "budget": round(self.policy.budget, 6),
            "windows_s": list(self.policy.windows),
            "burn_rates": {window_label(w): round(r, 4)
                           for w, r in rates.items()},
            "state": self._classify(rates),
            "n_observed": n_obs,
            "n_breached": n_bad,
        }
