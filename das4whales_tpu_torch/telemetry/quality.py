"""Science-quality observatory: pick-stream telemetry + drift baselines
(the port's copy of ``das4whales_tpu.telemetry.quality``).

Every signal is derived from values the detection program's one packed
fetch already carries, at no extra dispatch:

* **pick stream** — ``das_picks_total{tenant,template}`` and the
  per-file pick rate from the done-record's pick counts;
* **event strength** — the in-graph threshold the program fetches is
  ``thr = REL_THRESHOLD * env_peak * factor``, so the block's strongest
  correlation-envelope peak is recoverable from artifacts alone:
  ``das_pick_snr_db`` histograms ``20*log10(env_peak / rms_noise)``
  (the block's health RMS as the noise reference — a *drift* signal
  with consistent units over time, not a calibrated detection SNR) and
  ``das_file_picks`` the per-file pick-count distribution. A
  peak-over-threshold margin would be the constant
  ``-20*log10(REL_THRESHOLD*factor)`` (the peak is recovered by
  inverting that same threshold), so none is published;
* **data health** — ``das_channel_dead_fraction`` and
  ``das_noise_floor_rms`` gauges from the fused per-channel-bin health
  profile (``ops.health.health_profile``) riding the same fetch;
* **drift** — per-tenant EWMA baselines over pick rate, noise floor
  and dead fraction with HYSTERESIS warn states
  (``das_quality_drift{tenant,signal}``: 0 ok / 1 warn — enter after
  ``enter_consecutive`` samples beyond ``enter_sigma``, exit after
  ``exit_consecutive`` back inside ``exit_sigma``; outlier samples
  update the baseline at ``alpha/8`` so a transient spike cannot drag
  the mean while a genuine regime change still re-baselines).

Drift state never touches readiness, scheduling, or picks: ``/readyz``
carries a ``quality_drifting`` detail but never answers 503 for it.

Surfaces: manifest ``quality`` events and ``quality.json`` next to the
manifest (campaign end / service drain), ``GET /quality`` and the
per-tenant blocks of ``/tenants``. Off by default — ``DAS_QUALITY=1`` /
``run_campaign_batched(quality=True)`` / ``ServiceConfig.quality``;
disabled, every hook is one attribute check, and picks are
bit-identical either way because the observatory only READS the
fetched payload. Pure stdlib at import.
"""

from __future__ import annotations

import json
import math
import os
import threading
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional

from . import metrics

__all__ = [
    "DRIFT_SIGNALS", "DriftBaseline", "DriftPolicy", "OBSERVATORY",
    "QualityObservatory", "REL_THRESHOLD", "TenantQuality", "enable",
    "enabled", "export_json", "file_quality", "resolve_enabled",
    "threshold_factor_map",
]

#: The detector's in-graph threshold rule ``thr = REL_THRESHOLD *
#: env_peak * factor`` (``models.matched_filter.REL_THRESHOLD`` —
#: mirrored literally here because telemetry must stay stdlib at
#: import; the port's tests hold the two copies equal). Inverting
#: it recovers the block's strongest envelope peak from the already-
#: fetched threshold — the "pick heights vs threshold base" signal with
#: zero extra device outputs.
REL_THRESHOLD = 0.5

#: drift-judged signals, in the order they render
DRIFT_SIGNALS = ("pick_rate", "noise_floor", "dead_frac")

#: per-file rows kept per tenant for quality.json
#: (bounded however long a service runs)
_MAX_FILE_ROWS = 512
#: drift transitions kept per tenant (each is one regime event)
_MAX_EVENTS = 256
#: per-tenant SNR samples kept for exact p50/p95 in snapshots (the
#: Prometheus histogram keeps the full stream in bounded buckets)
_MAX_SNR = 4096

_c_picks = metrics.counter(
    "das_picks_total",
    "settled picks by tenant and template — the science output rate "
    "the quality observatory baselines (telemetry.quality)",
    ("tenant", "template"),
)
_c_qfiles = metrics.counter(
    "das_quality_files_total",
    "done files scored by the science-quality observatory, by tenant",
    ("tenant",),
)
_h_snr = metrics.histogram(
    "das_pick_snr_db",
    "per (file, template-with-picks) top-event SNR proxy: the "
    "correlation-envelope peak recovered from the fetched threshold "
    "(thr = REL*peak*factor) over the block's health RMS, in dB. The "
    "ABSOLUTE level carries a per-deployment offset (template "
    "normalization + wire units: strain vs raw counts) — watch the "
    "time series per tenant, not the level; hence the wide buckets",
    ("tenant",),
    buckets=(-20.0, 0.0, 20.0, 40.0, 60.0, 80.0, 120.0, 160.0, 200.0,
             240.0),
)
_h_file_picks = metrics.histogram(
    "das_file_picks",
    "picks per scored done file, by tenant: the pick-stream's "
    "per-file distribution — a collapsing detector shifts mass toward "
    "the low buckets before the rate EWMA pages",
    ("tenant",),
    buckets=(0.0, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 500.0,
             5000.0),
)
_g_rate = metrics.gauge(
    "das_pick_rate_hz",
    "last scored file's picks per second of recorded data, by tenant",
    ("tenant",),
)
_g_dead = metrics.gauge(
    "das_channel_dead_fraction",
    "last scored file's dead-channel fraction (channels whose real "
    "samples are all exactly zero — ops.health per-bin profile)",
    ("tenant",),
)
_g_noise = metrics.gauge(
    "das_noise_floor_rms",
    "last scored file's whole-block RMS (the noise-floor drift signal; "
    "input units — counts on the raw wire, strain on the conditioned)",
    ("tenant",),
)
_g_drift = metrics.gauge(
    "das_quality_drift",
    "per-tenant drift verdict per signal (pick_rate | noise_floor | "
    "dead_frac): 0 ok, 1 warn (EWMA baseline + hysteresis — "
    "telemetry.quality; NEVER touches readiness, scheduling, or picks)",
    ("tenant", "signal"),
)


def _env_truthy(name: str) -> bool:
    return os.environ.get(name, "") not in ("", "0", "false")


def _sig(v: float) -> float:
    """Round to 6 SIGNIFICANT digits for display/export — strain-wire
    signals run ~1e-11, where fixed-decimal rounding would read 0.
    (NaN/inf format and parse back exactly; callers pass numbers.)"""
    return float(f"{float(v):.6g}")


_enabled = _env_truthy("DAS_QUALITY")


def enabled() -> bool:
    """Is the quality observatory on (``DAS_QUALITY`` / :func:`enable`)?"""
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def resolve_enabled(flag: bool | None) -> bool:
    """Per-campaign resolution: None defers to the process switch."""
    return _enabled if flag is None else bool(flag)


# ---------------------------------------------------------------------------
# Drift baselines
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class DriftPolicy:
    """One tenant's drift-judgement knobs (shared by every signal).

    ``alpha`` — EWMA weight per scored file; ``warmup`` — files before
    any judging (the baseline must exist before deviations mean
    anything); enter/exit sigma + consecutive counts are the hysteresis
    (a single outlier never warns, a single quiet file never clears);
    ``sigma_floor_frac`` floors the deviation denominator at that
    fraction of ``|mean|`` so a near-zero-variance warmup cannot turn
    ordinary jitter into warnings."""

    alpha: float = 0.1
    warmup: int = 12
    enter_sigma: float = 5.0
    exit_sigma: float = 2.0
    enter_consecutive: int = 3
    exit_consecutive: int = 5
    sigma_floor_frac: float = 0.05


class DriftBaseline:
    """EWMA mean/variance + hysteresis state for ONE (tenant, signal).

    Not self-locking: owned and serialized by its
    :class:`TenantQuality`'s lock."""

    __slots__ = ("policy", "n", "mean", "var", "state", "value",
                 "_enter_streak", "_exit_streak")

    def __init__(self, policy: DriftPolicy):
        self.policy = policy
        self.n = 0
        self.mean = 0.0
        self.var = 0.0
        self.state = "ok"
        self.value = 0.0
        self._enter_streak = 0
        self._exit_streak = 0

    def sigma(self) -> float:
        base = math.sqrt(max(self.var, 0.0))
        return max(base, self.policy.sigma_floor_frac * abs(self.mean),
                   1e-12)

    def observe(self, x: float) -> str:
        """Judge ``x`` against the current baseline (hysteresis state
        machine), then fold it in (outliers at ``alpha/8`` — slow
        re-baselining instead of poisoning). Returns the state AFTER
        this sample."""
        p = self.policy
        x = float(x)
        self.value = x
        outlier = False
        if self.n >= p.warmup:
            dev = abs(x - self.mean) / self.sigma()
            outlier = dev > p.enter_sigma
            if self.state == "ok":
                self._enter_streak = self._enter_streak + 1 if outlier else 0
                if self._enter_streak >= p.enter_consecutive:
                    self.state = "warn"
                    self._exit_streak = 0
            else:
                if dev < p.exit_sigma:
                    self._exit_streak += 1
                    if self._exit_streak >= p.exit_consecutive:
                        self.state = "ok"
                        self._enter_streak = 0
                        self._exit_streak = 0
                else:
                    self._exit_streak = 0
        a = p.alpha / 8.0 if outlier else p.alpha
        if self.n == 0:
            self.mean = x
            self.var = 0.0
        else:
            d = x - self.mean
            self.mean += a * d
            self.var = (1.0 - a) * (self.var + a * d * d)
        self.n += 1
        return self.state

    def snapshot(self) -> Dict:
        return {
            "state": self.state,
            "value": _sig(self.value),
            "mean": _sig(self.mean),
            "sigma": _sig(self.sigma()),
            "n": self.n,
        }


# ---------------------------------------------------------------------------
# Per-file quality records
# ---------------------------------------------------------------------------


def file_quality(path: str, picks, thresholds, stats,
                 duration_s: float | None = None,
                 thr_factors: Optional[Dict[str, float]] = None,
                 thr_scope: str = "global") -> Dict:
    """One done file's quality record, from artifacts already in hand
    (the done-record's picks/thresholds/health — nothing re-fetched).

    ``picks`` is the ``{template: (2, n)}`` pick dict (or a
    ``{template: n}`` count mapping); ``thresholds`` the fetched
    per-template thresholds; ``stats`` the ``ops.health`` dict;
    ``thr_factors`` the bank's per-template factor map
    (:func:`threshold_factor_map`; None: factor 1 — the SNR then
    carries a constant per-template offset, still a valid drift
    signal). The envelope peak behind each threshold is
    ``thr / (REL_THRESHOLD * factor)``; under the default global
    threshold scope that peak is the BLOCK's strongest event (one max
    couples all templates), under ``per_template`` it is each
    template's own. No peak-over-threshold margin is derived: it would
    cancel to a constant (module docstring)."""
    n_picks: Dict[str, int] = {}
    for name, pk in (picks or {}).items():
        shape = getattr(pk, "shape", None)
        n_picks[str(name)] = int(shape[-1]) if shape else int(pk)
    total = sum(n_picks.values())
    rate = (total / float(duration_s)
            if duration_s and float(duration_s) > 0 else None)
    noise = (stats or {}).get("rms")
    noise = float(noise) if noise is not None and noise == noise else None
    dead = (stats or {}).get("dead_frac")
    dead = float(dead) if dead is not None else None
    snr: Dict[str, float] = {}
    for name, n in n_picks.items():
        if not n:
            continue
        thr = (thresholds or {}).get(name)
        if thr is None or not thr == thr or not thr > 0:
            continue
        fac = float((thr_factors or {}).get(name, 1.0)) or 1.0
        peak = float(thr) / (REL_THRESHOLD * fac)
        if noise and noise > 0 and peak > 0:
            snr[name] = round(20.0 * math.log10(peak / noise), 3)
    return {
        "path": path,
        "n_picks": n_picks,
        "n_picks_total": total,
        "duration_s": (round(float(duration_s), 3)
                       if duration_s else None),
        "pick_rate_hz": (round(rate, 6) if rate is not None else None),
        "noise_floor_rms": noise,
        "dead_frac": dead,
        "snr_db": snr,
        "thr_scope": thr_scope,
    }


def threshold_factor_map(design) -> Optional[Dict[str, float]]:
    """The bank's ``{template: threshold_factor}`` map from a
    ``MatchedFilterDesign``-shaped object — THE one construction the
    campaign feed and the service feed both
    share (a factor-representation change lands here once). None when
    the design carries no factor vector. numpy is imported lazily:
    telemetry stays stdlib at import."""
    if design is None or getattr(design, "threshold_factors", None) is None:
        return None
    import numpy as np

    return {
        str(n): float(f) for n, f in zip(
            design.template_names,
            np.asarray(design.threshold_factors, np.float64),
        )
    }


# ---------------------------------------------------------------------------
# Tenant state
# ---------------------------------------------------------------------------


class TenantQuality:
    """One tenant's quality state: counters, EWMA drift baselines, a
    bounded per-file row tail, and the drift-transition log.

    ``observe`` runs on the campaign/scheduler thread; ``snapshot`` /
    ``file_rows`` on HTTP handler threads (``/quality``, ``/tenants``)
    and exporters — every mutable field below is read and written under
    ``_lock`` (metric emission happens outside it; the registry has its
    own lock)."""

    def __init__(self, tenant: str, policy: DriftPolicy | None = None):
        self.tenant = tenant
        self.policy = policy or DriftPolicy()
        self._lock = threading.Lock()
        self._baselines: Dict[str, DriftBaseline] = {}
        self._files: Deque[Dict] = deque(maxlen=_MAX_FILE_ROWS)
        self._events: Deque[Dict] = deque(maxlen=_MAX_EVENTS)
        self._snr: Deque[float] = deque(maxlen=_MAX_SNR)
        self._n_files = 0
        self._n_picks = 0

    def observe(self, rec: Dict) -> None:
        """Fold one :func:`file_quality` record in: counters,
        histograms, gauges, and the drift baselines."""
        tenant = self.tenant
        for name, n in (rec.get("n_picks") or {}).items():
            if n:
                _c_picks.inc(n, tenant=tenant, template=name)
        _c_qfiles.inc(tenant=tenant)
        snr_vals = list((rec.get("snr_db") or {}).values())
        for v in snr_vals:
            _h_snr.observe(v, tenant=tenant)
        _h_file_picks.observe(float(rec.get("n_picks_total") or 0),
                              tenant=tenant)
        signals = {
            "pick_rate": rec.get("pick_rate_hz"),
            "noise_floor": rec.get("noise_floor_rms"),
            "dead_frac": rec.get("dead_frac"),
        }
        for gauge, key in ((_g_rate, "pick_rate"),
                           (_g_noise, "noise_floor"),
                           (_g_dead, "dead_frac")):
            v = signals[key]
            if v is not None:
                gauge.set(_sig(v), tenant=tenant)
        states: Dict[str, str] = {}
        with self._lock:
            self._n_files += 1
            self._n_picks += int(rec.get("n_picks_total") or 0)
            seq = self._n_files
            for sig in DRIFT_SIGNALS:
                v = signals[sig]
                if v is None or not v == v:
                    continue
                bl = self._baselines.get(sig)
                if bl is None:
                    bl = self._baselines[sig] = DriftBaseline(self.policy)
                prev = bl.state
                states[sig] = bl.observe(float(v))
                if states[sig] != prev:
                    self._events.append({
                        "seq": seq, "path": rec.get("path", ""),
                        "signal": sig, "from": prev, "to": states[sig],
                        "value": _sig(v),
                        "mean": _sig(bl.mean),
                    })
            self._snr.extend(snr_vals)
            self._files.append({**rec, "seq": seq,
                                "drift": dict(states)})
        for sig, state in states.items():
            _g_drift.set(1.0 if state == "warn" else 0.0,
                         tenant=tenant, signal=sig)

    # -- read side ---------------------------------------------------------

    @staticmethod
    def _pctl(sorted_vals: List[float], q: float) -> Optional[float]:
        """Nearest-rank percentile over an ALREADY-SORTED list (the
        caller sorts once and indexes twice)."""
        if not sorted_vals:
            return None
        return round(sorted_vals[min(len(sorted_vals) - 1,
                                     int(q * len(sorted_vals)))], 3)

    def drifting(self) -> bool:
        with self._lock:
            return any(b.state == "warn" for b in self._baselines.values())

    def snapshot(self) -> Dict:
        """This tenant's ``/quality`` row (and the ``/tenants`` quality
        block): totals, last signal values, exact SNR percentiles over
        the bounded sample tail, per-signal drift verdicts, and the
        transition log."""
        with self._lock:
            n_files, n_picks = self._n_files, self._n_picks
            drift = {sig: bl.snapshot()
                     for sig, bl in self._baselines.items()}
            snr_vals = sorted(self._snr)
            events = list(self._events)
        last = {sig: d.get("value") for sig, d in drift.items()}
        return {
            "tenant": self.tenant,
            "n_files": n_files,
            "n_picks": n_picks,
            "pick_rate_hz": last.get("pick_rate"),
            "noise_floor_rms": last.get("noise_floor"),
            "dead_frac": last.get("dead_frac"),
            "snr_db_p50": self._pctl(snr_vals, 0.50),
            "snr_db_p95": self._pctl(snr_vals, 0.95),
            "drift": drift,
            "drifting": any(d["state"] == "warn" for d in drift.values()),
            "transitions": events,
        }

    def file_rows(self) -> List[Dict]:
        """Copy-on-read of the bounded per-file tail (newest last)."""
        with self._lock:
            return list(self._files)


# ---------------------------------------------------------------------------
# The process-wide observatory
# ---------------------------------------------------------------------------


class QualityObservatory:
    """Process-wide ``tenant -> TenantQuality``, like the cost-card and
    metrics registries: written by campaign/scheduler threads, read by
    HTTP handlers and exporters. The registry lock guards only the dict
    — each tenant's state locks itself."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tenants: Dict[str, TenantQuality] = {}

    def tenant(self, name: str,
               policy: DriftPolicy | None = None) -> TenantQuality:
        """Get-or-create ``name``'s state (``policy`` applies only on
        creation)."""
        with self._lock:
            tq = self._tenants.get(name)
            if tq is None:
                tq = self._tenants[name] = TenantQuality(name, policy)
            return tq

    def fresh(self, name: str,
              policy: DriftPolicy | None = None) -> TenantQuality:
        """REPLACE ``name``'s state with a fresh one — a campaign run
        or a service tenant's serving lifetime is one drift baseline;
        a new run must not inherit the previous run's regime (the
        Prometheus counters keep accumulating process-wide, as
        counters do). The drift GAUGES reset with the baseline: a
        previous lifetime's warn=1 must not keep paging ``/metrics``
        into a run whose fresh baseline says ok."""
        with self._lock:
            tq = self._tenants[name] = TenantQuality(name, policy)
        for sig in DRIFT_SIGNALS:
            _g_drift.set(0.0, tenant=name, signal=sig)
        return tq

    def get(self, name: str) -> Optional[TenantQuality]:
        with self._lock:
            return self._tenants.get(name)

    def observe(self, tenant: str, rec: Dict) -> None:
        self.tenant(tenant).observe(rec)

    def _selected(self, tenants=None) -> List[TenantQuality]:
        with self._lock:
            if tenants is None:
                return list(self._tenants.values())
            return [self._tenants[n] for n in tenants
                    if n in self._tenants]

    def drifting_tenants(self, tenants=None) -> List[str]:
        """Just the drifting names — the cheap form ``/readyz`` polls
        (one lock-guarded flag read per tenant; no snapshot build, no
        SNR-tail sorts on the probe path)."""
        return [t.tenant for t in self._selected(tenants) if t.drifting()]

    def snapshot(self, tenants=None) -> Dict:
        """The ``GET /quality`` payload: per-tenant rows (no file
        tails) + the drifting list. ``tenants`` filters (and orders)
        the rows; absent names are skipped (a tenant that never scored
        a file has no row). ``enabled`` reports whether the observatory
        was ACTIVE for these rows — the process switch OR the presence
        of scored rows (a ``quality=True`` campaign arms per run
        without flipping the process switch; its export must not read
        as disabled)."""
        rows = [t.snapshot() for t in self._selected(tenants)]
        return {
            "enabled": _enabled or bool(rows),
            "tenants": rows,
            "drifting": [r["tenant"] for r in rows if r["drifting"]],
        }

    def payload(self, tenants=None) -> Dict:
        """The ``quality.json`` payload: :meth:`snapshot` rows plus
        each tenant's bounded per-file tail — everything
        a report renders, from the same records the
        HTTP surface serves."""
        sel = self._selected(tenants)
        out = self.snapshot(tenants)
        files = {t.tenant: t.file_rows() for t in sel}
        for row in out["tenants"]:
            row["files"] = files.get(row["tenant"], [])
        return out

    def reset(self) -> None:
        with self._lock:
            self._tenants.clear()


#: The process-wide observatory (one per process, like metrics.REGISTRY
#: and costs.REGISTRY).
OBSERVATORY = QualityObservatory()


def export_json(path: str, tenants=None, extra: Dict | None = None) -> str:
    """Write the observatory payload as JSON next to the manifest
    (durably, via ``utils.artifacts.atomic_json``; the state is
    snapshotted before any IO — no lock is held across the write).
    Returns ``path``."""
    # local import: utils/__init__ imports telemetry.progress, so a
    # module-level import here would cycle at package-init time
    from ..utils import artifacts

    payload = OBSERVATORY.payload(tenants)
    if extra:
        payload.update(extra)
    return artifacts.atomic_json(path, payload, indent=1)
