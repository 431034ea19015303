"""Labeled metrics registry: counters, gauges, bounded histograms (the
port's copy of ``das4whales_tpu.telemetry.metrics``).

One process-wide registry (:data:`REGISTRY`) the whole stack emits into:
per-rung/per-family dispatch and resolve tallies, ``PipelinedDispatch``
queue depth and in-flight residency, watchdog deadline margins, slab
wall percentiles, HBM preflight high-water — exposed as a Prometheus
text exposition (:func:`prometheus_text`) and a JSON snapshot
(:func:`snapshot`).

It also SUBSUMES the resilience counters that used to live as a bare
dict in ``faults.py``: ``faults.count``/``faults.counters`` are now thin
views over the ``das_resilience_events_total{kind=...}`` counter here
(:func:`count_resilience` / :func:`resilience_counters`) — same keys,
same values, same delta semantics, one lock. Pure stdlib at import
(``faults`` imports this at package init).
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

__all__ = [
    "REGISTRY", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "RESILIENCE_KEYS", "count_resilience", "counter", "gauge", "histogram",
    "prometheus_text", "resilience_counters", "resilience_delta", "snapshot",
]

#: default histogram bucket upper bounds (seconds-flavored: the spans
#: this repo measures run ~1 ms..minutes); +Inf is implicit.
DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0,
                   30.0, 60.0, 300.0)


def _label_key(labelnames: Tuple[str, ...], labels: Mapping[str, object]):
    # hot path (faults.count rides this): build the key directly and let
    # a miss raise — no per-call set construction
    try:
        key = tuple(str(labels[n]) for n in labelnames)
    except KeyError:
        key = None
    if key is None or len(labels) != len(labelnames):
        raise ValueError(
            f"expected labels {labelnames}, got {tuple(sorted(labels))}"
        )
    return key


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str, labelnames: Tuple[str, ...],
                 lock: threading.Lock):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = lock
        self._values: Dict[tuple, object] = {}

    def _key(self, labels):
        return _label_key(self.labelnames, labels)


class Counter(_Metric):
    """Monotonically increasing count per label set."""

    kind = "counter"

    def inc(self, n: float = 1, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + n

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0)

    def values(self) -> Dict[tuple, float]:
        with self._lock:
            return dict(self._values)


class Gauge(_Metric):
    """A point-in-time value per label set (set/inc/dec)."""

    kind = "gauge"

    def set(self, v: float, **labels) -> None:
        with self._lock:
            self._values[self._key(labels)] = v

    def inc(self, n: float = 1, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + n

    def dec(self, n: float = 1, **labels) -> None:
        self.inc(-n, **labels)

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0)

    def max(self, v: float, **labels) -> None:
        """High-water update: keep the max of the current value and
        ``v`` (the HBM preflight high-water semantics)."""
        key = self._key(labels)
        with self._lock:
            cur = self._values.get(key)
            if cur is None or v > cur:
                self._values[key] = v


class Histogram(_Metric):
    """A BOUNDED histogram per label set: fixed cumulative-style bucket
    bounds plus sum/count/min/max — O(len(buckets)) memory however many
    observations land, so a week-long service leaks nothing."""

    kind = "histogram"

    def __init__(self, name, help, labelnames, lock,
                 buckets: Iterable[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labelnames, lock)
        self.buckets = tuple(sorted(float(b) for b in buckets))

    def observe(self, v: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            st = self._values.get(key)
            if st is None:
                st = self._values[key] = {
                    "counts": [0] * (len(self.buckets) + 1),
                    "sum": 0.0, "count": 0, "min": v, "max": v,
                }
            i = len(self.buckets)
            for j, b in enumerate(self.buckets):
                if v <= b:
                    i = j
                    break
            st["counts"][i] += 1
            st["sum"] += v
            st["count"] += 1
            st["min"] = min(st["min"], v)
            st["max"] = max(st["max"], v)

    def quantile(self, q: float, **labels) -> Optional[float]:
        """Approximate quantile from the bucket bounds (the upper bound
        of the bucket holding the q-th observation; ``max`` for the
        overflow bucket). None with no observations."""
        with self._lock:
            st = self._values.get(self._key(labels))
            if not st or not st["count"]:
                return None
            target = q * st["count"]
            acc = 0
            for j, c in enumerate(st["counts"]):
                acc += c
                if acc >= target and c:
                    return (self.buckets[j] if j < len(self.buckets)
                            else st["max"])
            return st["max"]


class MetricsRegistry:
    """Name -> metric, one lock, Prometheus/JSON export."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get(self, cls, name, help, labelnames, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, tuple(labelnames),
                                              self._lock, **kw)
                return m
        if type(m) is not cls or m.labelnames != tuple(labelnames):
            raise ValueError(
                f"metric {name!r} already registered as {m.kind} with "
                f"labels {m.labelnames}"
            )
        return m

    def counter(self, name, help="", labelnames=()) -> Counter:
        return self._get(Counter, name, help, labelnames)

    def gauge(self, name, help="", labelnames=()) -> Gauge:
        return self._get(Gauge, name, help, labelnames)

    def histogram(self, name, help="", labelnames=(),
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, labelnames, buckets=buckets)

    def reset(self) -> None:
        """Drop every metric's values (tests / service restart)."""
        with self._lock:
            for m in self._metrics.values():
                m._values.clear()

    def snapshot(self) -> Dict:
        """JSON-safe dump: ``{name: {type, help, values: [{labels, ...}]}}``."""
        out: Dict[str, Dict] = {}
        with self._lock:
            for name, m in sorted(self._metrics.items()):
                rows: List[Dict] = []
                for key, val in sorted(m._values.items()):
                    labels = dict(zip(m.labelnames, key))
                    if m.kind == "histogram":
                        rows.append({
                            "labels": labels, "sum": val["sum"],
                            "count": val["count"], "min": val["min"],
                            "max": val["max"],
                            "buckets": {
                                ("+Inf" if j >= len(m.buckets)
                                 else repr(m.buckets[j])): c
                                for j, c in enumerate(val["counts"]) if c
                            },
                        })
                    else:
                        rows.append({"labels": labels, "value": val})
                out[name] = {"type": m.kind, "help": m.help, "values": rows}
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition (format 0.0.4) of every metric."""

        def fmt_labels(labels: Mapping[str, str], extra=()) -> str:
            items = list(labels.items()) + list(extra)
            if not items:
                return ""
            body = ",".join(
                '{}="{}"'.format(k, str(v).replace("\\", r"\\")
                                 .replace('"', r"\"").replace("\n", r"\n"))
                for k, v in items
            )
            return "{" + body + "}"

        lines: List[str] = []
        with self._lock:
            for name, m in sorted(self._metrics.items()):
                if m.help:
                    lines.append(f"# HELP {name} {m.help}")
                lines.append(f"# TYPE {name} {m.kind}")
                for key, val in sorted(m._values.items()):
                    labels = dict(zip(m.labelnames, key))
                    if m.kind == "histogram":
                        acc = 0
                        for j, c in enumerate(val["counts"]):
                            acc += c
                            le = ("+Inf" if j >= len(m.buckets)
                                  else repr(m.buckets[j]))
                            lines.append(
                                f"{name}_bucket"
                                f"{fmt_labels(labels, [('le', le)])} {acc}"
                            )
                        lines.append(
                            f"{name}_sum{fmt_labels(labels)} {val['sum']}")
                        lines.append(
                            f"{name}_count{fmt_labels(labels)} {val['count']}")
                    else:
                        lines.append(f"{name}{fmt_labels(labels)} {val}")
        return "\n".join(lines) + "\n"


#: The process-wide default registry everything below registers into.
REGISTRY = MetricsRegistry()


def counter(name, help="", labelnames=()) -> Counter:
    return REGISTRY.counter(name, help, labelnames)


def gauge(name, help="", labelnames=()) -> Gauge:
    return REGISTRY.gauge(name, help, labelnames)


def histogram(name, help="", labelnames=(), buckets=DEFAULT_BUCKETS):
    return REGISTRY.histogram(name, help, labelnames, buckets=buckets)


def snapshot() -> Dict:
    return REGISTRY.snapshot()


def prometheus_text() -> str:
    return REGISTRY.prometheus_text()


# ---------------------------------------------------------------------------
# Resilience counters: the faults.counters() back-compat view
# ---------------------------------------------------------------------------

#: the counter keys ``faults.counters()`` has always snapshot as zeros —
#: preserved exactly (bench payloads and the chaos suite key on them).
RESILIENCE_KEYS = (
    "retries", "degradations", "quarantined", "timeouts",
    "downshifts", "oom_recoveries", "watchdog_timeouts",
    "dispatches", "syncs",
)

_resilience = REGISTRY.counter(
    "das_resilience_events_total",
    "process-wide resilience events by kind (the faults.counters() set)",
    ("kind",),
)


def count_resilience(kind: str, n: int = 1) -> None:
    """Increment one resilience counter (``faults.count`` delegates)."""
    _resilience.inc(n, kind=kind)


def resilience_counters() -> Dict[str, int]:
    """The ``faults.counters()`` view: every :data:`RESILIENCE_KEYS` key
    (zeros included) plus any ad-hoc kinds ever counted."""
    out = {k: 0 for k in RESILIENCE_KEYS}
    for (kind,), v in _resilience.values().items():
        out[kind] = int(v)
    return out


def resilience_delta(before: Mapping[str, int]) -> Dict[str, int]:
    """Counters accrued since a :func:`resilience_counters` snapshot
    (``faults.counters_delta`` semantics, preserved exactly)."""
    now = resilience_counters()
    return {k: now.get(k, 0) - before.get(k, 0) for k in now}
