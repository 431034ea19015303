"""Host-side span tracing with a no-op fast path (the port's copy of
``das4whales_tpu.telemetry.trace``).

A span is one named, attributed interval on the host timeline: ``read``,
``h2d``, ``dispatch``, ``resolve``, ``downshift``, ``retry``,
``preflight``, ``file``, ``slab``, ``campaign`` — with file, slab,
bucket, B, rung, family and engine attributes. Spans nest per thread
(the prefetch workers record their own ``read`` spans concurrently with
the consumer's ``resolve`` spans) and export as Chrome-trace JSON that
Perfetto / ``chrome://tracing`` loads directly. Every enabled span also
enters a ``torch.profiler.record_function`` of the same name, so a
``torch.profiler`` capture of the card carries the same vocabulary and
the two timelines correlate by name.

Disabled (the default), :func:`span` returns a shared no-op singleton:
no span object, no clock read, no torch import, no device work — the
overhead is a dict build and one attribute check per call site.
Enable via ``DAS_TRACE=1``, :func:`enable`, or per campaign with
``run_campaign*(trace=True)`` — which also exports ``trace.json`` next
to the manifest (:func:`campaign_trace`).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional

__all__ = [
    "campaign_trace", "current_span_id", "disable", "enable", "enabled",
    "export_chrome_trace", "span", "spans", "timed_best",
]

_lock = threading.Lock()
_ids = itertools.count(1)
_events: List[Dict] = []    # finished spans, append-ordered (exit order)
_dropped = 0                # spans past the buffer cap (counted, not kept)
_active_campaigns = 0       # open campaign_trace contexts (consume guard)
_tls = threading.local()    # per-thread open-span id stack


def _buffer_cap() -> int:
    """Span-buffer ceiling (``DAS_TRACE_BUFFER``, default 200k): an
    always-on (``DAS_TRACE=1``) service must not grow the flight
    record without bound — past the cap new spans are counted as
    dropped instead of kept (:func:`n_dropped`)."""
    try:
        return int(os.environ.get("DAS_TRACE_BUFFER", 200_000))
    except ValueError:
        return 200_000


def n_dropped() -> int:
    """Spans dropped past the ``DAS_TRACE_BUFFER`` cap."""
    return _dropped


def _env_enabled() -> bool:
    return os.environ.get("DAS_TRACE", "") not in ("", "0", "false")


_enabled = _env_enabled()


def enabled() -> bool:
    """Is span recording on (``DAS_TRACE`` / :func:`enable`)?"""
    return _enabled


def enable(clear: bool = False) -> None:
    """Turn span recording on (``clear=True`` drops prior spans)."""
    global _enabled, _dropped
    with _lock:
        if clear:
            _events.clear()
            _dropped = 0
        _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def spans() -> List[Dict]:
    """Snapshot of the finished spans recorded so far."""
    with _lock:
        return list(_events)


def take_spans(start: int = 0) -> List[Dict]:
    """Atomically remove and return the spans from index ``start`` on —
    the per-campaign export primitive: consuming what it exports keeps
    the global buffer from accumulating across repeated traced
    campaigns in one process (a long-lived service would otherwise walk
    into the ``DAS_TRACE_BUFFER`` cap and silently export empty
    traces)."""
    with _lock:
        out = _events[start:]
        del _events[start:]
        return out


def n_spans() -> int:
    with _lock:
        return len(_events)


def current_span_id() -> Optional[int]:
    """The innermost open span's id on this thread (None when disabled
    or outside any span) — what the manifest ledger events stamp."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


class _NoopSpan:
    """The disabled-mode singleton: a reusable no-op context manager.
    ``span_id`` is None so ledger stamping degrades to no stamp."""

    __slots__ = ()
    span_id = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class _Span:
    """One live span: records itself into the trace buffer on exit and
    mirrors its name onto the profiler's timeline via
    ``torch.profiler.record_function``."""

    __slots__ = ("name", "attrs", "span_id", "parent_id", "_t0", "_ann")

    def __init__(self, name: str, attrs: Dict):
        self.name = name
        self.attrs = attrs
        self.span_id = next(_ids)
        self.parent_id = None
        self._t0 = 0.0
        self._ann = None

    def __enter__(self):
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        self.parent_id = stack[-1] if stack else None
        stack.append(self.span_id)
        try:
            import torch

            self._ann = torch.profiler.record_function(self.name)
            self._ann.__enter__()
        except Exception:  # noqa: BLE001 — tracing must never break work
            self._ann = None
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        if self._ann is not None:
            try:
                self._ann.__exit__(exc_type, exc, tb)
            except Exception:  # noqa: BLE001
                pass
        stack = getattr(_tls, "stack", None)
        if stack and stack[-1] == self.span_id:
            stack.pop()
        rec = {
            "name": self.name, "span_id": self.span_id,
            "parent_id": self.parent_id, "t0": self._t0, "t1": t1,
            "thread": threading.get_ident(), "attrs": self.attrs,
        }
        if exc_type is not None:
            rec["error"] = exc_type.__name__
        global _dropped
        with _lock:
            if len(_events) < _buffer_cap():
                _events.append(rec)
            else:
                _dropped += 1
        return False


def span(name: str, **attrs):
    """A named, attributed span context manager.

    The hot-path entry point: when tracing is disabled this returns the
    shared no-op singleton (``span("a") is span("b")``) — no object, no
    clock read, no torch. Enabled, the span records ``(t0, t1, thread,
    parent, attrs)`` into the trace buffer and annotates the device
    timeline under the same name. Use it ``with span("resolve",
    rung="batched:4", family="mf") as sp:`` — ``sp.span_id`` is what the
    manifest ledger stamps (None when disabled).
    """
    if not _enabled:
        return _NOOP
    return _Span(name, attrs)


# ---------------------------------------------------------------------------
# Chrome-trace / Perfetto export
# ---------------------------------------------------------------------------


def chrome_trace_events(records=None) -> List[Dict]:
    """The recorded spans as Chrome-trace ``"X"`` (complete) events —
    timestamps/durations in microseconds on the ``perf_counter`` clock,
    span/parent ids and the span attributes under ``args``."""
    pid = os.getpid()
    out = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": "das4whales_tpu_torch campaign"},
    }]
    for rec in (spans() if records is None else records):
        args = {"span_id": rec["span_id"]}
        if rec.get("parent_id") is not None:
            args["parent_span_id"] = rec["parent_id"]
        if rec.get("error"):
            args["error"] = rec["error"]
        args.update(rec["attrs"])
        out.append({
            "name": rec["name"], "ph": "X", "pid": pid,
            "tid": rec["thread"] % (1 << 31),
            "ts": rec["t0"] * 1e6, "dur": (rec["t1"] - rec["t0"]) * 1e6,
            "args": args,
        })
    return out


def export_chrome_trace(path: str, records=None) -> str:
    """Write the recorded spans as Chrome-trace JSON (Perfetto- and
    ``chrome://tracing``-loadable); returns ``path``."""
    # local import: utils/__init__ imports telemetry.progress, so a
    # module-level import here would cycle at package-init time
    from ..utils import artifacts

    payload = {"traceEvents": chrome_trace_events(records),
               "displayTimeUnit": "ms"}
    return artifacts.atomic_json(path, payload)


@contextlib.contextmanager
def campaign_trace(outdir: str, trace=None, name: str = "campaign",
                   **attrs):
    """The campaign runners' tracing harness.

    ``trace=None`` defers to the ``DAS_TRACE`` env (so an operator can
    flight-record any campaign without touching code); ``True`` enables
    for this campaign only; ``False`` opts this campaign out of the
    root span and the ``trace.json`` export — it does NOT flip the
    process-wide recording switch (under ``DAS_TRACE=1`` raw spans
    still record to the capped buffer; another thread's traced
    campaign must not lose them). When tracing is on,
    the whole campaign runs inside a root ``name`` span (so spans cover
    the campaign wall by construction) and the spans recorded DURING
    the campaign export to ``<outdir>/trace.json`` next to the manifest
    on exit — including the failure path, so a crashed campaign still
    leaves its flight record.
    """
    on = (_env_enabled() or _enabled) if trace is None else bool(trace)
    if not on:
        # trace=False opts THIS campaign out of the root span and the
        # trace.json export; it does not flip the process-wide recording
        # switch (another thread's traced campaign must not lose spans)
        yield _NOOP
        return
    global _active_campaigns
    was = _enabled
    enable()
    with _lock:
        _active_campaigns += 1
    start = n_spans()
    try:
        with span(name, **attrs) as sp:
            yield sp
    finally:
        if not was:
            disable()
        with _lock:
            _active_campaigns -= 1
            alone = _active_campaigns == 0
        try:
            # CONSUME what we export (back-to-back traced campaigns each
            # get a complete, bounded trace instead of accumulating the
            # process buffer toward the DAS_TRACE_BUFFER cap) — but only
            # when no SIBLING traced campaign is still open: index-based
            # consumption would steal an overlapping campaign's spans,
            # so the overlapped case exports a snapshot and leaves the
            # buffer to the last one out
            recs = take_spans(start) if alone else spans()[start:]
            export_chrome_trace(os.path.join(outdir, "trace.json"),
                                records=recs)
        except OSError:  # noqa: PERF203 — the campaign outcome wins
            pass


# ---------------------------------------------------------------------------
# The one timing definition
# ---------------------------------------------------------------------------


def _block(tree) -> None:
    """Wait for every CUDA tensor in ``tree`` (a tensor, or nested
    tuples/lists/dicts of them): each device's stream is synchronized
    once. Host values need no wait."""
    import torch

    devices = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(tree)
    for dev in devices:
        torch.cuda.synchronize(dev)


def timed_best(fn, *args, repeats: int = 3, name: str = "timed", **attrs):
    """Best-of-``repeats`` wall of ``fn(*args)`` with the result blocked
    to completion — CUDA launches are asynchronous and un-blocked timing
    lies: a CUDA tensor in the result synchronizes its device before the
    clock stops. One warm call first (its result is returned), then each
    measured repeat runs inside a ``name`` span so a trace shows the
    measurement itself. Returns ``(best_seconds, warm_result)``.
    """
    out = fn(*args)
    _block(out)
    best = float("inf")
    for _ in range(max(1, repeats)):
        with span(name, **attrs):
            t0 = time.perf_counter()
            _block(fn(*args))
            best = min(best, time.perf_counter() - t0)
    return best, out
