"""Depth-D software-pipelined device dispatch (the port's copy of
``das4whales_tpu.parallel.dispatch``).

A campaign keeps the card's queue non-empty: it dispatches slab k+1 (and
k+2, … up to depth D) BEFORE taking slab k's packed fetch, so while the
host finalizes slab k's manifest records the card is already computing
the successors. In eager PyTorch a dispatch is the host enqueueing the
detection program's kernels on the CUDA stream, followed by the
program's one packed device->host copy into pinned memory and an event
recorded after it (``models.matched_filter.PackedFetch``); the fetch
then waits on THAT event only — never on ``torch.cuda.synchronize()``,
which would also wait for the successors queued behind it.

* :class:`PipelinedDispatch` — the bounded FIFO of dispatched,
  unresolved tokens. One fetch per slab still happens — it is the data
  dependency — but it overlaps compute on the successors, and the
  campaign takes no other sync: one ``drain()`` ends the segment.
* :func:`resolve_watchdogged` — one watchdogged dispatch/resolve, shared
  by every campaign flavor and detector family: the chaos dispatch hook
  fires inside the deadline, and the watchdog's worker thread runs on
  the caller's CUDA stream.
* :func:`launch` / :func:`fetch` / :func:`sync` — counted wrappers
  around a dispatch and the two sync primitives, feeding the
  process-wide ``faults.counters()`` ``dispatches``/``syncs`` tallies.

Failure attribution contract: a token is (key, handle) — the key names
the originating slab/file. Dispatch-time errors never enter the queue
(the caller handles them synchronously); an in-flight failure surfaces
when the campaign resolves that token at its own position in the drain
order, inside the campaign's watchdog/ladder/retry wrappers — so
pipelining changes WHEN a failure surfaces, never WHERE it is
attributed.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from collections import deque
from typing import Any, Iterator, List, Tuple

import numpy as np

from .. import faults
from ..config import dispatch_depth_default
from ..telemetry import metrics, probes, trace
from ..utils import oprecord

_resolves = metrics.counter(
    "das_rung_resolves_total",
    "watchdogged dispatch/resolve calls by rung, family and outcome",
    ("rung", "family", "outcome"),
)
_queue_depth = metrics.gauge(
    "das_dispatch_queue_depth",
    "PipelinedDispatch tokens currently in flight (dispatched, unresolved)",
)
_residency = metrics.histogram(
    "das_dispatch_inflight_residency_seconds",
    "seconds a PipelinedDispatch token spent in flight (submit to resolve)",
)
_watchdog_margin = metrics.histogram(
    "das_watchdog_deadline_margin_seconds",
    "dispatch_deadline_s minus the resolve wall — headroom before the "
    "watchdog would have fired (a shrinking margin predicts timeouts)",
)


def _caller_stream():
    """The calling thread's current CUDA stream, or None where CUDA was
    never initialized (nothing on the card to order)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None
    return torch.cuda.current_stream()


def _on_stream(stream):
    """Run the block on ``stream`` (a CUDA stream, or None: as is). The
    current stream is per thread, so the watchdog's worker must be told
    the stream its caller's work — and the slab's ready-event wait — is
    on."""
    if stream is None:
        return contextlib.nullcontext()
    import torch

    return torch.cuda.stream(stream)


def resolve_watchdogged(fn, paths, rung, deadline_s, fault_plan=None,
                        family: str = ""):
    """One watchdogged device dispatch/resolve: the chaos harness's
    dispatch hook (``faults.FaultPlan.on_dispatch``) fires for each of
    ``paths`` INSIDE the deadline-bounded callable — exactly where a
    real wedged or out-of-memory launch surfaces — and the whole call is
    bounded by ``deadline_s`` (``faults.call_with_deadline``; None runs
    inline). With a deadline the call runs on the watchdog's worker
    thread, on the caller's CUDA stream. Raises ``fn``'s own failure,
    the injected fault, or ``faults.DispatchDeadlineExceeded`` on a
    wedge — every escaping exception is annotated with the rung it
    failed at (``campaign_rung``), so a terminal failure record can name
    the executing route (``FileRecord.rung``)."""
    stream = _caller_stream() if deadline_s is not None else None

    def run():
        with _on_stream(stream):
            if fault_plan is not None:
                for p in paths:
                    fault_plan.on_dispatch(p, rung)
            return fn()

    label = faults.rung_label(rung)
    outcome = "error"
    with trace.span("resolve", rung=label, family=family,
                    n_files=len(paths),
                    file=os.path.basename(paths[0]) if paths else ""):
        t0 = time.perf_counter()
        try:
            out = faults.call_with_deadline(
                run, deadline_s, paths[0] if paths else "<dispatch>"
            )
            outcome = "ok"
            if deadline_s is not None:
                _watchdog_margin.observe(
                    max(0.0, deadline_s - (time.perf_counter() - t0))
                )
            return out
        except faults.DispatchDeadlineExceeded as exc:
            outcome = "timeout"
            if deadline_s is not None:
                _watchdog_margin.observe(0.0)
            exc.campaign_rung = label
            raise
        except Exception as exc:
            try:
                exc.campaign_rung = label
            except Exception:  # noqa: BLE001 — slots/frozen exc: skip the tag
                pass
            raise
        finally:
            _resolves.inc(rung=label, family=family, outcome=outcome)


def launch(fn, *args, **kwargs):
    """Dispatch a device program asynchronously: call ``fn`` (a program
    launcher), count the dispatch, return its still-in-flight outputs
    WITHOUT syncing. Pair the eventual read with :func:`fetch` so it is
    counted."""
    faults.count("dispatches")
    with trace.span("dispatch"):
        return fn(*args, **kwargs)


def _to_host(tree):
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return np.asarray(tree) if hasattr(tree, "__array__") else tree


def fetch(tree):
    """Counted blocking fetch: every tensor in ``tree`` (nested tuples,
    lists, dicts) to host numpy — the ONE sync its dispatch chain pays."""
    faults.count("syncs")
    with trace.span("fetch"), oprecord.counted_read():
        out = _to_host(tree)
    probes.note_dispatch_ok()   # the runtime answered: liveness heartbeat
    return out


def sync(tree):
    """Counted wait for every CUDA tensor in ``tree`` to be computed
    (for callers that need the tensors resident on the card, not on
    the host)."""
    faults.count("syncs")
    with trace.span("sync"), oprecord.counted_read():
        trace._block(tree)
    probes.note_dispatch_ok()
    return tree


class PipelinedDispatch:
    """A bounded queue of in-flight (dispatched, unresolved) tokens.

    ``depth`` is the maximum number of tokens in flight (None: the
    ``DAS_DISPATCH_DEPTH`` env default, 2). ``depth <= 1`` disables
    pipelining — :attr:`enabled` is False and callers fall back to
    their synchronous dispatch-then-fetch path.

    Usage (the campaign pattern)::

        pipe = PipelinedDispatch(depth)
        for slab in slabs:
            handle = try_dispatch(slab)          # async launch, or None
            if handle is None:                   # ineligible: sync path
                for key, h in pipe.drain():      # FIFO: order preserved
                    finalize(key, h)
                finalize_sync(slab)
                continue
            for key, h in pipe.submit(slab, handle):
                finalize(key, h)                 # resolve = the one sync
        for key, h in pipe.drain():
            finalize(key, h)

    The queue is FIFO: tokens come back in submission order, so
    manifest records keep the campaign's file order and a failure
    surfacing at ``finalize`` is attributed to ITS key.
    """

    def __init__(self, depth: int | None = None):
        self.depth = dispatch_depth_default() if depth is None else int(depth)
        self._q: deque = deque()

    @property
    def enabled(self) -> bool:
        return self.depth >= 2

    def __len__(self) -> int:
        return len(self._q)

    def in_flight(self) -> int:
        """Tokens currently dispatched and unresolved — the queue depth
        the ``das_dispatch_queue_depth`` gauge mirrors."""
        return len(self._q)

    def pending(self) -> Tuple[Any, ...]:
        """The KEYS of the in-flight tokens, oldest first — what would
        come back from :meth:`drain`, without resolving anything."""
        return tuple(key for key, _handle, _t in tuple(self._q))

    def _note_depth(self) -> None:
        _queue_depth.set(self.in_flight())

    def _pop(self) -> Tuple[Any, Any]:
        key, handle, t_in = self._q.popleft()
        self._note_depth()
        _residency.observe(time.perf_counter() - t_in)
        return key, handle

    def submit(self, key: Any, handle: Any) -> List[Tuple[Any, Any]]:
        """Enqueue a dispatched token; returns the (key, handle) tokens
        that must be resolved NOW to keep at most ``depth`` in flight
        (oldest first)."""
        self._q.append((key, handle, time.perf_counter()))
        self._note_depth()
        out: List[Tuple[Any, Any]] = []
        while len(self._q) > self.depth:
            out.append(self._pop())
        return out

    def drain(self) -> Iterator[Tuple[Any, Any]]:
        """Yield every queued token oldest-first (the end-of-segment —
        or pre-sync-path — flush). Resolving the last token is the
        segment's single remaining sync."""
        while self._q:
            yield self._pop()
