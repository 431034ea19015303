"""Traced locks (the port's copy of ``das4whales_tpu.utils.locks``).

:class:`TracedLock` wraps a ``threading.Lock`` with a NAME and three
behaviors:

* **lock-order recording** — every acquisition taken while the thread
  already holds other traced locks adds ``held -> acquired`` edges to a
  process-wide graph keyed by lock name (a lock *class*, not an
  instance: two tenants' ring locks share the node ``ring``, so an
  AB/BA nesting between any two instances of two classes is caught).
  An edge that closes a cycle is recorded as an INVERSION
  (:func:`inversions`, which the service's tests hold empty).
* **contention metrics** — acquire wait and hold duration land in the
  ``das_lock_wait_seconds{name}`` / ``das_lock_held_seconds{name}``
  histograms (``telemetry.metrics``), so the service's ``/metrics``
  exposition shows WHERE serving threads queue.
* **yield injection** — an optional pre-acquire hook (:func:`set_yield`)
  that a test installs with a seeded RNG to sleep(0) at instrumented
  acquisitions, shaking thread interleavings.

``new_lock(name)`` is the factory the service stack uses for every
shared-state lock (``service/``, the manifest line index). The
telemetry registry's own lock stays a plain ``threading.Lock`` — it is
the hottest lock in the process and the histograms write through it,
so tracing it would recurse.

A :class:`TracedLock` is Condition-compatible: ``threading.Condition(
new_lock("ring"))`` routes the condition's acquire/release (including
the release/re-acquire inside ``wait``) through the tracing, so held
time excludes the wait.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..telemetry import metrics

__all__ = [
    "TracedLock", "find_cycle", "inversions", "new_lock", "order_edges",
    "reset_order_graph", "set_yield",
]

#: lock waits/holds run microseconds..seconds — finer buckets than the
#: span-flavored defaults (a 1 ms floor would hide all healthy waits in
#: the first bucket).
_LOCK_BUCKETS = (1e-6, 1e-5, 1e-4, 1e-3, 5e-3, 0.01, 0.05, 0.1, 0.5,
                 1.0, 5.0, 30.0)

_h_wait = metrics.histogram(
    "das_lock_wait_seconds",
    "seconds spent waiting to acquire a traced lock, by lock name "
    "(contention: a climbing p95 means serving threads queue here)",
    ("name",), buckets=_LOCK_BUCKETS,
)
_h_held = metrics.histogram(
    "das_lock_held_seconds",
    "seconds a traced lock was held per acquisition, by lock name "
    "(long holds under load mean blocking work under the lock)",
    ("name",), buckets=_LOCK_BUCKETS,
)

# -- the process-wide acquisition-order graph --------------------------------

_graph_lock = threading.Lock()     # plain: guards the graph itself
_edges: Dict[str, Set[str]] = {}   # held name -> {acquired name}
_edge_sites: Dict[Tuple[str, str], str] = {}   # edge -> first thread seen
_inversions: List[Dict] = []       # recorded cycles (never trimmed)

_tls = threading.local()           # per-thread held-lock stack


def _held_stack() -> List[List]:
    st = getattr(_tls, "held", None)
    if st is None:
        st = _tls.held = []
    return st


# yield-injection hook: called before every traced acquire
_yield_hook: Optional[Callable[[], None]] = None


def set_yield(hook: Optional[Callable[[], None]]) -> None:
    """Install (or clear, with None) the pre-acquire yield hook."""
    global _yield_hook
    _yield_hook = hook


def _reach(src: str, dst: str, edges: Dict[str, Set[str]],
           path: List[str]) -> Optional[List[str]]:
    """DFS: a path src -> ... -> dst through ``edges``, or None."""
    if src == dst:
        return path + [dst]
    for nxt in edges.get(src, ()):
        if nxt in path:
            continue
        found = _reach(nxt, dst, edges, path + [src])
        if found is not None:
            return found
    return None


def _note_acquire(name: str, held_names: List[str]) -> None:
    """Record held->name edges; an edge closing a cycle is an inversion."""
    tname = threading.current_thread().name
    with _graph_lock:
        for h in held_names:
            if h == name:
                # same lock CLASS nested (two ring instances inside each
                # other): an AB/BA hazard between any two instances —
                # recorded as a self-cycle inversion
                _inversions.append({
                    "cycle": [name, name], "thread": tname,
                    "note": "nested acquisition of two instances of the "
                            f"same lock class {name!r}",
                })
                continue
            if name not in _edges.get(h, ()):
                # would h -> name close a cycle? (name already reaches h)
                cyc = _reach(name, h, _edges, [])
                if cyc is not None:
                    _inversions.append({
                        "cycle": cyc + [name], "thread": tname,
                        "note": f"acquiring {name!r} while holding {h!r} "
                                f"inverts the established order "
                                f"{' -> '.join(cyc)}",
                    })
                _edges.setdefault(h, set()).add(name)
                _edge_sites.setdefault((h, name), tname)


def order_edges() -> Dict[str, Tuple[str, ...]]:
    """The observed acquisition-order graph (name -> successors)."""
    with _graph_lock:
        return {k: tuple(sorted(v)) for k, v in _edges.items()}


def inversions() -> List[Dict]:
    """Every lock-order inversion recorded since the last reset."""
    with _graph_lock:
        return [dict(i) for i in _inversions]


def reset_order_graph() -> None:
    """Clear the graph and inversion log (tests)."""
    with _graph_lock:
        _edges.clear()
        _edge_sites.clear()
        _inversions.clear()


def find_cycle() -> Optional[List[str]]:
    """A cycle in the current graph, if one exists (diagnostics)."""
    with _graph_lock:
        edges = {k: set(v) for k, v in _edges.items()}
    for start in edges:
        for nxt in edges.get(start, ()):
            path = _reach(nxt, start, edges, [])
            if path is not None:
                return [start] + path
    return None


class TracedLock:
    """A named ``threading.Lock`` wrapper: order-graph recording,
    wait/held histograms, and the yield point. Supports the
    context-manager protocol and the ``acquire``/``release``/``locked``
    surface ``threading.Condition`` needs."""

    __slots__ = ("name", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        hook = _yield_hook
        if hook is not None:
            hook()
        held = _held_stack()
        t0 = time.perf_counter()
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            t1 = time.perf_counter()
            _h_wait.observe(t1 - t0, name=self.name)
            if held:
                _note_acquire(self.name, [e[0] for e in held])
            held.append([self.name, t1])
        return ok

    def release(self) -> None:
        held = _held_stack()
        for i in range(len(held) - 1, -1, -1):
            if held[i][0] == self.name:
                _, t_acq = held.pop(i)
                _h_held.observe(time.perf_counter() - t_acq, name=self.name)
                break
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "TracedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"TracedLock({self.name!r}, locked={self.locked()})"


def new_lock(name: str) -> TracedLock:
    """The service stack's lock factory: every shared-state lock gets a
    NAME so metrics, traces and the order graph attribute contention to
    a component instead of an anonymous ``<locked _thread.lock>``."""
    return TracedLock(name)
