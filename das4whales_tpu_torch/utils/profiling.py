"""Profiling and progress surfaces (the port's copy of
``das4whales_tpu.utils.profiling``).

Device profiles through ``torch.profiler`` (CUPTI on the card), named
spans on its timeline, a best-of wall clock that waits for the card, a
host wall-clock timer of named stages, and the deprecated progress alias.

Work queued on the card runs after the host has moved on, so a stage
timed on the host clock alone measures its enqueue. ``StageTimer(sync=
torch.cuda.synchronize)`` waits for the card at the end of each stage,
so each span covers the stage's device work too; :func:`block_and_time`
waits for every CUDA tensor in the result.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, Iterator

#: host seconds a profiler session (:func:`device_trace`, ``chip_smoke.py``)
#: waits, the card idle, before the traced work: in a long run the profiler
#: has lost the records of a session's first kernels (a learned call's
#: first 33 of 53 launches, once; all 20 launches of a 5 ms kernel, once)
PROFILER_SETTLE_S = 0.5


@contextlib.contextmanager
def device_trace(logdir: str):
    """Profile the body with ``torch.profiler`` and write a Chrome trace
    (``<host>_<pid>.<ns>.pt.trace.json``, for TensorBoard or Perfetto)
    under ``logdir``; yields ``logdir``.

    With a card present the session records CPU and CUDA activity: it
    synchronizes before and after the body and idles
    :data:`PROFILER_SETTLE_S` inside the session before it. A session
    there that recorded no CUDA activity raises ``RuntimeError`` and
    writes nothing: a trace of the host alone is not a device trace.
    Without a card it records the host's activity. Nothing is written
    when the body raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        time.sleep(PROFILER_SETTLE_S)
        yield logdir
        if cuda:
            torch.cuda.synchronize()
    if cuda and not any(str(e.device_type).endswith("CUDA") for e in prof.events()):
        raise RuntimeError(
            "device_trace: the profiler recorded no CUDA activity in this session; "
            "no trace was written")
    prof.export_chrome_trace(os.path.join(
        logdir, f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json"))


def annotate(name: str):
    """A named span on the profiler's timeline, as a context manager (use
    around pipeline stages); the mechanism of the telemetry spans."""
    import torch

    return torch.profiler.record_function(name)


def block_and_time(fn, *args, repeats: int = 3, **kwargs):
    """Best-of-``repeats`` wall time of ``fn(*args)`` with every CUDA
    tensor of the result waited for (launches are asynchronous;
    un-blocked timing lies).

    Returns ``(best_seconds, result)``; the warm-up call is excluded.
    Delegates to the one timing definition, ``telemetry.trace.
    timed_best``: each measured repeat is a ``timed`` span when tracing
    is on."""
    from ..telemetry import trace as _trace

    return _trace.timed_best(
        (lambda *a: fn(*a, **kwargs)) if kwargs else fn,
        *args, repeats=repeats,
    )


@dataclass
class StageTimer:
    """Accumulates named wall-clock spans across a run (host side);
    ``sync``, when given, is called at the end of each stage."""

    totals: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)
    sync: Callable[[], None] | None = None

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync is not None:
                self.sync()
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = [
            f"  {name:<28s} {self.totals[name]:8.3f} s  (x{self.counts[name]})"
            for name in sorted(self.totals, key=self.totals.get, reverse=True)
        ]
        return "\n".join(lines)


def progress(iterable: Iterable, desc: str | None = None, total: int | None = None) -> Iterator:
    """DEPRECATED alias of ``telemetry.progress.progress``; import from
    there. It keeps ``total``, ``desc`` and ``len()``, and records a
    ``progress`` span when tracing is on."""
    import warnings

    warnings.warn(
        "das4whales_tpu_torch.utils.profiling.progress is deprecated; use "
        "das4whales_tpu_torch.telemetry.progress.progress",
        DeprecationWarning, stacklevel=2,
    )
    from ..telemetry.progress import progress as _progress

    return _progress(iterable, desc=desc, total=total)
