"""Runtime complement to the concurrency rules: seeded interleaving (the
counterpart of ``das4whales_tpu.analysis.concurrency_runtime``, over the
port's own ``utils.locks``).

The static pass (R8–R10, ``analysis/concurrency.py``) proves lock
discipline by shape; this guard shakes the SCHEDULE. Inside a
:func:`race_guard` region:

* ``sys.setswitchinterval`` shrinks to a seeded tiny value, so the
  interpreter preempts threads hundreds of times more often than the
  5 ms production default — orderings that happen once a week in
  production happen every run;
* every :class:`~das4whales_tpu_torch.utils.locks.TracedLock` acquisition
  gets a seeded yield point (``time.sleep(0)`` by a per-seed coin), so
  contended critical sections interleave differently per seed — the
  service stack's locks are all TracedLocks
  (``utils.locks.new_lock``), so the whole serving surface is
  instrumented for free;
* the process-wide lock-ORDER graph resets on entry; on clean exit the
  guard FAILS with :class:`LockOrderError` if any acquisition inverted
  the established order (the dynamic form of R9's cycle check), and
  with :class:`TornIterationError` if any thread died of the classic
  torn-iteration ``RuntimeError: ... changed size during iteration``
  (R8's hazard, observed live via ``threading.excepthook``).

The ``torch_race_guard`` pytest fixture (``analysis/pytest_plugin.py``)
hands tests this context manager — the analog of ``torch_compile_guard``
for the concurrency half; the port's service drill runs under it with
its endpoints polled from client threads.
"""

from __future__ import annotations

import contextlib
import random
import sys
import threading
import time
from typing import List, Optional


class LockOrderError(AssertionError):
    """A traced-lock acquisition inverted the established lock order —
    the dynamic witness of an R9 ``lock-order`` hazard."""


class TornIterationError(AssertionError):
    """A thread died iterating a structure another thread mutated —
    the dynamic witness of an R8 ``unguarded-snapshot-read`` hazard."""


class GuardReport:
    """Live view handed to the guarded block: the recorded inversions
    and thread exceptions so far (for mid-drill assertions)."""

    def __init__(self):
        self.thread_errors: List[threading.ExceptHookArgs] = []

    @staticmethod
    def inversions() -> List[dict]:
        from ..utils import locks

        return locks.inversions()


def _is_torn_iteration(exc: BaseException) -> bool:
    return (isinstance(exc, RuntimeError)
            and "changed size during iteration" in str(exc))


@contextlib.contextmanager
def race_guard(seed: int = 0, switch_interval: Optional[float] = None,
               yield_prob: float = 0.05):
    """Run the block under seeded interleaving pressure; fail on lock
    order inversions or torn iterations observed anywhere in the
    process. ``switch_interval=None`` derives a tiny seeded value
    (~50–100 µs; the production default is 5 ms)."""
    from ..utils import locks

    rng = random.Random(seed)
    if switch_interval is None:
        switch_interval = 5e-5 * (1.0 + rng.random())
    old_interval = sys.getswitchinterval()
    report = GuardReport()
    old_hook = threading.excepthook

    def hook(args):
        report.thread_errors.append(args)
        old_hook(args)

    # random.Random is effectively atomic per call under the GIL; the
    # coin only has to be SEEDED, not precisely sequenced per thread
    def maybe_yield():
        if rng.random() < yield_prob:
            time.sleep(0)

    locks.reset_order_graph()
    locks.set_yield(maybe_yield)
    sys.setswitchinterval(switch_interval)
    threading.excepthook = hook
    try:
        yield report
    finally:
        threading.excepthook = old_hook
        sys.setswitchinterval(old_interval)
        locks.set_yield(None)
    # reached only when the block itself exited cleanly
    inv = locks.inversions()
    if inv:
        detail = "; ".join(
            f"{' -> '.join(i['cycle'])} (thread {i['thread']})"
            for i in inv[:4]
        )
        raise LockOrderError(
            f"race_guard(seed={seed}): {len(inv)} lock-order "
            f"inversion(s) recorded — {detail}. Two threads taking these "
            "locks from opposite ends deadlock; impose one global order "
            "(the R9 lock-order rule)."
        )
    torn = [e for e in report.thread_errors
            if e.exc_value is not None and _is_torn_iteration(e.exc_value)]
    if torn:
        raise TornIterationError(
            f"race_guard(seed={seed}): {len(torn)} thread(s) died of a "
            f"torn iteration: {torn[0].exc_value} in thread "
            f"{getattr(torn[0].thread, 'name', '?')} — snapshot under a "
            "shared lock or copy-on-read (the R8 snapshot rule)."
        )
