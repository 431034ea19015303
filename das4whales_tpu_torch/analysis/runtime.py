"""Runtime complement to the static pass: the probe-and-build guard (the
counterpart of ``das4whales_tpu.analysis.runtime``).

JAX's guard counts XLA backend compiles: a hot entry point called twice
at the same shapes must compile at most once. Eager PyTorch compiles no
program, but two things in the port are done once per shape (or once per
process) and are expensive:

* the cold probe of a priced program (``utils.memory.probe_program``:
  the program run once on a zero slab, its peak and cold wall measured,
  then memoized by the program's key; on the CPU, the recording run the
  program-contract audit asks for) — its wall is a cost card's
  ``compile_seconds`` and ``das_compiles_total`` counts it
  (``telemetry/costs.py``);
* a hand-written kernel library's build or load (``utils.build.load``:
  ``nvcc`` at first use, then ``ctypes``).

:func:`compile_count` is their sum (``utils.memory.probes`` +
``utils.build.loads``). A second probe or build at the same shapes is
the port's retrace: a program key that churns (a batch size, a dtype, a
design size), or a cache that was dropped. The ``torch_compile_guard``
pytest fixture (``analysis/pytest_plugin.py``) hands tests this module.

Usage::

    from das4whales_tpu_torch.analysis.runtime import max_compiles

    with max_compiles(1, what="detect_picks"):
        det.detect_picks(raw)
        det.detect_picks(raw)   # same shapes: nothing probed or built again
"""

from __future__ import annotations

import contextlib


class RecompileError(AssertionError):
    """A guarded region probed or built more than its ceiling."""


def compile_count() -> int:
    """Cold program probes plus kernel library builds and loads in this
    process."""
    from ..utils import build, memory

    return int(memory.probes) + int(build.loads)


@contextlib.contextmanager
def max_compiles(ceiling: int, what: str = "guarded region"):
    """Fail with :class:`RecompileError` if the block probes and builds
    more than ``ceiling`` times. ``ceiling=0`` after a warm-up call is the
    steady-state contract; ``ceiling=1`` over two same-shape invocations
    is the cold-start form."""
    start = compile_count()
    yield
    n = compile_count() - start
    if n > ceiling:
        raise RecompileError(
            f"{what}: {n} program probes and kernel builds, ceiling {ceiling} — "
            "a program key churns (shape, batch, dtype or design size) or a "
            "memoized probe or library was dropped"
        )


@contextlib.contextmanager
def forbid_recompile(what: str = "guarded region"):
    """``max_compiles(0)``: the steady-state contract for warmed entry
    points."""
    with max_compiles(0, what=what):
        yield


def count_compiles(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)``, returning ``(result, n)``: the probes
    and builds it made."""
    start = compile_count()
    result = fn(*args, **kwargs)
    return result, compile_count() - start
