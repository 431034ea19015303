"""Pytest plugin: the port's guard fixtures (the counterpart of
``das4whales_tpu.analysis.pytest_plugin``).

The fixtures are named so that they do not shadow the JAX package's
``compile_guard`` / ``retrace_guard`` / ``race_guard``:
``torch_compile_guard``, ``torch_retrace_guard`` and
``torch_race_guard``. A test file imports the ones it uses by name::

    from das4whales_tpu_torch.analysis.pytest_plugin import torch_compile_guard  # noqa: F401
"""

from __future__ import annotations

import pytest

from . import runtime


class CompileGuard:
    """Bound helper handed to tests: ceilings + raw counter access (a
    "compile" is a program probe or a kernel build, ``analysis.runtime``)."""

    max_compiles = staticmethod(runtime.max_compiles)
    forbid_recompile = staticmethod(runtime.forbid_recompile)
    count_compiles = staticmethod(runtime.count_compiles)

    @property
    def count(self) -> int:
        return runtime.compile_count()


@pytest.fixture
def torch_compile_guard() -> CompileGuard:
    """Probe-and-build guard: ``with torch_compile_guard.max_compiles(1,
    what=...):`` around two same-shape invocations of a hot entry point."""
    return CompileGuard()


@pytest.fixture
def torch_retrace_guard():
    """Retrace forensics: ``with torch_retrace_guard(1, what="price") as
    g:`` then call through ``g.watch(fn)`` wrappers — a ceiling breach
    raises naming the argument whose shape, dtype or static value
    changed (``analysis/programs.py``)."""
    from . import programs

    return programs.retrace_guard


@pytest.fixture
def torch_race_guard():
    """Seeded-interleaving guard over the port's ``utils.locks``: ``with
    torch_race_guard(seed=3): ...`` shrinks the switch interval, injects
    yields at TracedLock acquisitions, and fails on lock-order
    inversions or torn iterations (``analysis/concurrency_runtime.py``)."""
    from . import concurrency_runtime

    return concurrency_runtime.race_guard
