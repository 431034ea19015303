"""A host wall-clock timer of named stages (the port's copy of
``das4whales_tpu.utils.profiling.StageTimer``).

Work queued on the card runs after the host has moved on, so a stage
timed on the host clock alone measures its enqueue. ``StageTimer(sync=
torch.cuda.synchronize)`` waits for the card at the end of each stage,
so each span covers the stage's device work too.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Callable, Dict


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
