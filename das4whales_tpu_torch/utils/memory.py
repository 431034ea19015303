"""Memory preflight: measured device-memory peaks for campaign shapes
(the port's counterpart of ``das4whales_tpu.utils.memory``).

The batched runner (``workflows.campaign.run_campaign_batched(
preflight=True)``) and the service's per-tenant admission price every
candidate ``(bucket, B)`` batched program against a budget
(``DAS_HBM_BUDGET_GB``, ``config.hbm_budget_bytes``, or a tenant's
``hbm_share_gb``), start each bucket at the largest batch that fits and
skip shapes that fit at no rung, so the downshift ladder is the
recovery path for surprises, not the scheduler for known overflows.

JAX prices a program ahead of time (``lower().compile()
.memory_analysis()``); eager PyTorch has no such analysis, so the port
MEASURES the program once per shape (:func:`probe_program`):

* a zero slab ``[B, C, T]`` in the wire dtype is allocated, and the
  baseline is ``torch.cuda.memory_allocated()`` taken AFTER it, so the
  slab counts as an argument, as in JAX (whose ``peak`` is temps plus
  outputs, not arguments);
* the peak statistics are reset, the facade's priced program runs once
  (``program_spec``: the matched filter's full-capacity escalation
  attempt, K = ``max_peaks`` with ``topk`` — a zero slab saturates no
  row, so the K0 attempt alone would never price it), and the peak is
  ``max_memory_allocated() - baseline``;
* the measurement is memoized per program key: the facade's
  ``program_spec`` keys it on every quantity that sizes one of the
  program's buffers (shape, batch, dtype, health, route and mode, and
  the design's own sizes: templates and their length, the f-k band,
  tile, pick capacity, a family's windows and kernels). An eager
  program allocates by shape alone, so two designs that agree on all of
  these share one measured peak;
* an out-of-memory error inside the probe is the answer "over budget"
  (:attr:`MemoryStats.exhausted`), not a campaign error; the allocator's
  cache is emptied afterwards. That answer depends on what else held
  the card at the time, so it is never memoized: the next pricing of
  the same program probes again.

On the CPU there is no device memory to admit against: the probe
returns None, JAX's rule for a backend without ``memory_analysis()``,
which :func:`first_fitting` treats as fitting. Tests inject a pricer by
replacing :func:`batched_program_memory`.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Sequence, Tuple

import numpy as np

__all__ = [
    "MemoryStats",
    "ProgramAnalysis",
    "ProgramSpec",
    "batched_program_analysis",
    "batched_program_memory",
    "clear_probe_cache",
    "first_fitting",
    "max_fitting_batch",
    "probe_program",
]


@dataclass(frozen=True)
class MemoryStats:
    """One program's measured device-memory footprint (bytes).

    ``temp_bytes`` is the peak above the baseline less what the outputs
    still hold when the program returns (``output_bytes``);
    ``argument_bytes`` the slab's. ``peak`` (temps + outputs) is the
    admission figure, as in JAX. ``exhausted`` marks a probe that ran
    out of memory: it fits no budget."""

    temp_bytes: int
    output_bytes: int
    argument_bytes: int
    exhausted: bool = False

    @property
    def peak(self) -> int:
        return self.temp_bytes + self.output_bytes

    @property
    def total(self) -> int:
        return self.peak + self.argument_bytes

    def fits(self, budget_bytes: int) -> bool:
        return not self.exhausted and self.peak < int(budget_bytes)


@dataclass(frozen=True)
class ProgramAnalysis:
    """One probe's record for the cost observatory: the measured
    :class:`MemoryStats` (None on the CPU), the program's COUNTED
    operations and bytes (``ProgramSpec``; no compiler counts them in
    eager PyTorch) and ``compile_seconds``: the wall of the program's
    cold first run (cuFFT plans, module loads) — eager PyTorch compiles
    nothing, so this key carries the nearest cost; 0.0 where no probe
    ran."""

    memory: MemoryStats | None
    flops: float
    bytes_accessed: float
    transcendentals: float
    compile_seconds: float
    stages: Tuple[str, ...] = ()


@dataclass
class ProgramSpec:
    """A batched facade's priced program (``program_spec``): ``run``
    runs it once on a ``[B, C, T]`` stack of ``dtype`` on ``device`` and
    returns its outputs; ``key`` memoizes the probe; ``flops``,
    ``bytes_accessed`` and ``transcendentals`` are the program's counts
    over ``stages`` (each stage reads its inputs and writes its outputs
    once)."""

    family: str
    run: Callable[[Any], Any]
    shape: Tuple[int, int, int]
    dtype: np.dtype
    device: Any
    key: tuple
    flops: float = 0.0
    bytes_accessed: float = 0.0
    transcendentals: float = 0.0
    stages: Tuple[str, ...] = ()


_memo_lock = threading.Lock()
_memo: Dict[tuple, Tuple[MemoryStats, float]] = {}


def clear_probe_cache() -> None:
    """Forget every memoized probe (tests, or after the card's state
    changed)."""
    with _memo_lock:
        _memo.clear()


def _torch_dtype(dtype):
    import torch

    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def _measure(spec: ProgramSpec) -> Tuple[MemoryStats, float]:
    """One probe on the card (module docstring)."""
    import torch

    from .. import faults

    dev = spec.device
    torch.cuda.synchronize(dev)
    stack = out = None
    try:
        stack = torch.zeros(spec.shape, dtype=_torch_dtype(spec.dtype), device=dev)
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = spec.run(stack)
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        peak = max(0, torch.cuda.max_memory_allocated(dev) - base)
        held = min(peak, max(0, torch.cuda.memory_allocated(dev) - base))
        return (MemoryStats(temp_bytes=peak - held, output_bytes=held,
                            argument_bytes=stack.numel() * stack.element_size()), wall)
    except Exception as exc:  # noqa: BLE001 — out of memory is an answer
        if faults.classify_failure(exc) != "resource":
            raise
        total = torch.cuda.get_device_properties(dev).total_memory
        arg = int(np.prod(spec.shape)) * np.dtype(spec.dtype).itemsize
        return MemoryStats(temp_bytes=int(total), output_bytes=0, argument_bytes=arg,
                           exhausted=True), 0.0
    finally:
        del stack, out
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()


def probe_program(spec: ProgramSpec) -> ProgramAnalysis | None:
    """Measure ``spec`` once (memoized by ``spec.key``; an out-of-memory
    answer is not kept) and return its :class:`ProgramAnalysis`; None off
    the card. The caller drains any work of its own in flight on the card
    first, so that no other program's buffers count."""
    if getattr(spec.device, "type", "cpu") != "cuda":
        return None
    with _memo_lock:
        hit = _memo.get(spec.key)
    if hit is None:
        hit = _measure(spec)
        if not hit[0].exhausted:
            with _memo_lock:
                _memo[spec.key] = hit
    stats, wall = hit
    return ProgramAnalysis(memory=stats, flops=spec.flops,
                           bytes_accessed=spec.bytes_accessed,
                           transcendentals=spec.transcendentals,
                           compile_seconds=wall, stages=spec.stages)


def _spec(bdet, batch: int, stack_dtype, *, with_health: bool = False,
          health_clip: float | None = None) -> ProgramSpec:
    return bdet.program_spec(int(batch), stack_dtype, with_health=with_health,
                             health_clip=health_clip)


def batched_program_memory(bdet, batch: int, stack_dtype, *, with_health: bool = False,
                           health_clip: float | None = None) -> MemoryStats | None:
    """Price the batched detection program of ``bdet`` (any batched
    facade of ``parallel.batch``) at batch size ``batch`` and wire dtype
    ``stack_dtype``: the preflight unit the batched campaign compares
    against its budget. Prices the FULL-CAPACITY (escalation) variant:
    the K0 attempt is smaller, so a fitting full program certifies
    both. None off the card."""
    an = probe_program(_spec(bdet, batch, stack_dtype, with_health=with_health,
                             health_clip=health_clip))
    return an.memory if an is not None else None


def batched_program_analysis(bdet, batch: int, stack_dtype, *, with_health: bool = False,
                             health_clip: float | None = None) -> ProgramAnalysis:
    """:func:`batched_program_memory`'s full-record twin for the cost
    observatory (``telemetry.costs.capture_batched``): the SAME program's
    counts, and its measured memory and cold wall on the card (None and
    0.0 off it)."""
    spec = _spec(bdet, batch, stack_dtype, with_health=with_health, health_clip=health_clip)
    an = probe_program(spec)
    if an is not None:
        return an
    return ProgramAnalysis(memory=None, flops=spec.flops, bytes_accessed=spec.bytes_accessed,
                           transcendentals=spec.transcendentals, compile_seconds=0.0,
                           stages=spec.stages)


def first_fitting(price, candidates, budget_bytes: int):
    """THE preflight fitting policy: walk ``candidates`` in the given
    (ladder) order and return the first whose priced program fits
    ``budget_bytes``. A candidate whose pricing is unsupported (None) is
    treated as fitting — no gate is better than a false one; the
    downshift ladder still protects the run. Returns None when every
    candidate is priced AND over budget. ``price(candidate) ->
    MemoryStats | None``; candidates may be batch sizes or rung tuples."""
    for cand in candidates:
        stats = price(cand)
        if stats is None or stats.fits(budget_bytes):
            return cand
    return None


def max_fitting_batch(price: Callable[[int], MemoryStats | None],
                      candidates: Sequence[int], budget_bytes: int) -> int | None:
    """The largest batch in ``candidates`` whose priced program fits
    ``budget_bytes`` — :func:`first_fitting` over the batch sizes,
    largest first."""
    return first_fitting(price, sorted({int(c) for c in candidates}, reverse=True),
                         budget_bytes)
