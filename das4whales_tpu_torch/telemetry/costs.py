"""Per-program cost cards: the cost observatory (the port's counterpart
of ``das4whales_tpu.telemetry.costs``).

At the preflight's pricing boundary (``utils.memory``) each priced
program yields a :class:`CostCard`: its operations and bytes COUNTED
stage by stage from its shapes (``ProgramSpec``; eager PyTorch has no
compiler to count them, so every card says ``"source": "counted"``),
its measured memory peak on the card, and ``compile_seconds`` — in
eager PyTorch nothing compiles, so the key carries the wall of the
program's cold first run (cuFFT plans, module loads), into
``das_compile_seconds{program}`` / ``das_compiles_total``. At run time
every resolved slab divides the card's roofline wall at the device's
peaks by the measured wall into ``das_roofline_frac{stage,engine}``;
``sample_hbm`` reads ``torch.cuda.memory_allocated`` and the card's
memory into ``das_hbm_bytes_in_use`` / ``das_hbm_bytes_limit``, and
``das_preflight_pricing_error_ratio`` compares the occupancy after a
resolve with the priced footprint.

:class:`DevicePeaks` are keyed on the card's name
(``torch.cuda.get_device_name``); only cards in :data:`KNOWN_PEAKS`
have peaks, and a card without them gets no roofline share. The
program-contract audit of the JAX package's cards reads jaxpr and HLO;
the port has neither, so every card's ``contract`` is ``"unchecked"``.

Disabled (the default — ``DAS_COST_CARDS`` / :func:`enable` /
``run_campaign_batched(cost_cards=True)``), every hook is one module
attribute check. Pure stdlib at import.
"""

from __future__ import annotations

import math
import os
import threading
from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

from . import metrics

__all__ = [
    "CostCard", "DevicePeaks", "KNOWN_PEAKS", "REGISTRY", "bucket_label",
    "capture_batched", "cards_payload", "correlate_stage", "device_name", "device_peaks",
    "disable", "enable", "enabled", "ensure_batched_card", "export_json", "fk_stage",
    "note_slab_resolved", "reset", "resolve_enabled", "rfft_ops", "sample_hbm",
]


# ---------------------------------------------------------------------------
# Counted stages of the matched filter, engine by engine
# ---------------------------------------------------------------------------


def rfft_ops(n: int) -> float:
    """Operations of one real FFT of length ``n``: 2.5 n log2 n (half a
    complex one's 5 n log2 n)."""
    return 2.5 * n * math.log2(max(n, 2))


def fk_stage(engine: str, B: int, C: int, T: int, Cf: int, Fb: int) -> tuple:
    """The f-k filter's ``(name, operations, bytes, transcendentals)`` row
    for ``B`` files of ``[C, T]`` on an f-k grid of ``Cf`` channels and
    ``Fb`` in-band rfft bins. Both engines take the rfft in time and its
    inverse; ``"fft"`` then the banded channel FFT pair and the mask,
    ``"matmul"`` eight real ``[Cf, Cf] @ [Cf, Fb]`` products and the mask,
    reading the two ``[Cf, Cf]`` DFT matrices once."""
    time_ops = 2 * B * rfft_ops(T) * C
    block = B * 2 * C * T * 4
    if engine == "matmul":
        return ("fk", time_ops + 8 * 2.0 * Cf * Cf * Fb * B + 2.0 * B * Cf * Fb,
                block + 2 * Cf * Cf * 4 + 2 * B * Cf * Fb * 8 + Cf * Fb * 4, 0.0)
    return ("fk", time_ops + 2 * B * Fb * 2 * rfft_ops(Cf) + 6.0 * B * Cf * Fb,
            block + 2 * B * Cf * Fb * 8 + Cf * Fb * 4, 0.0)


def correlate_stage(engine: str, rows: int, nT: int, T: int, m: int, n_corr: int,
                    fir_half: int = 0) -> tuple:
    """The correlate's ``(name, operations, bytes, transcendentals)`` row
    for ``rows`` channels of ``T`` samples against ``nT`` templates of
    ``m`` taps. ``"fft"``: one forward FFT of length ``n_corr`` a channel,
    ``nT`` products and inverse FFTs. The matmul engines: the Toeplitz
    contraction's ``2 rows T m nT`` operations (``"matmul-bf16"`` counts
    the same; only its inputs round); ``"matmul-fused"``: ``nT + 1`` rows
    of ``m + 2L`` taps over ``T + m - 1`` lags (the bandpassed block and
    its ring-down ride the same contraction). Each input read once, each
    correlogram written once."""
    out_b = nT * rows * T * 4
    if engine in ("matmul", "matmul-bf16"):
        return ("correlate", 2.0 * rows * T * m * nT + 6.0 * rows * T * nT,
                rows * T * 4 + nT * m * 4 + out_b, 0.0)
    if engine == "matmul-fused":
        P = m + 2 * int(fir_half)
        return ("correlate", 2.0 * rows * (T + m - 1) * P * (nT + 1) + 8.0 * rows * T * nT,
                rows * T * 4 + (nT + 1) * P * 4 + out_b, 0.0)
    return ("correlate", rows * rfft_ops(n_corr) + nT * rows * (6.0 * (n_corr // 2 + 1)
                                                               + rfft_ops(n_corr)),
            rows * T * 4 + nT * (n_corr // 2 + 1) * 8 + out_b, 0.0)


@dataclass(frozen=True)
class DevicePeaks:
    """One device's roofline denominators; None where not known."""

    name: str
    flops: Optional[float]        # float32 operations/s (CUDA cores)
    bf16_flops: Optional[float]   # dense bf16 tensor-core operations/s
    hbm_bps: Optional[float]      # memory bandwidth, bytes/s
    source: str = ""

    @property
    def known(self) -> bool:
        return bool(self.flops and self.hbm_bps)

    def as_dict(self) -> Dict:
        return {"name": self.name, "flops": self.flops, "bf16_flops": self.bf16_flops,
                "hbm_bps": self.hbm_bps, "source": self.source}


#: Published peaks by card name, from NVIDIA's H100 Tensor Core GPU data
#: sheet (SXM5 column): FP32 67 TFLOPS, BF16 tensor 1979 TFLOPS with
#: sparsity (989.5 dense), HBM3 3.35 TB/s.
KNOWN_PEAKS: Dict[str, DevicePeaks] = {
    "NVIDIA H100 80GB HBM3": DevicePeaks(
        "NVIDIA H100 80GB HBM3", flops=67e12, bf16_flops=989.5e12, hbm_bps=3.35e12,
        source="NVIDIA H100 Tensor Core GPU data sheet, H100 SXM5"),
}

_h_compile = metrics.histogram(
    "das_compile_seconds",
    "wall seconds of each priced program's cold first run (eager PyTorch "
    "compiles nothing: cuFFT plans and module loads), by program (rung label)",
    ("program",),
    buckets=(0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 10.0, 30.0, 60.0, 300.0),
)
_c_compiles = metrics.counter(
    "das_compiles_total",
    "programs priced by the cost observatory, by program",
    ("program",),
)
_g_roofline = metrics.gauge(
    "das_roofline_frac",
    "live fraction of roofline per resolved slab: cost-card roofline wall "
    "at the device's peaks / measured wall (1.0 = at the bound), by rung "
    "stage and engine",
    ("stage", "engine"),
)
_g_hbm_used = metrics.gauge(
    "das_hbm_bytes_in_use",
    "device bytes allocated (torch.cuda.memory_allocated) sampled after "
    "slab resolves",
)
_g_hbm_limit = metrics.gauge(
    "das_hbm_bytes_limit",
    "the device's total memory (the denominator of live occupancy)",
)
_g_pricing = metrics.gauge(
    "das_preflight_pricing_error_ratio",
    "device bytes allocated after a resolve / the resolved program's "
    "priced footprint (peak + arguments): >1 means the preflight "
    "underpriced the program",
)


def _env_truthy(name: str) -> bool:
    return os.environ.get(name, "") not in ("", "0", "false")


_enabled = _env_truthy("DAS_COST_CARDS")


def enabled() -> bool:
    """Is cost-card capture on (``DAS_COST_CARDS`` / :func:`enable`)?"""
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def resolve_enabled(flag: bool | None) -> bool:
    """Per-campaign resolution: None defers to the process switch."""
    return _enabled if flag is None else bool(flag)


# ---------------------------------------------------------------------------
# Device peaks
# ---------------------------------------------------------------------------


def device_name(device=None) -> str:
    """The name cards and peaks are keyed on: the card's
    ``torch.cuda.get_device_name`` for a CUDA device (None: the current
    card), ``"cpu"`` for the CPU."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name(dev)


def device_peaks(device=None) -> DevicePeaks:
    """The peaks of ``device``'s card (:data:`KNOWN_PEAKS`), or a record
    with no peaks for any other device, the CPU included."""
    name = device_name(device)
    return KNOWN_PEAKS.get(name, DevicePeaks(name, None, None, None))


# ---------------------------------------------------------------------------
# Cost cards
# ---------------------------------------------------------------------------


def bucket_label(key) -> str:
    """ONE spelling of a campaign bucket key for card lookup: the
    ``(channels, bucket_ns, dtype)`` tuple as ``"CxN/dtype"``."""
    try:
        c, n, dt = key
        return f"{c}x{n}/{dt}"
    except (TypeError, ValueError):
        return str(key)


@dataclass(frozen=True)
class CostCard:
    """One priced program's cost, keyed ``(bucket, program, engine)``
    where ``program`` is the ladder's rung label (``"batched:4"``,
    ``"bank:2"``, ``"tiled"``). ``flops``/``bytes_accessed`` are counted
    over ``stages``; ``peak_bytes``/``argument_bytes`` measured on
    ``device`` (0 where no probe ran, the CPU)."""

    program: str
    bucket: str
    engine: str
    batch: int
    templates: int
    flops: float
    bytes_accessed: float
    transcendentals: float
    peak_bytes: int
    argument_bytes: int
    compile_seconds: float
    device: str = "cpu"
    stages: Tuple[str, ...] = ()
    source: str = "counted"
    contract: str = "unchecked"
    contract_findings: Tuple[str, ...] = ()

    @property
    def key(self) -> Tuple[str, str, str]:
        return (self.bucket, self.program, self.engine)

    def predicted_wall_s(self, peaks: DevicePeaks | None = None) -> Optional[float]:
        """Roofline lower-bound wall at ``peaks`` (default: the card's
        own): the larger of the counted operations over the float32 rate
        and the counted bytes over the memory rate. None without peaks."""
        peaks = peaks or KNOWN_PEAKS.get(self.device)
        if peaks is None or not peaks.known:
            return None
        return max(self.flops / peaks.flops, self.bytes_accessed / peaks.hbm_bps)

    def as_dict(self) -> Dict:
        peaks = KNOWN_PEAKS.get(self.device)
        return {
            "program": self.program, "bucket": self.bucket, "engine": self.engine,
            "batch": self.batch, "templates": self.templates, "flops": self.flops,
            "bytes_accessed": self.bytes_accessed, "transcendentals": self.transcendentals,
            "peak_bytes": self.peak_bytes, "argument_bytes": self.argument_bytes,
            "compile_seconds": round(self.compile_seconds, 4), "device": self.device,
            "stages": list(self.stages), "source": self.source, "contract": self.contract,
            "contract_findings": list(self.contract_findings),
            "predicted_wall_s": self.predicted_wall_s(peaks),
            "intensity_flops_per_byte": (self.flops / self.bytes_accessed
                                         if self.bytes_accessed else None),
        }


class CostCardRegistry:
    """Process-wide ``(bucket, program, engine) -> CostCard``; every
    access goes through the lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cards: Dict[Tuple[str, str, str], CostCard] = {}

    def record(self, card: CostCard) -> None:
        with self._lock:
            self._cards[card.key] = card

    def get(self, bucket: str, program: str, engine: str) -> Optional[CostCard]:
        with self._lock:
            return self._cards.get((str(bucket), str(program), str(engine)))

    def cards(self) -> List[CostCard]:
        with self._lock:
            return list(self._cards.values())

    def reset(self) -> None:
        with self._lock:
            self._cards.clear()


#: The process-wide card registry.
REGISTRY = CostCardRegistry()


def _program_engine(bdet) -> str:
    """The engine label a batched program's cards are keyed by: a family
    facade's resolved ``engine``, or the matched filter's correlate
    engine."""
    eng = getattr(bdet, "engine", None)
    if not eng:
        eng = getattr(bdet.det, "mf_engine", "fft")
    return str(eng or "fft")


def _template_count(det) -> int:
    """Templates/kernels/notes the program sweeps (1 for the learned
    family's single classifier head)."""
    design = getattr(det, "design", None)
    if design is not None and hasattr(design, "templates"):
        return int(design.templates.shape[0])
    cfgs = getattr(det, "template_configs", None)
    return int(len(cfgs)) if cfgs else 1


def _facade_device(bdet):
    det = bdet.det
    dev = getattr(det, "device", None)
    if dev is None:
        dev = getattr(getattr(det, "det", None), "device", None)
    return dev


def capture_batched(bdet, batch: int, stack_dtype, *, bucket: str, program: str,
                    with_health: bool = False, health_clip=None):
    """Price the batched program (``utils.memory.batched_program_analysis``)
    and register its :class:`CostCard`. Returns the program's
    ``MemoryStats`` (None off the card) so the memory preflight takes
    this as a drop-in for ``batched_program_memory``: one probe serves
    the admission decision and the card."""
    from ..utils import memory as memutils

    an = memutils.batched_program_analysis(bdet, batch, stack_dtype, with_health=with_health,
                                           health_clip=health_clip)
    _c_compiles.inc(program=program)
    _h_compile.observe(an.compile_seconds, program=program)
    REGISTRY.record(CostCard(
        program=str(program), bucket=str(bucket), engine=_program_engine(bdet),
        batch=int(batch), templates=_template_count(bdet.det),
        flops=an.flops, bytes_accessed=an.bytes_accessed,
        transcendentals=an.transcendentals,
        peak_bytes=int(an.memory.peak if an.memory else 0),
        argument_bytes=int(an.memory.argument_bytes if an.memory else 0),
        compile_seconds=an.compile_seconds, device=device_name(_facade_device(bdet)),
        stages=tuple(an.stages),
    ))
    return an.memory


#: rung labels whose program is another rung's (the "file" rung runs the
#: B=1 batched program): the existing card is registered again under the
#: new label instead of probing twice
_RUNG_ALIASES = {"file": "batched:1"}


def ensure_batched_card(bdet, batch: int, stack_dtype, *, bucket: str, program: str,
                        with_health: bool = False, health_clip=None) -> None:
    """Capture a card only when its key is absent (the campaign's starting
    rung, once a bucket; the preflight already captured every rung it
    priced). A rung whose program is an alias of an already-carded one
    clones that card under its own label."""
    engine = _program_engine(bdet)
    if REGISTRY.get(bucket, program, engine) is not None:
        return
    alias = _RUNG_ALIASES.get(str(program))
    if alias is not None:
        src = REGISTRY.get(bucket, alias, engine)
        if src is not None:
            REGISTRY.record(replace(src, program=str(program)))
            return
    capture_batched(bdet, batch, stack_dtype, bucket=bucket, program=program,
                    with_health=with_health, health_clip=health_clip)


# ---------------------------------------------------------------------------
# Run-time surfaces
# ---------------------------------------------------------------------------


def sample_hbm(device=None, force: bool = False) -> Optional[Dict[str, int]]:
    """The card's allocated bytes and total memory into the
    ``das_hbm_bytes_in_use`` / ``das_hbm_bytes_limit`` gauges. None when
    capture is disabled (``force=True`` bypasses the process switch) or
    ``device`` is not a card."""
    import torch

    if not _enabled and not force:
        return None
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    in_use = int(torch.cuda.memory_allocated(dev))
    limit = int(torch.cuda.get_device_properties(dev).total_memory)
    _g_hbm_used.set(in_use)
    _g_hbm_limit.set(limit)
    return {"bytes_in_use": in_use, "bytes_limit": limit}


def note_slab_resolved(bucket: str, rung_label: str, engine: str, wall_s: float,
                       device=None) -> Optional[float]:
    """One resolved slab's live utilization: the matching card's roofline
    wall over the measured wall, into ``das_roofline_frac{stage=rung,
    engine}``; the post-resolve memory sample feeds
    ``das_preflight_pricing_error_ratio``. No card, or a device without
    peaks: no gauge, returns None. The CALLER owns the enabled gate."""
    if wall_s <= 0:
        return None
    card = REGISTRY.get(bucket, rung_label, str(engine or "fft"))
    if card is None:
        return None
    sample = sample_hbm(device, force=True)
    if sample and card.peak_bytes:
        _g_pricing.set(round(sample["bytes_in_use"] / (card.peak_bytes + card.argument_bytes),
                             4))
    predicted = card.predicted_wall_s()
    if predicted is None:
        return None
    frac = predicted / wall_s
    _g_roofline.set(round(frac, 6), stage=rung_label, engine=card.engine)
    return frac


# ---------------------------------------------------------------------------
# Export
# ---------------------------------------------------------------------------


def cards_payload() -> Dict:
    """JSON-safe dump of every card with the peaks of the devices they
    were priced on."""
    cards = REGISTRY.cards()
    names = sorted({c.device for c in cards})
    return {
        "devices": {n: KNOWN_PEAKS.get(n, DevicePeaks(n, None, None, None)).as_dict()
                    for n in names},
        "cards": [c.as_dict() for c in cards],
    }


def export_json(path: str, extra: Dict | None = None) -> str:
    """Write the card registry (plus ``extra`` fields) as JSON next to the
    manifest; returns ``path``."""
    # local import: keeps telemetry free of utils at import time
    from ..utils import artifacts

    payload = cards_payload()
    if extra:
        payload.update(extra)
    return artifacts.atomic_json(path, payload, indent=1)


def reset() -> None:
    """Clear every card (tests)."""
    REGISTRY.reset()
