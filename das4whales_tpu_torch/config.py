"""Core types and configuration (the port's copy of ``das4whales_tpu.config``).

Immutable acquisition metadata, the strided channel selection, the f-k
and call-template design parameters, the reference's scientific defaults
and the device-memory budget that routes the detector between its
monolithic and channel-tiled correlate. Values and semantics are those of
the JAX package; only what the matched-filter and spectrogram-correlation
paths need is carried, with the batched ingest's shape buckets
(:class:`BatchBucketConfig`), the data-health quarantine thresholds
(:class:`DataHealthConfig`) and the campaign's env defaults (dispatch
watchdog, dispatch depth, memory preflight).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Mapping


@dataclass(frozen=True)
class AcquisitionMetadata:
    """Immutable DAS acquisition parameters: ``fs`` sampling frequency
    [Hz], ``dx`` channel spacing [m], ``nx`` channels, ``ns`` time
    samples, ``n`` fiber refractive index, ``gauge_length`` [m] and
    ``scale_factor`` converting raw interrogator counts to strain."""

    fs: float
    dx: float
    nx: int
    ns: int
    n: float = 1.4681
    gauge_length: float = 51.0
    scale_factor: float = 1.0
    interrogator: str = "optasense"

    @property
    def duration(self) -> float:
        """File duration in seconds."""
        return self.ns / self.fs

    @property
    def cable_span(self) -> float:
        """Total sensed cable length in meters."""
        return self.nx * self.dx

    def to_dict(self) -> dict:
        """The reference-compatible metadata dict."""
        return {
            "fs": self.fs, "dx": self.dx, "ns": self.ns, "n": self.n,
            "GL": self.gauge_length, "nx": self.nx,
            "scale_factor": self.scale_factor,
        }

    def with_shape(self, nx: int, ns: int) -> "AcquisitionMetadata":
        """Copy with the block shape a strided selection actually produced
        (nx/ns describe the loaded array, not the raw file)."""
        return dataclasses.replace(self, nx=int(nx), ns=int(ns))

    @classmethod
    def from_dict(cls, d: Mapping, interrogator: str = "optasense") -> "AcquisitionMetadata":
        return cls(
            fs=float(d["fs"]), dx=float(d["dx"]), nx=int(d["nx"]),
            ns=int(d["ns"]), n=float(d.get("n", 1.4681)),
            gauge_length=float(d.get("GL", 51.0)),
            scale_factor=float(d.get("scale_factor", 1.0)),
            interrogator=interrogator,
        )


@dataclass(frozen=True)
class ChannelSelection:
    """Strided channel selection ``[start, stop, step]`` in channel indices."""

    start: int
    stop: int
    step: int = 1

    @classmethod
    def from_meters(cls, start_m: float, stop_m: float, step_m: float,
                    dx: float) -> "ChannelSelection":
        """A selection in meters along the cable as channel indices, by
        integer division by ``dx`` (the reference's caller-side idiom,
        ``main_mfdetect.py:30-34``)."""
        if step_m < dx:
            raise ValueError(
                f"step_m={step_m} is below the spatial sampling dx={dx}; the "
                f"integer-divide convention would yield a zero stride. Use "
                f"step_m >= dx (every channel = dx)."
            )
        return cls(int(start_m // dx), int(stop_m // dx), int(step_m // dx))

    @classmethod
    def from_list(cls, sel) -> "ChannelSelection":
        if isinstance(sel, ChannelSelection):
            return sel
        return cls(int(sel[0]), int(sel[1]), int(sel[2]))

    def to_list(self) -> list:
        return [self.start, self.stop, self.step]

    def n_channels(self, nx: int | None = None) -> int:
        stop = self.stop if nx is None else min(self.stop, nx)
        return max(0, -(-(stop - self.start) // self.step))

    @property
    def spacing(self) -> int:
        """Effective inter-channel stride in raw-channel units."""
        return self.step

    def distances(self, dx: float, n: int):
        """Distance axis [m] of the first ``n`` selected channels (the
        reference's axis convention, ``data_handle.py:228``), numpy."""
        import numpy as np

        return (np.arange(n) * self.step + self.start) * dx


@dataclass(frozen=True)
class FkFilterConfig:
    """f-k filter design parameters (speed fan [m/s] and passband [Hz])."""

    cs_min: float = 1400.0
    cp_min: float = 1450.0
    cp_max: float = 3400.0
    cs_max: float = 3500.0
    fmin: float = 15.0
    fmax: float = 25.0


@dataclass(frozen=True)
class CallTemplateConfig:
    """Chirp call-template parameters; ``threshold_factor`` scales this
    template's relative pick threshold."""

    fmin: float
    fmax: float
    duration: float
    window: bool = True
    method: str = "hyperbolic"
    threshold_factor: float = 1.0


#: Canonical working channel selection, meters along the OOI RCA North
#: cable: start, stop, step.
SELECTED_CHANNELS_M = (20000.0, 65000.0, 5.0)

#: Script-level f-k fan + passband of the reference's matched-filter script.
SCRIPT_FK = FkFilterConfig(cs_min=1350.0, cp_min=1450.0, cp_max=3300.0,
                           cs_max=3450.0, fmin=14.0, fmax=30.0)

#: Fin-whale 20-Hz call notes; the HF note picks at 0.9x the threshold.
FIN_HF_NOTE = CallTemplateConfig(fmin=17.8, fmax=28.8, duration=0.68,
                                 threshold_factor=0.9)
FIN_LF_NOTE = CallTemplateConfig(fmin=14.7, fmax=21.8, duration=0.78)

#: Spectrogram-correlation hat kernels (main_spectrodetect.py): the
#: hyperbolic contour from ``f0`` down to ``f1`` [Hz] over ``dur`` [s],
#: hat half-width ``bdwidth`` [Hz].
SPECTRO_HF_KERNEL = {"f0": 27.0, "f1": 17.0, "dur": 0.8, "bdwidth": 4.0}
SPECTRO_LF_KERNEL = {"f0": 20.0, "f1": 14.0, "dur": 1.2, "bdwidth": 4.0}

#: Reference sound speed in sea water [m/s]: the Gabor detector orients its
#: kernel pair along this moveout (main_gabordetect.py).
C0_WATER = 1500.0


def as_metadata(metadata) -> AcquisitionMetadata:
    """Accept an AcquisitionMetadata, a reference-style dict, or any
    object with the same ``to_dict()`` (such as the JAX package's)."""
    if isinstance(metadata, AcquisitionMetadata):
        return metadata
    if hasattr(metadata, "to_dict"):
        return AcquisitionMetadata.from_dict(
            metadata.to_dict(),
            interrogator=getattr(metadata, "interrogator", "optasense"))
    return AcquisitionMetadata.from_dict(metadata)


@dataclass(frozen=True)
class BatchBucketConfig:
    """Time-length padding buckets of the batched ingest
    (``io.stream.stream_batched_slabs``, ``parallel.batch``).

    A batched detector serves ONE ``[B, channel, time]`` shape: its f-k
    mask and template spectra are designed for one record length, and the
    card's FFT plans are cached per shape. Buckets keep the number of
    shapes a mixed campaign needs at O(#buckets): each file's time axis is
    zero-padded up to its bucket's length. ``mode``:

    * ``"exact"`` — no padding; every distinct length is its own bucket
      (right for campaigns whose files all share one length).
    * ``"pow2"`` (default) — pad to the next power of two at or above
      ``min_length``; any mix of record lengths needs at most
      ~log2(longest) shapes.
    * ``"fixed"`` — pad to the smallest entry of ``lengths`` that fits; a
      record longer than every entry raises ``ValueError``.
    """

    mode: str = "pow2"
    lengths: tuple = ()
    min_length: int = 1024

    def __post_init__(self):
        if self.mode not in ("exact", "pow2", "fixed"):
            raise ValueError(
                f"unknown bucket mode {self.mode!r}; expected 'exact', "
                "'pow2' or 'fixed'"
            )
        if self.mode == "fixed" and not self.lengths:
            raise ValueError("mode='fixed' needs explicit bucket lengths")

    def bucket_ns(self, ns: int) -> int:
        """The padded time length serving a record of ``ns`` samples."""
        if ns < 1:
            raise ValueError(f"record length must be >= 1, got {ns}")
        if self.mode == "exact":
            return int(ns)
        if self.mode == "fixed":
            for length in sorted(self.lengths):
                if ns <= int(length):
                    return int(length)
            raise ValueError(
                f"record length {ns} exceeds every fixed bucket "
                f"{tuple(sorted(self.lengths))}"
            )
        return max(int(self.min_length), 1 << max(ns - 1, 0).bit_length())


def as_bucket_config(bucket) -> BatchBucketConfig:
    """Accept a :class:`BatchBucketConfig`, a mode string (``"exact"`` /
    ``"pow2"``), or a sequence of fixed bucket lengths."""
    if isinstance(bucket, BatchBucketConfig):
        return bucket
    if isinstance(bucket, str):
        return BatchBucketConfig(mode=bucket)
    return BatchBucketConfig(
        mode="fixed", lengths=tuple(int(b) for b in bucket)
    )


@dataclass(frozen=True)
class DataHealthConfig:
    """Quarantine thresholds for the data-health stats (``ops.health``,
    computed in the detection program with ``with_health=True``).

    A breaching file is dispositioned ``status="quarantined"`` instead
    of ``done``-with-garbage-picks. Thresholds compare against the stats
    of the block AS THE DETECTOR CONSUMES IT — raw interrogator counts
    on the narrow wire (``clip_abs`` in counts, e.g. 32767 for an int16
    source), strain on the conditioned wire.

    * ``max_nonfinite`` — maximum tolerated non-finite (NaN/Inf) sample
      COUNT; the default 0 quarantines any NaN-poisoned record.
    * ``clip_abs`` — saturation magnitude: samples with ``|x| >=
      clip_abs`` count as clipped (``None`` disables clip accounting).
    * ``max_clip_frac`` — maximum tolerated clipped fraction.
    * ``max_rms`` / ``min_rms`` — RMS sanity window (``None`` disables
      either side); ``min_rms`` catches dead/zeroed records, ``max_rms``
      wild-amplitude ones.
    """

    max_nonfinite: int = 0
    clip_abs: float | None = None
    max_clip_frac: float = 0.25
    max_rms: float | None = None
    min_rms: float | None = None

    @staticmethod
    def _bin_note(stats: Mapping, field: str, worst: str = "max") -> str:
        """Name the offending channel-bin range when the per-channel
        profile (``ops.health.health_profile`` fields in the stats
        dict) is present — quarantine triage on a 22k-channel block
        should say WHERE the fault lives, not just that it exists.
        Returns ``""`` on pre-profile stats dicts (back-compat)."""
        vals = stats.get(field)
        per = stats.get("bin_channels")
        n_ch = stats.get("n_channels")
        if not vals or not per or not n_ch:
            return ""

        def rank(v: float) -> float:
            # a NaN bin value (poisoned span) is the worst offender in
            # either direction: surface it rather than skip it
            if v != v:
                return float("-inf") if worst == "min" else float("inf")
            return v

        idx = range(len(vals))
        j = (min(idx, key=lambda k: rank(vals[k])) if worst == "min"
             else max(idx, key=lambda k: rank(vals[k])))
        lo = j * per
        hi = min((j + 1) * per, n_ch) - 1
        label = field[4:] if field.startswith("bin_") else field
        return (f" (worst channel bin {j}: channels {lo}-{hi}, "
                f"{label} {vals[j]:.4g})")

    def breach(self, stats: Mapping) -> str | None:
        """The first threshold ``stats`` (an ``ops.health`` stats dict)
        breaches, as a human-readable reason — or None when healthy.
        NaN-valued rms (a NaN-poisoned block) reads as unhealthy for any
        configured rms bound. When the stats carry the per-channel-bin
        profile, the reason also names the worst-offending channel-bin
        range (``_bin_note``) so triage can tell a dying fiber span
        from a whole-array fault without replotting."""
        note = lambda field, worst="max": self._bin_note(stats, field, worst)  # noqa: E731
        if stats["nonfinite"] > self.max_nonfinite:
            return (f"nonfinite samples: {stats['nonfinite']} > "
                    f"max_nonfinite={self.max_nonfinite}"
                    + note("bin_nonfinite"))
        if self.clip_abs is not None and stats["clip_frac"] > self.max_clip_frac:
            return (f"clipped fraction {stats['clip_frac']:.4g} > "
                    f"max_clip_frac={self.max_clip_frac} "
                    f"(|x| >= {self.clip_abs:g})" + note("bin_clipped"))
        rms = stats["rms"]
        if self.max_rms is not None and not rms <= self.max_rms:
            return (f"rms {rms:.4g} above max_rms={self.max_rms:g}"
                    + note("bin_rms"))
        if self.min_rms is not None and not rms >= self.min_rms:
            return (f"rms {rms:.4g} below min_rms={self.min_rms:g}"
                    + note("bin_rms", worst="min"))
        return None


def as_health_config(health) -> DataHealthConfig | None:
    """Accept a :class:`DataHealthConfig`, ``True``/``None`` (defaults:
    quarantine on any non-finite sample), or ``False`` (health checks
    off)."""
    if isinstance(health, DataHealthConfig):
        return health
    if health is None or health is True:
        return DataHealthConfig()
    if health is False:
        return None
    raise TypeError(
        f"health must be a DataHealthConfig, bool or None, got {health!r}"
    )


def not_in_slice(what: str, item: str) -> NotImplementedError:
    """The error a setting of a later slice of the port raises: it names
    the ROADMAP item that brings it."""
    return NotImplementedError(
        f"{what} is not in this slice of the port; it comes with the ROADMAP "
        f"item '{item}' (ROADMAP.md, 'Open items', 1)"
    )


#: Default device-memory budget [GiB] for the detector's monolithic vs
#: channel-tiled routing when ``DAS_HBM_BUDGET_GB`` is unset — the JAX
#: package's value, so both packages route a shape the same way.
DEFAULT_HBM_BUDGET_GB = 8.0


def hbm_budget_bytes() -> int:
    """The device-memory budget in bytes (``DAS_HBM_BUDGET_GB`` env, or
    :data:`DEFAULT_HBM_BUDGET_GB`)."""
    return int(
        float(os.environ.get("DAS_HBM_BUDGET_GB", DEFAULT_HBM_BUDGET_GB))
        * 2**30
    )


def template_bank_default() -> str:
    """The template bank a detector builds when the caller passes
    ``templates=None``: ``DAS_TEMPLATE_BANK`` (a registered bank name or a
    chirp-grid spec, ``models.templates.resolve_bank``), ``"fin"`` when
    unset or empty."""
    return os.environ.get("DAS_TEMPLATE_BANK", "") or "fin"


def memory_preflight_default() -> bool:
    """Whether batched campaigns run the memory preflight when the caller
    passes ``preflight=None`` (``DAS_MEMORY_PREFLIGHT`` env; default
    off). The preflight itself is not in this slice: a campaign that
    resolves it on raises, naming its ROADMAP item."""
    return os.environ.get("DAS_MEMORY_PREFLIGHT", "0") not in ("0", "", "false")


def dispatch_deadline_default() -> float | None:
    """Default campaign dispatch-watchdog deadline in seconds
    (``DAS_DISPATCH_DEADLINE_S`` env; unset/empty = no watchdog). The
    watchdog bounds how long a campaign waits on any ONE device dispatch
    (program launch + packed fetch): a wedged CUDA runtime becomes
    ``status="timeout"`` instead of a stalled run
    (``faults.call_with_deadline``)."""
    raw = os.environ.get("DAS_DISPATCH_DEADLINE_S", "")
    return float(raw) if raw else None


def mf_engine_default() -> str:
    """The matched-filter correlate engine a detector takes when the
    caller passes ``mf_engine=None``: ``DAS_MF_ENGINE`` (``"fft"``,
    ``"matmul"``, ``"matmul-bf16"``, ``"matmul-fused"`` or ``"auto"``),
    ``"fft"`` when unset or empty. The JAX package reads an unset
    variable as ``"auto"``, which off a TPU is its FFT route; here
    ``"auto"`` runs the calibrated router (``ops.mxu``) only when asked
    for."""
    return os.environ.get("DAS_MF_ENGINE", "") or "fft"


def fk_engine_default() -> str:
    """The f-k apply engine a detector takes when the caller passes
    ``fk_engine=None``: ``DAS_FK_ENGINE`` (``"fft"``, ``"matmul"`` or
    ``"auto"``), ``"fft"`` when unset or empty."""
    return os.environ.get("DAS_FK_ENGINE", "") or "fft"


#: Channel-count ceiling of the ``auto``-routed DFT-matmul f-k apply: the
#: ``[C, C]`` matrix pair takes 2 C^2 float32 bytes (128 MiB at 4096).
DEFAULT_FK_MATMUL_MAX_CHANNELS = 4096


def fk_matmul_max_channels() -> int:
    """Above this channel count ``fk_engine="auto"`` keeps the FFT route
    (``DAS_FK_MATMUL_MAX_CHANNELS`` env; default
    :data:`DEFAULT_FK_MATMUL_MAX_CHANNELS`); a forced ``"matmul"``
    overrides it."""
    raw = os.environ.get("DAS_FK_MATMUL_MAX_CHANNELS", "")
    try:
        return int(raw) if raw else DEFAULT_FK_MATMUL_MAX_CHANNELS
    except ValueError:
        return DEFAULT_FK_MATMUL_MAX_CHANNELS


def calibration_cache_path() -> str:
    """Where the engine routers' calibration table lives
    (``ops.mxu.CalibrationTable``): ``DAS_CALIBRATION_CACHE``, else
    ``~/.cache/das4whales_tpu_torch/mxu_calibration.json``."""
    return os.environ.get("DAS_CALIBRATION_CACHE") or os.path.expanduser(
        os.path.join("~", ".cache", "das4whales_tpu_torch", "mxu_calibration.json")
    )


#: Default depth of the campaign's software-pipelined dispatch queue.
DEFAULT_DISPATCH_DEPTH = 2


def dispatch_depth_default() -> int:
    """Depth D of the campaigns' software-pipelined dispatch queue
    (``DAS_DISPATCH_DEPTH`` env; default :data:`DEFAULT_DISPATCH_DEPTH`).
    Depth D keeps up to D slabs'/files' detection programs IN FLIGHT
    (queued on the card, packed fetch not yet taken), so H2D, compute and
    the packed fetch of different slabs overlap instead of serializing
    on a per-slab sync (``parallel.dispatch``). ``<= 1`` disables
    pipelining: the synchronous dispatch-then-fetch behavior."""
    raw = os.environ.get("DAS_DISPATCH_DEPTH", "")
    try:
        return int(raw) if raw else DEFAULT_DISPATCH_DEPTH
    except ValueError:
        return DEFAULT_DISPATCH_DEPTH
