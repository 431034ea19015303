"""Core types and configuration (the port's copy of ``das4whales_tpu.config``).

Immutable acquisition metadata, the strided channel selection, the f-k
and call-template design parameters, the reference's scientific defaults
and the device-memory budget that routes the detector between its
monolithic and channel-tiled correlate. Values and semantics are those of
the JAX package; only what the matched-filter and spectrogram-correlation
paths need is carried.
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
    def from_list(cls, sel) -> "ChannelSelection":
        if isinstance(sel, ChannelSelection):
            return sel
        return cls(int(sel[0]), int(sel[1]), int(sel[2]))

    def to_list(self) -> list:
        return [self.start, self.stop, self.step]

    def n_channels(self, nx: int | None = None) -> int:
        stop = self.stop if nx is None else min(self.stop, nx)
        return max(0, -(-(stop - self.start) // self.step))


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
