"""Synthetic DAS scenes: background noise plus fin-whale-style chirps
arriving across the array at a chosen speed (the port's copy of
``das4whales_tpu.io.synth``; same seed, same block)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from ..config import AcquisitionMetadata

#: OptaSense interferometric conversion constants: 1550.12 nm laser,
#: 0.78 photoelastic scaling.
_LASER_WAVELENGTH_M = 1550.12e-9
_PHOTOELASTIC = 0.78


def __getattr__(name):
    # the JAX module's ``write_optasense``: io.hdf5 imports this module, so
    # it is looked up on first access, not imported here
    if name == "write_optasense":
        from .hdf5 import write_optasense

        return write_optasense
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def optasense_scale_factor(n: float, gauge_length: float) -> float:
    """Raw counts -> strain conversion of an OptaSense interrogator."""
    return (2 * np.pi) / 2**16 * _LASER_WAVELENGTH_M / (_PHOTOELASTIC * 4 * np.pi * n * gauge_length)


@dataclass
class SyntheticCall:
    """One injected call: source at ``(x0_m, y0_m, z0_m)`` in cable
    coordinates (cable along x), emitting at ``t0`` [s]; arrivals reach
    each channel at ``speed`` [m/s] over the 3-D slant range."""

    t0: float
    x0_m: float
    fmin: float = 17.8
    fmax: float = 28.8
    duration: float = 0.68
    amplitude: float = 1.0
    speed: float = 1500.0
    y0_m: float = 0.0
    z0_m: float = 0.0


@dataclass
class SyntheticScene:
    fs: float = 200.0
    dx: float = 2.042
    nx: int = 512
    ns: int = 12000
    gauge_length: float = 51.05
    n: float = 1.4681
    noise_rms: float = 0.05
    calls: Sequence[SyntheticCall] = field(default_factory=list)
    seed: int = 0

    @property
    def metadata(self) -> AcquisitionMetadata:
        return AcquisitionMetadata(
            fs=self.fs, dx=self.dx, nx=self.nx, ns=self.ns, n=self.n,
            gauge_length=self.gauge_length,
            scale_factor=optasense_scale_factor(self.n, self.gauge_length),
            interrogator="optasense",
        )


def _hyperbolic_chirp(fmin, fmax, duration, fs):
    t = np.arange(0, duration, 1 / fs)
    f0, f1, t1 = fmax, fmin, duration
    sing = -f1 * t1 / (f0 - f1)
    y = np.cos(2 * np.pi * (-sing * f0) * np.log(np.abs(1 - t / sing)))
    return y * np.hanning(len(y))


def call_onsets(scene: SyntheticScene, call: SyntheticCall) -> np.ndarray:
    """Per-channel onset sample of ``call`` (the arrival the scene renders)."""
    x = np.arange(scene.nx) * scene.dx
    slant = np.sqrt((x - call.x0_m) ** 2 + call.y0_m ** 2 + call.z0_m ** 2)
    return np.round((call.t0 + slant / call.speed) * scene.fs).astype(int)


def synthesize_scene(scene: SyntheticScene) -> np.ndarray:
    """Render the scene as a float ``[channel x time]`` amplitude block
    (unit scale; convert to raw counts with ``to_raw_counts``)."""
    rng = np.random.default_rng(scene.seed)
    data = scene.noise_rms * rng.standard_normal((scene.nx, scene.ns))
    for call in scene.calls:
        chirp = _hyperbolic_chirp(call.fmin, call.fmax, call.duration, scene.fs) * call.amplitude
        onsets = call_onsets(scene, call)
        L = len(chirp)
        for ch in range(scene.nx):
            s = onsets[ch]
            if 0 <= s and s + L <= scene.ns:
                data[ch, s : s + L] += chirp
    return data


def to_raw_counts(amplitude_block: np.ndarray, metadata: AcquisitionMetadata, counts_scale: float = 1000.0) -> np.ndarray:
    """Quantize a unit-scale amplitude block to int32 raw counts such that
    demean + ``metadata.scale_factor`` recovers the strain block."""
    return np.round(amplitude_block * counts_scale).astype(np.int32)


def write_synthetic_file(filepath: str, scene: SyntheticScene, counts_scale: float = 1000.0) -> str:
    """Render a scene and write it through the OptaSense-schema HDF5 writer."""
    from .hdf5 import write_optasense

    block = synthesize_scene(scene)
    raw = to_raw_counts(block, scene.metadata, counts_scale)
    return write_optasense(
        filepath, raw, fs=scene.fs, dx=scene.dx,
        gauge_length=scene.gauge_length, n=scene.n,
    )


def write_synthetic_tdms(filepath: str, scene: SyntheticScene, counts_scale: float = 1000.0) -> str:
    """Render a scene through the Silixa-schema TDMS writer (int16 channel
    data, the property set ``get_metadata_silixa`` reads, and a
    ``GPSTimeStamp``): the offline fixture of the TDMS ingest path."""
    from datetime import datetime

    from .tdms import write_tdms

    block = synthesize_scene(scene)
    raw = np.round(block * counts_scale).astype(np.int16)
    props = {
        "SamplingFrequency[Hz]": float(scene.fs),
        "SpatialResolution[m]": float(scene.dx),
        "FibreIndex": float(scene.n),
        "GaugeLength": float(scene.gauge_length),
        "GPSTimeStamp": datetime(2021, 11, 4, 1, 59, 2),
    }
    # zero-padded names keep natural == lexicographic order; the loader's
    # numeric-aware sort must not depend on that
    chans = {f"ch{i:05d}": raw[i] for i in range(scene.nx)}
    return write_tdms(filepath, props, "Measurement", chans)
