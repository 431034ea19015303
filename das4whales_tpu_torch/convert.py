"""State carried across from the JAX package.

Neither detector family has learned weights. The matched filter's state
is its design — the f-k mask, the bandpass gain and the template stack
with its threshold policy. ``design_from_arrays`` builds the port's
``MatchedFilterDesign`` from the JAX design's fields given as numpy
arrays and Python scalars, so both packages can run on one and the same
mask and template stack; ``MatchedFilterDetector.from_design`` then
builds a detector on it (and, as the spectro family's prefilter, the
same design serves that family). The spectro family's own state is its
configuration; its hat kernels are rebuilt from it on the host:
``spectro_from_jax_config``. The batched ingest's configuration — the
data-health thresholds and the shape buckets — is carried as plain
fields (``health_config_from_fields``, ``bucket_config_from_fields``).
Nothing here imports the JAX package: the caller hands over plain arrays
and values.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from .config import BatchBucketConfig, DataHealthConfig
from .models.matched_filter import MatchedFilterDesign
from .models.spectro import SpectroCorrDetector

#: The design fields carried across, by their JAX names.
DESIGN_FIELDS = (
    "fk_mask", "bp_gain", "bp_padlen", "templates", "template_names",
    "trace_shape", "fs", "bp_band", "fk_channels", "threshold_factors",
    "threshold_scope",
)


def design_from_arrays(d: Mapping) -> MatchedFilterDesign:
    """``{field: numpy array or Python scalar}`` for every name in
    :data:`DESIGN_FIELDS` -> the port's ``MatchedFilterDesign``. Arrays are
    copied with their dtypes unchanged, so the result equals the source
    design bit for bit."""
    missing = [f for f in DESIGN_FIELDS if f not in d]
    if missing:
        raise KeyError(f"design fields missing: {missing}")
    return MatchedFilterDesign(
        fk_mask=np.array(d["fk_mask"]),
        bp_gain=np.array(d["bp_gain"]),
        bp_padlen=int(d["bp_padlen"]),
        templates=np.array(d["templates"]),
        template_names=tuple(str(n) for n in d["template_names"]),
        trace_shape=tuple(int(s) for s in d["trace_shape"]),
        fs=float(d["fs"]),
        bp_band=tuple(float(b) for b in d["bp_band"]),
        fk_channels=int(d["fk_channels"]),
        threshold_factors=np.array(d["threshold_factors"]),
        threshold_scope=str(d["threshold_scope"]),
    )


#: The spectro detector's configuration carried across, by its JAX names.
SPECTRO_FIELDS = (
    "flims", "kernels", "win_size", "overlap_pct", "threshold", "max_peaks",
    "batch_channels",
)


def spectro_from_jax_config(det_fields: Mapping, metadata, *, stft_engine: str | None = None,
                            device=None) -> SpectroCorrDetector:
    """``{field: value}`` for every name in :data:`SPECTRO_FIELDS` (read
    off a JAX ``SpectroCorrDetector``) and its metadata -> the port's
    ``SpectroCorrDetector`` with the same configuration. The STFT engine
    is the port's own vocabulary (``ops.spectral.STFT_ENGINES``)."""
    missing = [f for f in SPECTRO_FIELDS if f not in det_fields]
    if missing:
        raise KeyError(f"spectro fields missing: {missing}")
    d = det_fields
    batch = d["batch_channels"]
    return SpectroCorrDetector(
        metadata,
        flims=tuple(float(f) for f in d["flims"]),
        kernels={str(name): {str(k): float(v) for k, v in ker.items()}
                 for name, ker in d["kernels"].items()},
        win_size=float(d["win_size"]),
        overlap_pct=float(d["overlap_pct"]),
        threshold=float(d["threshold"]),
        max_peaks=int(d["max_peaks"]),
        batch_channels=None if batch is None else int(batch),
        stft_engine=stft_engine,
        device=device,
    )


#: ``DataHealthConfig``'s fields carried across, by their JAX names.
HEALTH_FIELDS = ("max_nonfinite", "clip_abs", "max_clip_frac", "max_rms", "min_rms")

#: ``BatchBucketConfig``'s fields carried across, by their JAX names.
BUCKET_FIELDS = ("mode", "lengths", "min_length")


def _missing(d: Mapping, fields: tuple, what: str) -> None:
    missing = [f for f in fields if f not in d]
    if missing:
        raise KeyError(f"{what} fields missing: {missing}")


def _opt_float(v):
    return None if v is None else float(v)


def health_config_from_fields(d: Mapping) -> DataHealthConfig:
    """``{field: value}`` for every name in :data:`HEALTH_FIELDS` (read off
    a JAX ``DataHealthConfig``) -> the port's ``DataHealthConfig``."""
    _missing(d, HEALTH_FIELDS, "health")
    return DataHealthConfig(
        max_nonfinite=int(d["max_nonfinite"]), clip_abs=_opt_float(d["clip_abs"]),
        max_clip_frac=float(d["max_clip_frac"]), max_rms=_opt_float(d["max_rms"]),
        min_rms=_opt_float(d["min_rms"]),
    )


def bucket_config_from_fields(d: Mapping) -> BatchBucketConfig:
    """``{field: value}`` for every name in :data:`BUCKET_FIELDS` (read off
    a JAX ``BatchBucketConfig``) -> the port's ``BatchBucketConfig``."""
    _missing(d, BUCKET_FIELDS, "bucket")
    return BatchBucketConfig(mode=str(d["mode"]), lengths=tuple(int(v) for v in d["lengths"]),
                             min_length=int(d["min_length"]))
