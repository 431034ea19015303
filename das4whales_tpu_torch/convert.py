"""State carried across from the JAX package.

The matched filter's state
is its design — the f-k mask, the bandpass gain and the template stack
with its threshold policy. ``design_from_arrays`` builds the port's
``MatchedFilterDesign`` from the JAX design's fields given as numpy
arrays and Python scalars, so both packages can run on one and the same
mask and template stack; ``MatchedFilterDetector.from_design`` then
builds a detector on it (and, as the spectro family's prefilter, the
same design serves that family). The spectro family's own state is its
configuration; its hat kernels are rebuilt from it on the host:
``spectro_from_jax_config``. The Gabor family's state is its
``GaborDesign`` (the oriented kernel pair, its angle, the bin factor and
the two thresholds) and its call notes: ``gabor_design_from_arrays`` and
``gabor_detector_from_jax`` carry them across, and
``gabor_design_to_arrays`` / ``gabor_detector_to_arrays`` give them back
as the fields JAX's ``GaborDesign`` takes. The learned family's state is
its trained weights: ``learned_params_from_arrays`` builds the port's
``LearnedCNN`` from JAX's parameter pytree given as numpy arrays
(convolution weights HWIO there, OIHW here), and
``learned_params_to_arrays`` gives the pytree back. The batched ingest's
configuration — the data-health thresholds and the shape buckets — is
carried as plain fields (``health_config_from_fields``,
``bucket_config_from_fields``).
Nothing here imports the JAX package: the caller hands over plain arrays
and values.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .config import BatchBucketConfig, DataHealthConfig
from .models.gabor import GaborDesign, GaborDetector
from .models.learned import LearnedCNN
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


#: The Gabor design's fields carried across, by their JAX names.
GABOR_DESIGN_FIELDS = ("gabor_up", "gabor_down", "theta_c0", "bin_factor", "threshold1",
                       "threshold2")

#: The Gabor detector's own fields besides its design: ``note_params``
#: ``{name: (fmin, fmax, duration)}``, ``notes`` ``{name: samples}`` and
#: ``max_peaks``.
GABOR_DETECTOR_FIELDS = ("note_params", "notes", "max_peaks")


def gabor_design_from_arrays(d: Mapping) -> GaborDesign:
    """``{field: numpy array or Python scalar}`` for every name in
    :data:`GABOR_DESIGN_FIELDS` -> the port's ``GaborDesign``; the kernel
    pair is copied with its dtype unchanged, bit for bit."""
    _missing(d, GABOR_DESIGN_FIELDS, "gabor design")
    return GaborDesign(
        gabor_up=np.array(d["gabor_up"]), gabor_down=np.array(d["gabor_down"]),
        theta_c0=float(d["theta_c0"]), bin_factor=float(d["bin_factor"]),
        threshold1=float(d["threshold1"]), threshold2=float(d["threshold2"]),
    )


def gabor_design_to_arrays(design) -> dict:
    """A Gabor design (either package's) -> ``{field: numpy array or
    Python scalar}``: ``GaborDesign(**fields)`` of either package rebuilds
    it."""
    out = {f: getattr(design, f) for f in GABOR_DESIGN_FIELDS}
    out["gabor_up"], out["gabor_down"] = np.array(out["gabor_up"]), np.array(out["gabor_down"])
    return {k: (v if isinstance(v, np.ndarray) else float(v)) for k, v in out.items()}


def gabor_detector_from_jax(fields: Mapping, metadata, *, gabor_engine: str | None = None,
                            device=None) -> GaborDetector:
    """``{field: value}`` for every name in :data:`GABOR_DESIGN_FIELDS` and
    :data:`GABOR_DETECTOR_FIELDS` (read off a JAX ``GaborDetector``: its
    design's fields, ``note_params``, ``notes`` as numpy and
    ``max_peaks``) and its metadata -> the port's ``GaborDetector`` on the
    same design and the same note samples."""
    _missing(fields, GABOR_DESIGN_FIELDS + GABOR_DETECTOR_FIELDS, "gabor detector")
    params = {str(n): tuple(float(v) for v in p) for n, p in fields["note_params"].items()}
    return GaborDetector(
        metadata, None, notes=params, max_peaks=int(fields["max_peaks"]),
        gabor_engine=gabor_engine, device=device,
        design=gabor_design_from_arrays(fields),
        note_arrays={str(n): np.array(a, np.float32) for n, a in fields["notes"].items()},
    )


def gabor_detector_to_arrays(det) -> dict:
    """A Gabor detector (either package's) -> the fields
    :func:`gabor_detector_from_jax` takes, as numpy and Python values."""
    out = gabor_design_to_arrays(det.design)
    out["note_params"] = {n: tuple(float(v) for v in p) for n, p in det.note_params.items()}
    out["notes"] = {n: np.array(a.cpu() if isinstance(a, torch.Tensor) else a, np.float32)
                    for n, a in det.notes.items()}
    out["max_peaks"] = int(det.max_peaks)
    return out


def learned_params_from_arrays(params: Mapping, cfg_fields: Mapping) -> LearnedCNN:
    """JAX's learned parameter pytree ``{"conv0": {"w": [3, 3, I, O], "b":
    [O]}, ..., "head": {"w": [C], "b": ()}}`` (numpy or any array type)
    and the configuration's fields (``features`` is read) -> the port's
    :class:`LearnedCNN` on the CPU, every value float32 and bitwise the
    source's (weights permuted HWIO -> OIHW)."""
    _missing(cfg_fields, ("features",), "learned config")
    features = tuple(int(f) for f in cfg_fields["features"])
    want = [f"conv{i}" for i in range(len(features))] + ["head"]
    if sorted(params) != sorted(want):
        raise KeyError(f"learned parameters {sorted(params)} != {sorted(want)} for features "
                       f"{features}")
    model = LearnedCNN(features)

    def f32(v):
        return torch.from_numpy(np.array(v, np.float32))

    with torch.no_grad():
        for i, conv in enumerate(model.convs):
            w = f32(params[f"conv{i}"]["w"]).permute(3, 2, 0, 1)
            if tuple(w.shape) != tuple(conv.weight.shape):
                raise ValueError(f"conv{i}.w has shape {tuple(w.shape)} (OIHW), expected "
                                 f"{tuple(conv.weight.shape)}")
            conv.weight.copy_(w)
            conv.bias.copy_(f32(params[f"conv{i}"]["b"]))
        model.head_w.copy_(f32(params["head"]["w"]))
        model.head_b.copy_(f32(params["head"]["b"]).reshape(()))
    return model


def learned_params_to_arrays(model: LearnedCNN) -> dict:
    """A :class:`LearnedCNN` -> JAX's parameter pytree as numpy float32
    (weights HWIO, ``head.b`` 0-d): ``save_params`` of either package
    writes it, and JAX's ``cnn_logits`` takes it as is."""
    out = {}
    for i, conv in enumerate(model.convs):
        out[f"conv{i}"] = {"w": conv.weight.detach().cpu().permute(2, 3, 1, 0).contiguous().numpy(),
                           "b": conv.bias.detach().cpu().numpy().copy()}
    out["head"] = {"w": model.head_w.detach().cpu().numpy().copy(),
                   "b": model.head_b.detach().cpu().numpy().copy()}
    return out


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
