"""The spectro and Gabor families' adapters to the evaluation protocol
and the scenes' ground-truth arrivals (the port's copy of
``arrival_times``, ``_EvalResult``, ``SpectroEvalAdapter`` and
``GaborEvalAdapter`` of ``das4whales_tpu.eval``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import numpy as np

from .utils.views import cached_shallow_view


def arrival_times(call, scene) -> np.ndarray:
    """Per-channel arrival time [s] of ``call`` (an ``io.synth.SyntheticCall``)
    in ``scene``'s geometry: the straight cable along x, the 3-D slant
    range at the call's speed (``io.synth.synthesize_scene``'s injection
    delays)."""
    x = np.arange(scene.nx) * scene.dx
    slant = np.sqrt((x - call.x0_m) ** 2 + call.y0_m ** 2 + call.z0_m ** 2)
    return call.t0 + slant / call.speed


@dataclass
class _EvalResult:
    picks: Dict[str, np.ndarray]
    #: per-template effective thresholds when the family exposes them;
    #: None means absent
    thresholds: Dict[str, float] | None = None


class SpectroEvalAdapter:
    """Adapts the spectrogram-correlation family to the detector protocol
    ``adapter(block, threshold=None) -> result.picks``.

    ``prefilter`` supplies the bandpass + f-k front end: a
    ``MatchedFilterDetector`` (its ``filter_block``) or any callable
    mapping a block to ``trf_fk``. Pick times are converted from
    spectrogram-hop units back to sample units (the inverse of the
    workflow's ``spectro_fs`` rescale)."""

    def __init__(self, prefilter, spectro_detector):
        self.prefilter = prefilter
        self.det = spectro_detector
        self.template_configs = dict(spectro_detector.kernels)

    def __call__(self, block, threshold: float | None = None,
                 stage_hook: Callable[[str], None] | None = None) -> _EvalResult:
        """Picks in sample units of one block. ``threshold`` overrides the
        detector's absolute threshold for this call (the threshold-sweep
        knob). ``stage_hook(name)`` is called after ``prefilter`` and
        passed on to the detector."""
        filt = getattr(self.prefilter, "filter_block", self.prefilter)
        trf_fk = filt(block)
        if stage_hook is not None:
            stage_hook("prefilter")
        if threshold is None:
            _, picks, spectro_fs = self.det(trf_fk, stage_hook=stage_hook)
        else:
            saved = self.det.threshold
            try:
                self.det.threshold = float(threshold)
                _, picks, spectro_fs = self.det(trf_fk, stage_hook=stage_hook)
            finally:
                self.det.threshold = saved
        fs = self.det.metadata.fs
        out = {}
        for name, pk in picks.items():
            pk = np.asarray(pk)
            t_samples = np.round(pk[1] * (fs / spectro_fs)).astype(int)
            out[name] = np.asarray([pk[0], t_samples])
        # one absolute correlogram threshold serves every kernel
        thr = float(self.det.threshold if threshold is None else threshold)
        return _EvalResult(picks=out, thresholds={name: thr for name in out})


class GaborEvalAdapter:
    """Adapts the Gabor/image family to the detector protocol
    ``adapter(block, threshold=None) -> result.picks``.

    ``prefilter`` is the shared bandpass + f-k front end
    (main_gabordetect.py:10-74): a ``MatchedFilterDetector`` (its
    ``filter_block``) or any callable mapping a block to ``trf_fk``. The
    Gabor picks are in sample units already; the notes' ``(fmin, fmax,
    duration)`` become the template configurations."""

    def __init__(self, prefilter, gabor_detector):
        self.prefilter = prefilter
        self.det = gabor_detector
        self.template_configs = {
            name: {"f0": fmax, "f1": fmin, "dur": dur}
            for name, (fmin, fmax, dur) in gabor_detector.note_params.items()
        }

    def host_view(self) -> "GaborEvalAdapter":
        """This adapter on the CPU (the ladder's host rung): the prefilter's
        and the detector's host views. Cached: repeated calls return the
        same view."""

        def mutate(adapter):
            adapter.prefilter = self.prefilter.host_view()
            adapter.det = self.det.host_view()

        return cached_shallow_view(self, "_host_view_cache", mutate)

    def __call__(self, block, threshold: float | None = None,
                 stage_hook: Callable[[str], None] | None = None) -> _EvalResult:
        """Picks of one block and the per-note thresholds. ``threshold``
        overrides the relative policy with an absolute value;
        ``stage_hook(name)`` is called after ``prefilter`` and passed on to
        the detector."""
        filt = getattr(self.prefilter, "filter_block", self.prefilter)
        trf_fk = filt(block)
        if stage_hook is not None:
            stage_hook("prefilter")
        out = self.det(trf_fk, threshold=threshold, stage_hook=stage_hook)
        return _EvalResult(picks={k: np.asarray(v) for k, v in out["picks"].items()},
                           thresholds=out.get("thresholds"))
