"""The spectro family's adapter to the evaluation protocol (the port's
copy of ``_EvalResult`` and ``SpectroEvalAdapter`` of
``das4whales_tpu.eval``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import numpy as np


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
