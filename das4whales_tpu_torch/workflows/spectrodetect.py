"""Spectrogram-correlation detection wiring (the port's copy of
``das4whales_tpu.workflows.spectrodetect.campaign_detector``): the shared
bandpass + f-k prefilter feeding a :class:`SpectroCorrDetector`, behind
the eval adapter."""

from __future__ import annotations

from ..eval import SpectroEvalAdapter
from ..models.spectro import SpectroCorrDetector
from .common import mf_prefilter


def campaign_detector(metadata, selected_channels, trace_shape=None, *,
                      threshold: float = 14.0, fused_bandpass: bool = True,
                      device=None, **spectro_kwargs) -> SpectroEvalAdapter:
    """``SpectroEvalAdapter(mf_prefilter(...), SpectroCorrDetector(...))``
    on one device (the card unless ``device="cpu"``)."""
    mf = mf_prefilter(metadata, selected_channels, trace_shape,
                      fused_bandpass=fused_bandpass, device=device)
    return SpectroEvalAdapter(
        mf, SpectroCorrDetector(mf.metadata, threshold=threshold, device=mf.device,
                                **spectro_kwargs),
    )
