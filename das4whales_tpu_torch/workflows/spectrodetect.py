"""Spectrogram-correlation detection (the port's copy of
``das4whales_tpu.workflows.spectrodetect``, the reference's
``main_spectrodetect.py``): the shared bandpass + f-k prefilter feeding a
:class:`SpectroCorrDetector` — behind the eval adapter for the campaigns
(``campaign_detector``), or as the workflow ``main`` with its detection
figure."""

from __future__ import annotations

from ..eval import SpectroEvalAdapter
from ..models.matched_filter import MatchedFilterDetector
from ..models.spectro import SpectroCorrDetector
from ..utils.device import resolve_device
from .common import acquire, maybe_savefig, mf_prefilter


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


def main(url: str | None = None, outdir: str | None = None, show: bool = False,
         selected_channels_m=None, threshold: float = 14.0, interrogator: str = "optasense",
         device=None):
    """Run the spectro workflow on ``url`` (None: the offline synthetic
    scene; ``interrogator`` reads the file) on ``device`` (None: the
    card): the matched filter's ``filter_block`` as prefilter, then the
    spectrogram correlation; picks are in spectrogram frames
    (``spectro_fs``). With ``outdir`` or ``show`` it draws
    ``spectro_detection.png``; matplotlib is checked for before the file
    is read."""
    if outdir is not None or show:
        from ..viz.plot import require_matplotlib

        require_matplotlib("spectrodetect with outdir or show")
    device = resolve_device(device)
    block, meta, sel = acquire(url, selected_channels_m=selected_channels_m,
                               interrogator=interrogator, device=device)

    mf = MatchedFilterDetector(meta, sel, tuple(block.trace.shape), device=device)
    trf_fk = mf.filter_block(block.trace)

    det = SpectroCorrDetector(meta.with_shape(*block.trace.shape), threshold=threshold,
                              device=mf.device)
    correlograms, picks, spectro_fs = det(trf_fk)

    figures = {}
    if outdir is not None or show:
        from .. import viz

        names = list(picks)
        fig = viz.detection_spectcorr(
            trf_fk, picks[names[0]], picks[names[-1]],
            block.tx, block.dist, spectro_fs, meta.dx, sel,
            file_begin_time_utc=block.t0_utc, show=show, device=mf.device)
        figures["detection"] = maybe_savefig(fig, outdir, "spectro_detection.png")

    return {
        "picks": picks,
        "correlograms": correlograms,
        "spectro_fs": spectro_fs,
        "trf_fk": trf_fk,
        "block": block,
        "figures": figures,
    }


if __name__ == "__main__":
    import sys

    main(sys.argv[1] if len(sys.argv) > 1 else None, outdir="out_spectrodetect")
