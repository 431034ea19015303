"""Gabor/image detection (the port's copy of
``das4whales_tpu.workflows.gabordetect``, the reference's
``main_gabordetect.py``): the shared bandpass + f-k prefilter, then the
envelope image, the oriented Gabor score at the sound-speed slope, the
binned mask, the masked matched filter and the picks — behind the eval
adapter for the campaigns (``campaign_detector``), or as the workflow
``main`` with its detection figure."""

from __future__ import annotations

import torch

from ..eval import GaborEvalAdapter
from ..models.gabor import GaborDetector
from ..models.matched_filter import MatchedFilterDetector
from ..utils.device import resolve_device
from ..utils.profiling import StageTimer
from .common import acquire, maybe_savefig, mf_prefilter


def campaign_detector(metadata, selected_channels, trace_shape=None, *,
                      fused_bandpass: bool = True, device=None, design=None,
                      **gabor_kwargs) -> GaborEvalAdapter:
    """``GaborEvalAdapter(mf_prefilter(...), GaborDetector(...))`` on one
    device (the card unless ``device="cpu"``). ``design`` (a
    ``MatchedFilterDesign`` at ``trace_shape``) builds the prefilter on it
    instead of designing the f-k mask, tens of seconds at the canonical
    shape. The family's ladder is per-file -> host: the oriented pair
    couples about a thousand channels of the image, so there is no tiled
    rung."""
    if design is None:
        mf = mf_prefilter(metadata, selected_channels, trace_shape,
                          fused_bandpass=fused_bandpass, device=device)
    else:
        mf = MatchedFilterDetector.from_design(design, metadata,
                                               fused_bandpass=fused_bandpass, device=device)
    return GaborEvalAdapter(
        mf, GaborDetector(mf.metadata, list(selected_channels), device=mf.device,
                          **gabor_kwargs),
    )


def main(url: str | None = None, outdir: str | None = None, show: bool = False,
         selected_channels_m=None, interrogator: str = "optasense", device=None,
         **gabor_kwargs):
    """Run the Gabor workflow on ``url`` (None: the offline synthetic
    scene, written under ``data/``; ``interrogator`` reads the file) on
    ``device`` (None: the card): the matched filter's ``filter_block`` as
    prefilter, then :class:`GaborDetector` (``gabor_kwargs`` go to it).
    Returns the detector's result dict with ``trf_fk``, ``block``,
    ``figures`` and ``timings`` added. With ``outdir`` or ``show`` it
    draws ``gabor_detection.png``; matplotlib is checked for before the
    file is read."""
    if outdir is not None or show:
        from ..viz.plot import require_matplotlib

        require_matplotlib("gabordetect with outdir or show")
    device = resolve_device(device)
    timer = StageTimer(sync=torch.cuda.synchronize if device.type == "cuda" else None)
    with timer.stage("acquire"):
        block, meta, sel = acquire(url, selected_channels_m=selected_channels_m,
                                   interrogator=interrogator, device=device)

    with timer.stage("design"):
        mf = MatchedFilterDetector(meta, sel, tuple(block.trace.shape), device=device)
        det = GaborDetector(meta.with_shape(*block.trace.shape), sel, device=device,
                            **gabor_kwargs)

    with timer.stage("detect"):
        trf_fk = mf.filter_block(block.trace)
        res = det(trf_fk)

    figures = {}
    if outdir is not None or show:
        from .. import viz

        names = list(res["picks"])
        fig = viz.detection_grad(
            trf_fk, res["picks"][names[0]], block.tx, block.dist,
            meta.fs, meta.dx, sel, file_begin_time_utc=block.t0_utc, show=show,
            device=device)
        figures["detection"] = maybe_savefig(fig, outdir, "gabor_detection.png")

    print(timer.report())
    res["trf_fk"] = trf_fk
    res["block"] = block
    res["figures"] = figures
    res["timings"] = timer.totals
    return res


if __name__ == "__main__":
    import sys

    main(sys.argv[1] if len(sys.argv) > 1 else None, outdir="out_gabordetect")
