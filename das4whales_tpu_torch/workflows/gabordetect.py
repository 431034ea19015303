"""Gabor/image detection (the port's copy of
``das4whales_tpu.workflows.gabordetect``, the reference's
``main_gabordetect.py``): the shared bandpass + f-k prefilter, then the
envelope image, the oriented Gabor score at the sound-speed slope, the
binned mask, the masked matched filter and the picks — behind the eval
adapter for the campaigns (``campaign_detector``), or as the workflow
``main``. The figures come with the ROADMAP item 'Workflow mains and
plots'."""

from __future__ import annotations

import torch

from ..config import not_in_slice
from ..eval import GaborEvalAdapter
from ..models.gabor import GaborDetector
from ..models.matched_filter import MatchedFilterDetector
from ..utils.device import resolve_device
from ..utils.profiling import StageTimer
from .common import acquire, mf_prefilter


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
         selected_channels_m=None, device=None, **gabor_kwargs):
    """Run the Gabor workflow on ``url`` (None: the offline synthetic
    scene, written under ``data/``) on ``device`` (None: the card): the
    matched filter's ``filter_block`` as prefilter, then
    :class:`GaborDetector` (``gabor_kwargs`` go to it). Returns the
    detector's result dict with ``trf_fk``, ``block``, ``figures`` and
    ``timings`` added. ``outdir``/``show`` (the figures) raise: no plots in
    this slice."""
    if outdir is not None or show:
        raise not_in_slice("the figures (outdir, show)", "Workflow mains and plots")
    device = resolve_device(device)
    timer = StageTimer(sync=torch.cuda.synchronize if device.type == "cuda" else None)
    with timer.stage("acquire"):
        block, meta, sel = acquire(url, selected_channels_m=selected_channels_m, device=device)

    with timer.stage("design"):
        mf = MatchedFilterDetector(meta, sel, tuple(block.trace.shape), device=device)
        det = GaborDetector(meta.with_shape(*block.trace.shape), sel, device=device,
                            **gabor_kwargs)

    with timer.stage("detect"):
        trf_fk = mf.filter_block(block.trace)
        res = det(trf_fk)

    print(timer.report())
    res["trf_fk"] = trf_fk
    res["block"] = block
    res["figures"] = {}
    res["timings"] = timer.totals
    return res


if __name__ == "__main__":
    import sys

    main(sys.argv[1] if len(sys.argv) > 1 else None)
