"""The flagship matched-filter workflow (the port's copy of
``das4whales_tpu.workflows.mfdetect``, the reference's
``main_mfdetect.py``): acquire -> design -> bandpass -> hybrid_ninf f-k
filter -> HF/LF matched-filter correlograms -> envelope SNR -> picks,
through :meth:`MatchedFilterDetector.__call__` with the full artifact
set, then the t-x, SNR and detection figures."""

from __future__ import annotations

import torch

from ..models.matched_filter import MatchedFilterDetector
from ..utils.device import resolve_device
from ..utils.profiling import StageTimer
from .common import acquire, maybe_savefig


def main(url: str | None = None, outdir: str | None = None, show: bool = False,
         selected_channels_m=None, with_snr: bool = True, interrogator: str = "optasense",
         device=None):
    """Run the pipeline on ``url`` (None: the offline synthetic scene,
    written under ``data/``; ``interrogator`` reads the file) on
    ``device`` (None: the card); returns a result dict (picks are ``(2,
    n)`` [channel_idx, time_idx] arrays per template). With ``outdir`` or
    ``show`` it draws ``mf_tx.png``, ``mf_snr_<template>.png`` and
    ``mf_detection.png``; matplotlib is checked for before the file is
    read."""
    if outdir is not None or show:
        from ..viz.plot import require_matplotlib

        require_matplotlib("mfdetect with outdir or show")
    device = resolve_device(device)
    timer = StageTimer(sync=torch.cuda.synchronize if device.type == "cuda" else None)
    with timer.stage("acquire"):
        block, meta, sel = acquire(url, selected_channels_m=selected_channels_m,
                                   interrogator=interrogator, device=device)

    with timer.stage("design"):
        det = MatchedFilterDetector(meta, sel, tuple(block.trace.shape), device=device)
        det.design.sparsity_report(verbose=True)  # the reference's tools.disp_comprate

    with timer.stage("detect"):
        res = det(block.trace, with_snr=with_snr)

    figures = {}
    if outdir is not None or show:
        from .. import viz

        fig = viz.plot_tx(res.trf_fk, block.tx, block.dist,
                          file_begin_time_utc=block.t0_utc, show=show)
        figures["tx"] = maybe_savefig(fig, outdir, "mf_tx.png")
        for name, snr in res.snr.items():
            fig = viz.snr_matrix(snr, block.tx, block.dist, vmax=30, title=name, show=show)
            figures[f"snr_{name}"] = maybe_savefig(fig, outdir, f"mf_snr_{name}.png")
        names = list(res.picks)
        fig = viz.detection_mf(
            res.trf_fk, res.picks[names[0]], res.picks[names[-1]],
            block.tx, block.dist, meta.fs, meta.dx, sel,
            file_begin_time_utc=block.t0_utc, show=show, device=device)
        figures["detection"] = maybe_savefig(fig, outdir, "mf_detection.png")

    print(timer.report())
    return {
        "picks": res.picks,
        "thresholds": res.thresholds,
        "trf_fk": res.trf_fk,
        "correlograms": res.correlograms,
        "snr": res.snr,
        "block": block,
        "figures": figures,
        "timings": timer.totals,
    }


if __name__ == "__main__":
    import sys

    main(sys.argv[1] if len(sys.argv) > 1 else None, outdir="out_mfdetect")
