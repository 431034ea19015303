"""The flagship matched-filter workflow (the port's copy of
``das4whales_tpu.workflows.mfdetect``, the reference's
``main_mfdetect.py``): acquire -> design -> bandpass -> hybrid_ninf f-k
filter -> HF/LF matched-filter correlograms -> envelope SNR -> picks,
through :meth:`MatchedFilterDetector.__call__` with the full artifact
set. The figures come with the ROADMAP item 'Workflow mains and plots'."""

from __future__ import annotations

import torch

from ..config import not_in_slice
from ..models.matched_filter import MatchedFilterDetector
from ..utils.device import resolve_device
from ..utils.profiling import StageTimer
from .common import acquire


def main(url: str | None = None, outdir: str | None = None, show: bool = False,
         selected_channels_m=None, with_snr: bool = True, device=None):
    """Run the pipeline on ``url`` (None: the offline synthetic scene,
    written under ``data/``) on ``device`` (None: the card); returns a
    result dict (picks are ``(2, n)`` [channel_idx, time_idx] arrays per
    template). ``outdir``/``show`` (the figures) raise: no plots in this
    slice."""
    if outdir is not None or show:
        raise not_in_slice("the figures (outdir, show)", "Workflow mains and plots")
    device = resolve_device(device)
    timer = StageTimer(sync=torch.cuda.synchronize if device.type == "cuda" else None)
    with timer.stage("acquire"):
        block, meta, sel = acquire(url, selected_channels_m=selected_channels_m, device=device)

    with timer.stage("design"):
        det = MatchedFilterDetector(meta, sel, tuple(block.trace.shape), device=device)
        det.design.sparsity_report(verbose=True)  # the reference's tools.disp_comprate

    with timer.stage("detect"):
        res = det(block.trace, with_snr=with_snr)

    print(timer.report())
    return {
        "picks": res.picks,
        "thresholds": res.thresholds,
        "trf_fk": res.trf_fk,
        "correlograms": res.correlograms,
        "snr": res.snr,
        "block": block,
        "figures": {},
        "timings": timer.totals,
    }


if __name__ == "__main__":
    import sys

    main(sys.argv[1] if len(sys.argv) > 1 else None)
