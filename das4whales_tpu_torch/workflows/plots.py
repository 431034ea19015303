"""Basic load/filter/visualize workflow (the port's copy of
``das4whales_tpu.workflows.plots``, reference ``scripts/main_plots.py``
and the tutorial flow): load -> bandpass -> f-k filter -> t-x plot ->
best-channel spectrogram -> template-design panel -> the best channel
as a 5x-rate WAV."""

from __future__ import annotations

import os

import numpy as np

from ..models.matched_filter import MatchedFilterDetector
from ..models.templates import gen_template_fincall
from ..ops.spectral import spectrogram
from ..utils.audio import export_audio
from ..utils.device import resolve_device
from .common import acquire, maybe_savefig


def main(url: str | None = None, outdir: str | None = None, show: bool = False,
         selected_channels_m=None, audio: bool = True, interrogator: str = "optasense",
         device=None):
    """Filter ``url`` (None: the offline synthetic scene) on ``device``
    (None: the card), pick the best channel (the largest peak amplitude,
    the first on a tie) and take its spectrogram there. With ``outdir`` or
    ``show`` it draws ``plots_tx.png``, ``plots_fx.png``,
    ``plots_spectrogram.png`` and ``plots_design_mf.png`` (matplotlib is
    checked for before the file is read); with ``outdir`` and ``audio``
    it writes ``channel_<best>_x5.wav``."""
    if outdir is not None or show:
        from ..viz.plot import require_matplotlib

        require_matplotlib("plots with outdir or show")
    device = resolve_device(device)
    block, meta, sel = acquire(url, selected_channels_m=selected_channels_m,
                               interrogator=interrogator, device=device)

    mf = MatchedFilterDetector(meta, sel, tuple(block.trace.shape), device=device)
    trf_fk = mf.filter_block(block.trace)

    # best channel by peak amplitude (main_mfdetect.py:61 idiom)
    best = int(trf_fk.abs().amax(dim=1).argmax())
    p, tt, ff = spectrogram(trf_fk[best], meta.fs)

    figures = {}
    tr_best = None
    if outdir is not None or show:
        from .. import viz

        fig = viz.plot_tx(trf_fk, block.tx, block.dist,
                          file_begin_time_utc=block.t0_utc, show=show)
        figures["tx"] = maybe_savefig(fig, outdir, "plots_tx.png")
        step = max(trf_fk.shape[0] // 64, 1)
        fig = viz.plot_fx(trf_fk[::step], block.dist[::step], meta.fs, nfft=512, show=show,
                          device=device)
        figures["fx"] = maybe_savefig(fig, outdir, "plots_fx.png")
        fig = viz.plot_spectrogram(p, tt, ff, f_min=10, f_max=35, show=show)
        figures["spectrogram"] = maybe_savefig(fig, outdir, "plots_spectrogram.png")

        time = block.tx
        tr_best = trf_fk[best].cpu().numpy()
        hf = np.asarray(gen_template_fincall(time, meta.fs, 17.8, 28.8, 0.68))
        lf = np.asarray(gen_template_fincall(time, meta.fs, 14.7, 21.8, 0.78))
        t_peak = float(np.argmax(np.abs(tr_best)) / meta.fs)
        fig = viz.design_mf(tr_best, hf, lf, t_peak, t_peak, time, meta.fs, show=show,
                            device=device)
        figures["design_mf"] = maybe_savefig(fig, outdir, "plots_design_mf.png")

    audio_path = None
    if audio and outdir is not None:
        if tr_best is None:
            tr_best = trf_fk[best].cpu().numpy()
        os.makedirs(outdir, exist_ok=True)
        audio_path = export_audio(tr_best, meta.fs,
                                  os.path.join(outdir, f"channel_{best}_x5.wav"), speed=5.0)

    return {
        "trf_fk": trf_fk,
        "best_channel": best,
        "spectrogram": (p, tt, ff),
        "block": block,
        "figures": figures,
        "audio": audio_path,
    }


if __name__ == "__main__":
    import sys

    main(sys.argv[1] if len(sys.argv) > 1 else None, outdir="out_plots")
