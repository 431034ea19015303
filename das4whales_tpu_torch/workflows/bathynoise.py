"""Bathymetry/noise workflow (the port's copy of
``das4whales_tpu.workflows.bathynoise``, reference
``scripts/main_bathynoise.py``): join cable geometry with strain data and
compute per-channel noise statistics on the device — median/mean of the
envelope, the trace's std, ``SNR_1d = 20 log10(std/med)``
(main_bathynoise.py:183-194) — and the noise power profile against
distance over a quiet time window (main_bathynoise.py:250-258).

The statistics are JAX's: the median of an even count is the midpoint
of the two middle values (``jnp.median``; ``torch.median`` returns the
lower one), and the std has ``ddof=0`` (``torch.std``'s default is 1)."""

from __future__ import annotations

import numpy as np
import torch

from ..models.matched_filter import MatchedFilterDetector
from ..ops.spectral import envelope
from ..utils.device import resolve_device
from .common import acquire, maybe_savefig


def median_last(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median(x, axis=-1)``: the middle value of an odd count, and
    ``(lo + hi) * 0.5`` of the two middle values of an even one."""
    n = x.shape[-1]
    hi = torch.kthvalue(x, n // 2 + 1, dim=-1).values
    if n % 2:
        return hi
    lo = torch.kthvalue(x, n // 2, dim=-1).values
    return (lo + hi) * 0.5


def channel_noise_stats(trf_fk: torch.Tensor) -> dict:
    """Per-channel envelope median/mean, trace std (ddof 0) and SNR_1d
    [dB], as tensors on ``trf_fk``'s device."""
    env = envelope(trf_fk)
    med = median_last(env)
    mean = torch.mean(env, dim=-1)
    std = torch.std(trf_fk, dim=-1, correction=0)
    snr_1d = 20.0 * torch.log10(std / med)
    return {"med": med, "mean": mean, "std": std, "snr_1d": snr_1d}


def noise_power_profile(trf_fk: torch.Tensor, i0: int, i1: int, ref: float = 1e-11):
    """Mean noise power per channel over samples [i0, i1), in dB re
    ``ref^2`` (main_bathynoise.py:255-257), and the window's mean
    envelope."""
    noise = trf_fk[:, i0:i1]
    power = torch.mean(noise * noise, dim=-1)
    power_db = 10.0 * torch.log10(power / ref**2)
    noise_mean = torch.mean(envelope(noise), dim=-1)
    return power_db, noise_mean


def main(url: str | None = None, outdir: str | None = None, show: bool = False,
         selected_channels_m=None, tnoise=(0.0, 5.0), cable_depth_csv: str | None = None,
         interrogator: str = "optasense", device=None):
    """Noise statistics of ``url`` (None: the offline synthetic scene) on
    ``device`` (None: the card), as host arrays in ``stats``; with
    ``cable_depth_csv`` (``chan_idx, lat, lon, depth`` rows) the depth of
    each selected channel, interpolated along the cable. With ``outdir``
    or ``show`` it draws ``bathynoise_profile.png`` and
    ``bathynoise_snr1d.png`` (matplotlib is checked for before the file
    is read)."""
    if outdir is not None or show:
        from ..viz.plot import require_matplotlib

        require_matplotlib("bathynoise with outdir or show")
    device = resolve_device(device)
    block, meta, sel = acquire(url, selected_channels_m=selected_channels_m,
                               interrogator=interrogator, device=device)

    mf = MatchedFilterDetector(meta, sel, tuple(block.trace.shape), device=device)
    trf_fk = mf.filter_block(block.trace)

    stats = {k: v.cpu().numpy() for k, v in channel_noise_stats(trf_fk).items()}
    i0, i1 = (int(t * meta.fs) for t in tnoise)
    power_db, noise_mean = noise_power_profile(trf_fk, i0, i1)
    stats["noise_power_db"] = power_db.cpu().numpy()
    stats["noise_mean"] = noise_mean.cpu().numpy()

    depths = None
    if cable_depth_csv is not None:
        from ..io.coords import load_cable_coordinates

        cols = load_cable_coordinates(cable_depth_csv, meta.dx)
        # nearest geometry sample for each selected channel (by distance)
        depths = np.interp(block.dist, cols["chan_m"], cols["depth"])
        stats["depth"] = depths

    figures = {}
    if outdir is not None or show:
        import matplotlib.pyplot as plt

        fig, ax1 = plt.subplots(figsize=(12, 5))
        ax1.plot(block.dist / 1e3, stats["noise_power_db"], label="noise power")
        ax1.set_xlabel("Distance [km]")
        ax1.set_ylabel("Noise power [dB re 1e-22]")
        if depths is not None:
            ax2 = ax1.twinx()
            ax2.plot(block.dist / 1e3, depths, "tab:orange", alpha=0.6, label="depth")
            ax2.set_ylabel("Depth [m]")
        fig.tight_layout()
        figures["noise_profile"] = maybe_savefig(fig, outdir, "bathynoise_profile.png")

        fig, ax = plt.subplots(figsize=(12, 5))
        ax.plot(block.dist / 1e3, stats["snr_1d"])
        ax.set_xlabel("Distance [km]")
        ax.set_ylabel("SNR_1d [dB]")
        fig.tight_layout()
        figures["snr_1d"] = maybe_savefig(fig, outdir, "bathynoise_snr1d.png")

    return {"stats": stats, "trf_fk": trf_fk, "block": block, "figures": figures}


if __name__ == "__main__":
    import sys

    main(sys.argv[1] if len(sys.argv) > 1 else None, outdir="out_bathynoise")
