"""Host-side figures of the port's arrays (the port's copy of
``das4whales_tpu.viz.plot``, reference plot.py:17-617).

The figures draw host arrays with matplotlib; their device work (the
Hilbert envelopes, the windowed f-x spectra, the instantaneous
frequencies) runs on the port's own ops on ``device`` (None: the card)
in the helpers :func:`envelope_np`, :func:`fx_panels` and
:func:`instant_freq_np`, which need no matplotlib. ``matplotlib`` is
imported inside the render functions only, so ``das4whales_tpu_torch.viz``
imports where it is missing; :func:`require_matplotlib` is the check a
caller makes before work whose end is a figure. Every render function
returns the :class:`matplotlib.figure.Figure` and only ``show()``s on an
interactive backend, so the same code runs headless.
"""

from __future__ import annotations

from datetime import datetime

import numpy as np
import torch

from ..ops.spectral import envelope, fx_transform, instant_freq
from ..utils.device import resolve_device
from .cmaps import import_roseus


def have_matplotlib() -> bool:
    """Whether ``matplotlib`` imports here."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def require_matplotlib(what: str) -> None:
    """Raise ``ImportError`` naming ``what`` when ``matplotlib`` is missing:
    called before any work whose end is a figure, so a run that cannot
    render stops before it reads a file."""
    if not have_matplotlib():
        raise ImportError(f"{what} renders figures and needs matplotlib, which is not "
                          "installed here")


def _pyplot():
    import matplotlib.pyplot as plt

    return plt


def _finish(fig, show: bool | None):
    import matplotlib

    if show is None:
        show = matplotlib.get_backend().lower() not in ("agg", "pdf", "svg", "ps", "template")
    if show:
        _pyplot().show()
    return fig


# ---------------------------------------------------------------------------
# The figures' device work (no matplotlib)
# ---------------------------------------------------------------------------


def _on(x, device) -> torch.Tensor:
    """``x`` (host array or tensor) as float32 on ``device`` (None: the
    card), as the JAX package takes a host array to its default device in
    float32."""
    dev = resolve_device(device)
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=dev)


def envelope_np(trace, device=None) -> np.ndarray:
    """|Hilbert envelope| along the last axis on ``device``, as a host
    array (the figures' ``_env_np``)."""
    return envelope(_on(trace, device)).cpu().numpy()


def fx_panels(trace, fs: float, win_s: float = 2, nfft: int = 4096, device=None) -> list:
    """The per-window f-x spectra of :func:`plot_fx`: one host array a
    ``win_s`` window of ``trace [channel, time]``, each window's
    ``fx_transform`` on ``device``."""
    x = _on(trace, device)
    nb = int(np.ceil(x.shape[1] / (win_s * fs)))
    return [fx_transform(x[:, int(i * win_s * fs): int((i + 1) * win_s * fs)], nfft).cpu().numpy()
            for i in range(nb)]


def instant_freq_np(channel, fs: float, device=None) -> np.ndarray:
    """Instantaneous frequency [Hz] on ``device``, as a host array."""
    return instant_freq(_on(channel, device), fs).cpu().numpy()


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _utc_title(file_begin_time_utc, title: str | None = None):
    if isinstance(file_begin_time_utc, datetime):
        stamp = file_begin_time_utc.strftime("%Y-%m-%d %H:%M:%S")
        return stamp + " / " + title if isinstance(title, str) else stamp
    return title


# ---------------------------------------------------------------------------
# The figures
# ---------------------------------------------------------------------------


def plot_rawdata(trace, time, dist, fig_size=(12, 10), show=None):
    """Raw t-x panel, signed strain in RdBu (reference plot.py:17-40)."""
    plt = _pyplot()
    trace = _host(trace)
    fig = plt.figure(figsize=fig_size)
    wv = plt.imshow(
        trace * 1e9, aspect="auto", cmap="RdBu",
        extent=[min(time), max(time), min(dist) * 1e-3, max(dist) * 1e-3],
        origin="lower", vmin=-500, vmax=500,
    )
    plt.title("Raw DAS data")
    plt.ylabel("Distance [km]")
    plt.xlabel("Time [s]")
    bar = fig.colorbar(wv, aspect=30, pad=0.015)
    bar.set_label(label="Strain [-] (x$10^{-9}$)")
    return _finish(fig, show)


def plot_tx(trace, time, dist, file_begin_time_utc=0, fig_size=(12, 10),
            v_min=None, v_max=None, show=None):
    """t-x waterfall of |strain|·1e9 in turbo (reference plot.py:43-92)."""
    plt = _pyplot()
    trace = _host(trace)
    fig = plt.figure(figsize=fig_size)
    shw = plt.imshow(
        np.abs(trace) * 1e9,
        extent=[time[0], time[-1], dist[0] * 1e-3, dist[-1] * 1e-3],
        aspect="auto", origin="lower", cmap="turbo", vmin=v_min, vmax=v_max,
    )
    plt.ylabel("Distance (km)")
    plt.xlabel("Time (s)")
    bar = fig.colorbar(shw, aspect=30, pad=0.015)
    bar.set_label("Strain Envelope (x$10^{-9}$)")
    t = _utc_title(file_begin_time_utc)
    if t:
        plt.title(t, loc="right")
    plt.tight_layout()
    return _finish(fig, show)


def plot_fx(trace, dist, fs, file_begin_time_utc=0, win_s=2, nfft=4096,
            fig_size=(12, 10), f_min=0, f_max=100, v_min=None, v_max=None, show=None,
            device=None):
    """Windowed f-x panels, 3 rows of per-window spectra (reference
    plot.py:95-187); the spectra from :func:`fx_panels` on ``device``."""
    plt = _pyplot()
    panels = fx_panels(trace, fs, win_s, nfft, device)
    nb_subplots = len(panels)
    freq = np.fft.fftshift(np.fft.fftfreq(nfft, d=1 / fs))

    rows = 3
    cols = int(np.ceil(nb_subplots / rows))
    fig, axes = plt.subplots(rows, cols, figsize=fig_size, squeeze=False)

    shw = None
    for ind, fx in enumerate(panels):
        r, c = ind // cols, ind % cols
        ax = axes[r][c]
        shw = ax.imshow(
            fx, extent=[freq[0], freq[-1], dist[0] * 1e-3, dist[-1] * 1e-3],
            aspect="auto", origin="lower", cmap="jet", vmin=v_min, vmax=v_max,
        )
        ax.set_xlim([f_min, f_max])
        if r == rows - 1:
            ax.set_xlabel("Frequency (Hz)")
        else:
            ax.set_xticks([])
            ax.xaxis.set_tick_params(labelbottom=False)
        if c == 0:
            ax.set_ylabel("Distance (km)")
        else:
            ax.set_yticks([])
            ax.yaxis.set_tick_params(labelleft=False)

    t = _utc_title(file_begin_time_utc)
    if t:
        plt.title(t, loc="right")
    if shw is not None:
        bar = fig.colorbar(shw, ax=axes.ravel().tolist())
        bar.set_label("Strain (x$10^{-9}$)")
    return _finish(fig, show)


def plot_spectrogram(p, tt, ff, fig_size=(17, 5), v_min=None, v_max=None,
                     f_min=None, f_max=None, show=None):
    """Single-channel spectrogram in roseus (reference plot.py:190-229)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=fig_size)
    shw = ax.pcolormesh(_host(tt), _host(ff), _host(p),
                        shading="auto", cmap=import_roseus(), vmin=v_min, vmax=v_max)
    ax.set_ylim(f_min, f_max)
    ax.set_xlabel("Time (s)")
    ax.set_ylabel("Frequency (Hz)")
    bar = fig.colorbar(shw, aspect=30, pad=0.015)
    bar.set_label("dB (strain x$10^{-9}$)")
    return _finish(fig, show)


def plot_3calls(channel, time, t1, t2, t3, show=None):
    """One overview + three 2 s zoom panels (reference plot.py:232-289)."""
    plt = _pyplot()
    channel = _host(channel)
    time = np.asarray(time)
    fig = plt.figure(figsize=(12, 4))

    plt.subplot(211)
    plt.plot(time, channel, ls="-")
    plt.xlim([time[0], time[-1]])
    plt.ylabel("strain [-]")
    plt.grid()
    plt.tight_layout()

    for pos, t0 in zip((234, 235, 236), (t1, t2, t3)):
        plt.subplot(pos)
        plt.plot(time, channel)
        plt.xlim([t0, t0 + 2.0])
        plt.xlabel("time [s]")
        if pos == 234:
            plt.ylabel("strain [-]")
        plt.grid()
        plt.tight_layout()
    return _finish(fig, show)


def design_mf(trace, hnote, lnote, th, tl, time, fs, show=None, device=None):
    """Template-design panels: measured call vs template waveform and
    instantaneous frequency (on ``device``) for the HF and LF notes
    (reference plot.py:292-370; one 2x2 figure)."""
    plt = _pyplot()
    trace = _host(trace)
    hnote = _host(hnote)
    lnote = _host(lnote)
    time = np.asarray(time)

    nf = int(th * fs)
    nl = int(tl * fs)
    dummy_chan = np.zeros_like(hnote)
    dummy_chan[nf:] = hnote[: hnote.size - nf]
    dummy_chan[nl:] = lnote[: lnote.size - nl]

    fi = instant_freq_np(trace, fs, device)
    fi_mf = instant_freq_np(dummy_chan, fs, device)

    fig, axes = plt.subplots(2, 2, figsize=(18, 8))
    for row, (t0, flims) in enumerate(zip((th, tl), ((15.0, 35.0), (12.0, 28.0)))):
        ax = axes[row][0]
        ax.plot(time, (trace - trace.mean() * row) / np.max(np.abs(trace)),
                label="normalized measured fin call")
        ax.plot(time, (dummy_chan - dummy_chan.mean() * row) / np.max(np.abs(dummy_chan)),
                label="template")
        ax.set_title(f"fin whale call template - {'HF' if row == 0 else 'LF'} note")
        ax.set_xlabel("Time (seconds)")
        ax.set_ylabel("Amplitude")
        ax.set_xlim(t0 - 0.5, t0 + 1.5)
        ax.grid()
        ax.legend()

        ax = axes[row][1]
        ax.plot(time[1:], fi, label="measured fin call")
        ax.plot(time[1:], fi_mf, label="template")
        ax.set_xlim([t0 - 0.5, t0 + 1.5])
        ax.set_ylim(list(flims))
        ax.set_xlabel("Time (seconds)")
        ax.set_ylabel("Instantaneous frequency [Hz]")
        ax.legend()
        ax.grid()
    plt.tight_layout()
    return _finish(fig, show)


def _detection_panel(trace, time, dist, picks, fig_size=(12, 10),
                     file_begin_time_utc=None, show=None, device=None):
    """Shared envelope-waterfall-with-scatter body of the three
    ``detection_*`` figures (reference plot.py:373-505). ``picks`` is a
    list of (peaks_idx, time_scale_hz, dist_fn, color, marker, label)."""
    plt = _pyplot()
    fig = plt.figure(figsize=fig_size)
    cplot = plt.imshow(
        envelope_np(trace, device) * 1e9,
        extent=[time[0], time[-1], dist[0] / 1e3, dist[-1] / 1e3],
        cmap="jet", origin="lower", aspect="auto", vmin=0, vmax=0.4, alpha=0.35,
    )
    for peaks_idx, rate_hz, to_km, color, marker, label in picks:
        peaks_idx = _host(peaks_idx)
        plt.scatter(np.asarray(peaks_idx[1]) / rate_hz, to_km(np.asarray(peaks_idx[0])),
                    color=color, marker=marker, label=label)
    bar = fig.colorbar(cplot, aspect=30, pad=0.015)
    bar.set_label("Strain Envelope [-] (x$10^{-9}$)")
    plt.xlabel("Time [s]")
    plt.ylabel("Distance [km]")
    plt.legend(loc="upper right")
    t = _utc_title(file_begin_time_utc)
    if t:
        plt.title(t, loc="right")
    plt.tight_layout()
    return _finish(fig, show)


def _pick_to_km(selected_channels, dx):
    start, _, step = selected_channels
    return lambda chan_idx: (chan_idx * step + start) * dx / 1e3


def detection_mf(trace, peaks_idx_HF, peaks_idx_LF, time, dist, fs, dx,
                 selected_channels, file_begin_time_utc=None, show=None, device=None):
    """Matched-filter picks over the envelope waterfall (reference
    plot.py:373-415)."""
    km = _pick_to_km(selected_channels, dx)
    return _detection_panel(
        trace, time, dist,
        [(peaks_idx_HF, fs, km, "red", ".", "HF_note"),
         (peaks_idx_LF, fs, km, "green", ".", "LF_note")],
        file_begin_time_utc=file_begin_time_utc, show=show, device=device)


def detection_spectcorr(trace, peaks_idx_HF, peaks_idx_LF, time, dist, spectro_fs,
                        dx, selected_channels, file_begin_time_utc=None, show=None,
                        device=None):
    """Spectrogram-correlation picks; time axis in spectrogram hops
    rescaled by ``spectro_fs`` (reference plot.py:418-461)."""
    km = _pick_to_km(selected_channels, dx)
    return _detection_panel(
        trace, time, dist,
        [(peaks_idx_HF, spectro_fs, km, "red", "x", "HF call"),
         (peaks_idx_LF, spectro_fs, km, "green", ".", "LF_note")],
        file_begin_time_utc=file_begin_time_utc, show=show, device=device)


def detection_grad(trace, peaks_idx, time, dist, fs, dx, selected_channels,
                   file_begin_time_utc=None, show=None, device=None):
    """Gabor/gradient-detector picks (reference plot.py:464-505)."""
    km = _pick_to_km(selected_channels, dx)
    return _detection_panel(
        trace, time, dist,
        [(peaks_idx, fs, km, "red", "x", "Fin call")],
        file_begin_time_utc=file_begin_time_utc, show=show, device=device)


def detection_learned(scores, centers, picks, fs, dist, threshold=None, show=None):
    """Learned-family diagnostics: the classifier's ``[C, n_win]`` score
    map on (time, distance) axes with above-threshold picks overlaid —
    the family's analog of the correlogram waterfalls (no reference
    counterpart; the learned family is new)."""
    plt = _pyplot()
    scores = _host(scores)
    centers = _host(centers)
    fig, ax = plt.subplots(figsize=(12, 6))
    t = centers / fs
    extent = [t[0], t[-1], dist[0] / 1e3, dist[-1] / 1e3]
    im = ax.imshow(scores, aspect="auto", origin="lower", extent=extent,
                   cmap="viridis", vmin=0.0, vmax=1.0)
    if picks is not None and _host(picks).size:
        pk = _host(picks)
        ax.scatter(pk[1] / fs, np.asarray(dist)[pk[0]] / 1e3,
                   s=14, facecolors="none", edgecolors="red", label="picks")
        ax.legend(loc="upper right")
    ax.set_xlabel("Time (s)")
    ax.set_ylabel("Distance (km)")
    title = "Learned detector scores"
    if threshold is not None:
        title += f" (threshold {threshold:.2f})"
    ax.set_title(title)
    fig.colorbar(im, ax=ax, label="call probability")
    fig.tight_layout()
    return _finish(fig, show)


def snr_matrix(snr_m, time, dist, vmax, file_begin_time_utc=None, title=None, show=None):
    """Local-SNR waterfall in turbo (reference plot.py:508-539)."""
    import matplotlib.ticker as tkr

    plt = _pyplot()
    fig = plt.figure(figsize=(12, 10))
    snrp = plt.imshow(
        _host(snr_m), extent=[time[0], time[-1], dist[0] / 1e3, dist[-1] / 1e3],
        cmap="turbo", origin="lower", aspect="auto", vmin=0, vmax=vmax,
    )
    bar = fig.colorbar(snrp, aspect=30, pad=0.015)
    bar.set_label("SNR [dB]")
    bar.ax.yaxis.set_major_formatter(tkr.FormatStrFormatter("%.0f"))
    plt.xlabel("Time [s]")
    plt.ylabel("Distance [km]")
    t = _utc_title(file_begin_time_utc, title)
    if t:
        plt.title(t, loc="right")
    plt.tight_layout()
    return _finish(fig, show)


def plot_cross_correlogramHL(corr_m_HF, corr_m_LF, time, dist, maxv, minv=0,
                             file_begin_time_utc=None, show=None, device=None):
    """HF/LF correlogram envelopes side by side (reference plot.py:542-581)."""
    plt = _pyplot()
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(16, 8), constrained_layout=True)
    ext = [time[0], time[-1], dist[0] / 1e3, dist[-1] / 1e3]
    im1 = ax1.imshow(envelope_np(corr_m_HF, device), extent=ext, cmap="turbo",
                     origin="lower", aspect="auto", vmin=minv, vmax=maxv)
    ax1.set_xlabel("Time [s]")
    ax1.set_ylabel("Distance [km]")
    ax1.set_title("HF note", loc="right")
    ax2.imshow(envelope_np(corr_m_LF, device), extent=ext, cmap="turbo", origin="lower",
               aspect="auto", vmin=minv, vmax=maxv)
    ax2.set_xlabel("Time [s]")
    ax2.set_title("LF note", loc="right")
    cbar = fig.colorbar(im1, ax=[ax1, ax2], orientation="horizontal", aspect=50, pad=0.02)
    cbar.set_label("Cross-correlation envelope []")
    return _finish(fig, show)


def plot_cross_correlogram(corr_m, time, dist, maxv, minv=0,
                           file_begin_time_utc=None, show=None, device=None):
    """Single correlogram envelope (reference plot.py:584-617)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(12, 10), constrained_layout=True)
    im = ax.imshow(envelope_np(corr_m, device),
                   extent=[time[0], time[-1], dist[0] / 1e3, dist[-1] / 1e3],
                   cmap="turbo", origin="lower", aspect="auto", vmin=minv, vmax=maxv)
    ax.set_xlabel("Time [s]")
    ax.set_ylabel("Distance [km]")
    ax.set_title("Cross-correlogram", loc="right")
    cbar = fig.colorbar(im, ax=ax, orientation="horizontal", aspect=50, pad=0.02)
    cbar.set_label("Cross-correlation envelope []")
    return _finish(fig, show)


def plot_eval_curves(rows, x_key="snr_db", show=None):
    """Detection-performance curves from ``eval.amplitude_sweep`` /
    ``eval.threshold_sweep`` rows: recall (solid) and precision (dashed)
    per template against the sweep variable (no reference analog)."""
    plt = _pyplot()
    names = [k for k in rows[0] if isinstance(rows[0][k], dict)]
    xs = [r[x_key] for r in rows]
    fig, ax = plt.subplots(figsize=(7, 5))
    for name in names:
        ax.plot(xs, [r[name]["recall"] for r in rows], "-o", label=f"{name} recall")
        ax.plot(xs, [r[name]["precision"] for r in rows], "--s",
                label=f"{name} precision", alpha=0.7)
    label = {"snr_db": "SNR [dB]", "threshold": "absolute threshold",
             "amplitude": "call amplitude"}.get(x_key, x_key)
    ax.set_xlabel(label)
    ax.set_ylabel("fraction")
    ax.set_ylim(-0.05, 1.05)
    ax.grid(alpha=0.3)
    ax.legend()
    ax.set_title("Detection performance")
    fig.tight_layout()
    return _finish(fig, show)
