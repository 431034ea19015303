"""Chunked ops over long records (the reference's dask layer,
``tools.py``), the port of ``das4whales_tpu.ops.chunked``.

The reference splits a long record into time chunks and accepts error at
their edges for time-domain filters. Here the chunk axis is one more
batch axis of one tensor program, and the zero-phase filters overlap
their windows by a halo (:func:`_chunked_zero_phase`), so chunk edges
match the unchunked filter to within the IIR's decay over ``halo``
samples. Every function works on the last (time) axis over any leading
axes.

Timing note for the exact IIR: ``filtfilt``/``sosfiltfilt`` are a
recurrence over time (``ops.filters``), one step a sample. Chunked, every
window filters at once along the batch axis, so the serial length falls
from the record's ``T`` to ``chunk + 2*halo`` (plus the odd extension at
both ends of each window) — the wall a card pays scales with that, not
with ``T``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import fk as fk_ops
from .filters import filtfilt, sosfiltfilt
from .spectral import hann_window

#: the reference's ``tools.disp_comprate``
disp_comprate = fk_ops.compression_report


def detrend_linear(x: torch.Tensor) -> torch.Tensor:
    """Remove the least-squares line along the last axis
    (``scipy.signal.detrend``'s default)."""
    n = x.shape[-1]
    t = torch.arange(n, dtype=x.dtype, device=x.device) - (n - 1) / 2.0
    denom = torch.sum(t * t)
    slope = torch.sum(x * t, dim=-1, keepdim=True) / denom
    mean = torch.mean(x, dim=-1, keepdim=True)
    return x - mean - slope * t


def welch_psd(x: torch.Tensor, fs: float, nperseg: int = 1024, noverlap: int | None = None,
              scaling: str = "density") -> torch.Tensor:
    """One-sided Welch PSD along the last axis (``scipy.signal.welch``:
    periodic Hann window, 50 % overlap, constant detrend a segment,
    ``density`` or ``spectrum`` scaling), one batched rfft over every
    segment. ``nperseg`` shrinks to the signal length, as scipy's does."""
    n = x.shape[-1]
    if nperseg > n:
        nperseg = n
    if noverlap is None:
        noverlap = nperseg // 2
    elif noverlap >= nperseg:
        raise ValueError(f"noverlap ({noverlap}) must be < nperseg ({nperseg})")
    step = nperseg - noverlap
    n_seg = max((n - noverlap) // step, 1)
    segs = x.unfold(-1, nperseg, step)[..., :n_seg, :]      # [..., n_seg, nperseg]
    segs = segs - torch.mean(segs, dim=-1, keepdim=True)
    win = hann_window(nperseg, periodic=True, dtype=x.dtype, device=x.device)
    spec = torch.fft.rfft(segs * win, dim=-1)
    pxx = spec.real ** 2 + spec.imag ** 2
    if scaling == "density":
        pxx = pxx / (fs * torch.sum(win ** 2))
    else:
        pxx = pxx / torch.sum(win) ** 2
    # one-sided doubling except DC (and Nyquist when nperseg is even)
    last = pxx.shape[-1] - 1 if nperseg % 2 == 0 else pxx.shape[-1]
    scale = torch.ones(pxx.shape[-1], dtype=pxx.dtype, device=pxx.device)
    scale[1:last] = 2.0
    return torch.mean(pxx * scale, dim=-2)


def welch_freqs(fs: float, nperseg: int = 1024) -> np.ndarray:
    """The frequency axis of :func:`welch_psd`."""
    return np.fft.rfftfreq(nperseg, d=1.0 / fs)


def spec(x: torch.Tensor, fs: float, chunk: int = 3000, nperseg: int = 1024) -> torch.Tensor:
    """Welch PSD a time chunk -> ``[..., n_chunks, nfreq]`` (the
    reference's ``tools.spec``, with ``chunk`` and ``fs`` as parameters);
    a trailing partial chunk is dropped."""
    n_chunks = x.shape[-1] // chunk
    xc = x[..., : n_chunks * chunk].reshape(tuple(x.shape[:-1]) + (n_chunks, chunk))
    return welch_psd(xc, fs, nperseg=min(nperseg, chunk))


def energy_time_domain(x: torch.Tensor, chunk: int) -> torch.Tensor:
    """Energy ``sum(x^2)`` a time chunk -> ``[..., n_chunks]`` (the
    reference's ``tools.energy_TimeDomain``); a trailing partial chunk is
    dropped."""
    n_chunks = x.shape[-1] // chunk
    xc = x[..., : n_chunks * chunk].reshape(tuple(x.shape[:-1]) + (n_chunks, chunk))
    return torch.sum(xc * xc, dim=-1)


def _chunked_zero_phase(filter_fn, x: torch.Tensor, chunk: int, halo: int) -> torch.Tensor:
    """Apply a zero-phase filter in overlapping time windows of ``chunk +
    2*halo`` samples, clamped inside the record, so every halo sample is
    real neighbouring data and the first and last windows meet the
    record's true edges (where the filter's own odd extension applies).
    Each window keeps its ``chunk`` centre."""
    n = x.shape[-1]
    width = chunk + 2 * halo
    if width >= n:
        return filter_fn(x)
    n_chunks = -(-n // chunk)
    starts = np.clip(np.arange(n_chunks) * chunk - halo, 0, n - width)
    idx = torch.as_tensor(starts[:, None] + np.arange(width)[None, :], device=x.device)
    y = filter_fn(x[..., idx])                              # [..., n_chunks, width]
    offsets = np.arange(n_chunks) * chunk - starts
    crop = np.minimum(offsets[:, None] + np.arange(chunk)[None, :], width - 1)
    crop = torch.as_tensor(crop, device=x.device).expand(tuple(y.shape[:-1]) + (chunk,))
    y = torch.gather(y, -1, crop)
    return y.reshape(tuple(x.shape[:-1]) + (n_chunks * chunk,))[..., :n]


def filtfilt_chunked(b, a, x: torch.Tensor, chunk: int, halo: int | None = None) -> torch.Tensor:
    """``filtfilt`` in halo-overlapped time chunks (default halo ``16 * 3 *
    max(len(a), len(b))``); the record's ends match ``filtfilt``'s."""
    if halo is None:
        halo = 16 * 3 * max(len(np.asarray(a)), len(np.asarray(b)))
    return _chunked_zero_phase(lambda w: filtfilt(b, a, w), x, chunk, halo)


def sosfiltfilt_chunked(sos, x: torch.Tensor, chunk: int, halo: int | None = None) -> torch.Tensor:
    """The SOS variant of :func:`filtfilt_chunked` (default halo ``16 * 3
    * (2 * n_sections + 1)``)."""
    sos = np.asarray(sos)
    if halo is None:
        halo = 16 * 3 * (2 * sos.shape[0] + 1)
    return _chunked_zero_phase(lambda w: sosfiltfilt(sos, w), x, chunk, halo)


def fk_filt_chunked(data: torch.Tensor, chunk: int, tint, fs, xint, dx, c_min, c_max,
                    sigma: float = 40.0) -> torch.Tensor:
    """The f-k speed fan a time chunk (the reference's ``tools.fk_filt``):
    linear detrend a chunk, the Gaussian-smoothed (``sigma=40``) min-max
    normalised fan designed once for the chunk shape, the 2-D FFT filter
    over every chunk at once. A trailing partial chunk is dropped."""
    nx, ns = data.shape
    n_chunks = ns // chunk
    mask = fk_ops.speed_fan_mask((nx, chunk), fs, dx, c_min, c_max, tint=tint, xint=xint,
                                 sigma=sigma)
    xc = data[:, : n_chunks * chunk].reshape(nx, n_chunks, chunk).permute(1, 0, 2)
    out = fk_ops.fk_filter_apply(detrend_linear(xc), mask)
    return out.permute(1, 0, 2).reshape(nx, n_chunks * chunk)
