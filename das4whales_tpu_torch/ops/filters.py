"""Butterworth bandpass: host design and the FFT zero-phase apply.

The port's copy of what the detectors use of ``das4whales_tpu.ops.filters``:
the zero-phase ``|H(f)|^2`` gain of an SOS Butterworth bandpass, which the
matched-filter design folds into the banded f-k mask
(``fused_bandpass=True``) or applies as its own staged pass
(:func:`fft_zero_phase_apply`, ``fused_bandpass=False``): scipy's odd
extension at both ends, one rfft round trip times the gain, the crop.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.signal as sp
import torch


def butter_zero_phase_gain(
    nfft: int, fs: float, band: Tuple[float, float], order: int = 8
) -> np.ndarray:
    """Zero-phase ``|H(f)|^2`` rFFT gain of a Butterworth bandpass for an
    ``nfft``-sample window (float32)."""
    sos = sp.butter(order, [band[0] / (fs / 2), band[1] / (fs / 2)], "bp", output="sos")
    return zero_phase_gain(np.fft.rfftfreq(nfft), sos).astype(np.float32)


def zero_phase_gain(freqs: np.ndarray, sos: np.ndarray) -> np.ndarray:
    """``|H(f)|^2`` of an SOS filter at ``freqs`` [cycles/sample],
    computed per section for stability."""
    w = np.asarray(freqs) * 2 * np.pi
    z = np.exp(-1j * w)
    h = np.ones_like(z, dtype=complex)
    for sec in np.atleast_2d(sos):
        b0, b1, b2, a0, a1, a2 = sec
        h *= (b0 + b1 * z + b2 * z**2) / (a0 + a1 * z + a2 * z**2)
    return np.abs(h) ** 2


def odd_ext(x: torch.Tensor, n: int) -> torch.Tensor:
    """Odd extension by ``n`` samples at both ends of the last axis
    (scipy ``odd_ext``): ``2*x[0] - x[n:0:-1]`` before,
    ``2*x[-1] - x[-2:-(n+2):-1]`` after."""
    T = x.shape[-1]
    left = 2 * x[..., :1] - torch.flip(x[..., 1 : n + 1], (-1,))
    right = 2 * x[..., -1:] - torch.flip(x[..., T - n - 1 : T - 1], (-1,))
    return torch.cat([left, x, right], dim=-1)


def fft_zero_phase_apply(x: torch.Tensor, gain: torch.Tensor, padlen: int) -> torch.Tensor:
    """Apply a zero-phase rFFT ``gain`` along time: odd extension by
    ``padlen`` (none when 0), rfft, times ``gain`` (the rFFT bins of the
    extended length), irfft, crop back to ``x``'s length and dtype."""
    ext = odd_ext(x, padlen) if padlen > 0 else x
    n = ext.shape[-1]
    X = torch.fft.rfft(ext, dim=-1)
    y = torch.fft.irfft(X * gain.to(X.real.dtype), n=n, dim=-1)
    if padlen > 0:
        y = y[..., padlen:-padlen]
    return y.to(x.dtype)
