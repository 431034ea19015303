"""Butterworth bandpass design (host side).

The design half of ``das4whales_tpu.ops.filters``: the zero-phase
``|H(f)|^2`` gain of an SOS Butterworth bandpass, which the matched-filter
design folds into the banded f-k mask (``fused_bandpass=True``). The
staged time-domain bandpass comes with a later slice.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.signal as sp


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
