"""Frequency-wavenumber (f-k) filter: host design, banded apply on cuFFT.

The design (``hybrid_ninf_filter_design``, the flagship mask of the
reference's matched-filter script) is host float64 numpy, evaluated in
closed form on the full ``[k x f]`` grid exactly as in
``das4whales_tpu.ops.fk``. ``banded_mask_half`` symmetrizes it, keeps
the non-negative-frequency half and crops it to its in-band rfft
columns. ``fk_filter_apply_rfft_banded`` applies it with ``torch.fft``:
rfft along time, the channel-axis FFT pair on the in-band columns only,
irfft back.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.signal as sp
import torch

from ..config import ChannelSelection


def fk_axes(trace_shape: Tuple[int, int], selected_channels, dx: float, fs: float):
    """fftshifted frequency [Hz] and wavenumber [1/m] axes of a
    ``[channel x time]`` block."""
    sel = ChannelSelection.from_list(selected_channels)
    nnx, nns = trace_shape
    freq = np.fft.fftshift(np.fft.fftfreq(nns, d=1 / fs))
    knum = np.fft.fftshift(np.fft.fftfreq(nnx, d=sel.step * dx))
    return freq, knum


def _sine_ramp(x, lo, hi):
    """sin(pi/2 * (x - lo) / (hi - lo)) with safe division."""
    denom = np.where(hi == lo, 1.0, hi - lo)
    return np.sin(0.5 * np.pi * (x - lo) / denom)


def _col_range_mask(freq, fpmin, fpmax) -> np.ndarray:
    """Boolean over frequency bins replicating the reference's
    ``range(argmax(freq>=fpmin), argmax(freq>=fpmax))`` column loop bounds."""
    ns = len(freq)
    fmin_idx = int(np.argmax(freq >= fpmin))
    fmax_idx = int(np.argmax(freq >= fpmax))
    idx = np.arange(ns)
    return (idx >= fmin_idx) & (idx < fmax_idx)


def butterworth_bandpass_H(freq, fs, fmin, fmax, order=8) -> np.ndarray:
    """One-sided squared Butterworth magnitude over the fftshifted
    frequency axis: zeros on the negative half, ``|freqz|^2`` on the
    positive half."""
    ns = len(freq)
    b, a = sp.butter(order, [fmin / (fs / 2), fmax / (fs / 2)], "bp")
    H_pos = np.abs(sp.freqz(b, a, worN=ns // 2)[1]) ** 2
    return np.concatenate((np.zeros(ns - ns // 2), H_pos))


def hybrid_ninf_filter_design(
    trace_shape, selected_channels, dx, fs,
    cs_min=1400.0, cp_min=1450.0, cp_max=3400.0, cs_max=3500.0,
    fmin=15.0, fmax=25.0,
) -> np.ndarray:
    """Band-limited bandpass f-k hybrid filter: Butterworth-8 squared
    magnitude along f (positive half), a speed fan with sine ramps from
    ``cs_max -> cp_max`` and ``cp_min -> cs_min``, then the two
    symmetrizations ``M += fliplr(M); M += flipud(M)``."""
    freq, knum = fk_axes(trace_shape, selected_channels, dx, fs)
    H = butterworth_bandpass_H(freq, fs, fmin, fmax, order=8)
    M = np.tile(H, (len(knum), 1))

    in_cols = _col_range_mask(freq, fmin - 14.0, fmax + 14.0)
    K = knum[:, None]
    ks_min = freq / cs_max
    kp_min = freq / cp_max
    ks_max = freq / cs_min
    kp_max = freq / cp_min
    v_up_valid = ks_min != kp_min
    v_do_valid = ks_max != kp_max

    m_up = (K >= ks_min) & (K <= kp_min)
    m_do = (K >= kp_max) & (K <= ks_max)
    pb = (K > kp_min) & (K < kp_max)
    with np.errstate(divide="ignore", invalid="ignore"):
        v_up = _sine_ramp(K, ks_min, ks_min + (kp_min - ks_min))
        v_do = -_sine_ramp(K, ks_max, ks_max + (ks_max - kp_max))
    col = np.where(pb, 1.0, np.where(m_do & v_do_valid, v_do, np.where(m_up & v_up_valid, v_up, 0.0)))
    M = np.where(in_cols[None, :], M * col, M)
    M += np.fliplr(M)
    M += np.flipud(M)
    return M


def symmetrize_mask_fftorder(mask: np.ndarray) -> np.ndarray:
    """fftshifted ``[k x f]`` design mask -> point-reflect-symmetrized full
    mask in fft order on both axes (guarantees a real filter output)."""
    mu = np.fft.ifftshift(np.asarray(mask))
    pr = mu
    for ax in (0, 1):
        pr = np.roll(np.flip(pr, axis=ax), 1, axis=ax)
    return 0.5 * (mu + pr)


def banded_mask_half(mask, tol: float = 1e-6) -> tuple:
    """Symmetrize the fftshifted mask, keep the non-negative-frequency
    half, and crop to the contiguous rfft-bin band outside which every
    column peaks below ``tol * max(mask)``. Returns
    ``(mask_band [C, hi-lo] float32 numpy, lo, hi)``."""
    m = np.asarray(mask)
    nns = m.shape[1]
    half = symmetrize_mask_fftorder(m)[:, : nns // 2 + 1]
    col = np.abs(half).max(axis=0)
    thr = tol * float(col.max()) if col.max() > 0 else 0.0
    nz = np.nonzero(col > thr)[0]
    if nz.size == 0:
        lo, hi = 0, 1
    else:
        lo, hi = int(nz[0]), int(nz[-1]) + 1
    return half[:, lo:hi].astype(np.float32), lo, hi


def fk_filter_apply_rfft_banded(
    trace: torch.Tensor, mask_band: torch.Tensor, lo: int, hi: int
) -> torch.Tensor:
    """Band-limited half-spectrum f-k apply of a ``[..., C, n]`` block (a
    leading axis stacks records): rfft along time, FFT along channels on
    rfft bins ``[lo, hi)`` only, mask, inverse channel FFT, irfft. Bins
    outside the band are zero."""
    nns = trace.shape[-1]
    Xf = torch.fft.rfft(trace, dim=-1)                         # [..., C, F]
    Ys = torch.fft.fft(Xf[..., lo:hi], dim=-2) * mask_band.to(Xf.real.dtype)
    Z = torch.zeros_like(Xf)
    Z[..., lo:hi] = torch.fft.ifft(Ys, dim=-2)
    del Xf, Ys
    return torch.fft.irfft(Z, n=nns, dim=-1).to(trace.dtype)


def compression_report(mask: np.ndarray, itemsize: int = 8, verbose: bool = True) -> dict:
    """Dense against sparse storage of an f-k mask (the reference's
    ``tools.disp_comprate``): the port keeps the mask dense, so this is a
    cost report only."""
    mask = np.asarray(mask)
    nnz = int(np.count_nonzero(mask))
    sparse_gib = nnz * itemsize / 1024**3
    dense_gib = mask.size * itemsize / 1024**3
    ratio = dense_gib / sparse_gib if sparse_gib > 0 else float("inf")
    pct = abs(dense_gib - sparse_gib) * 100 / dense_gib if dense_gib else 0.0
    if verbose:
        print(f"The size of the sparse filter is {sparse_gib:.4f} Gib")
        print(f"The size of the dense filter is {dense_gib:.2f} Gib")
        print(f"The compression ratio is {ratio:.2f} ({pct:.1f} %)")
    return {"sparse_gib": sparse_gib, "dense_gib": dense_gib, "ratio": ratio, "pct": pct}
