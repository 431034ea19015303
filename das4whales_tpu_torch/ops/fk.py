"""Frequency-wavenumber (f-k) filter: host design, apply on cuFFT.

The reference's five designers (``fk_filter_design``,
``hybrid_filter_design``, ``hybrid_ninf_filter_design`` — the flagship
mask of the matched-filter script —, ``hybrid_gs_filter_design`` and
``hybrid_ninf_gs_filter_design``) and the Gaussian speed fan
(``speed_fan_mask``) are host float64 numpy, evaluated in closed form on
the full ``[k x f]`` grid exactly as in ``das4whales_tpu.ops.fk``: the
same arrays, bit for bit. Three appliers run on ``torch.fft``:
``fk_filter_apply`` (the full 2-D FFT round trip, ``.real``),
``fk_filter_apply_rfft`` (rfft in time, the mask's Hermitian part) and
``fk_filter_apply_rfft_banded`` (``banded_mask_half``: the channel-axis
FFT pair on the in-band rfft columns only).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import scipy.signal as sp
import torch
from scipy import ndimage

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


def fk_filter_design(
    trace_shape, selected_channels, dx, fs,
    cs_min=1400.0, cp_min=1450.0, cp_max=3400.0, cs_max=3500.0,
) -> np.ndarray:
    """Speed-fan f-k filter: passband for apparent speeds in ``[cp_min,
    cp_max]``, sine ramps over ``[cs_min, cp_min]`` and ``[cp_max,
    cs_max]``, rows with ``|k| < 0.005`` zeroed."""
    freq, knum = fk_axes(trace_shape, selected_channels, dx, fs)
    K = knum[:, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        speed = np.abs(freq[None, :] / K)

    m = np.ones_like(speed)
    up = (speed >= cs_min) & (speed <= cp_min)
    down = (speed >= cp_max) & (speed <= cs_max)
    with np.errstate(invalid="ignore"):
        m = np.where(up, _sine_ramp(np.where(up, speed, 0.0), cs_min, cp_min), m)
        m = np.where(down, 1.0 - _sine_ramp(np.where(down, speed, 0.0), cp_max, cs_max), m)
    m = np.where(speed >= cs_max, 0.0, m)
    m = np.where(speed < cs_min, 0.0, m)
    m = np.where(np.abs(K) < 0.005, 0.0, m)
    return m


def _bandpass_H_sine(freq, fmin, fmax, df_taper=4.0) -> np.ndarray:
    """Sine-tapered bandpass frequency response."""
    fpmin, fpmax = fmin - df_taper, fmax + df_taper
    H = np.zeros_like(freq)
    rup = (freq >= fpmin) & (freq <= fmin)
    H[rup] = np.sin(0.5 * np.pi * (freq[rup] - fpmin) / (fmin - fpmin))
    H[(freq >= fmin) & (freq <= fmax)] = 1.0
    rdo = (freq >= fmax) & (freq <= fpmax)
    H[rdo] = np.cos(0.5 * np.pi * (freq[rdo] - fmax) / (fmax - fpmax))
    return H


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


def hybrid_filter_design(
    trace_shape, selected_channels, dx, fs,
    cs_min=1400.0, cp_min=1450.0, fmin=15.0, fmax=25.0,
) -> np.ndarray:
    """Infinite-wave-speed bandpass f-k hybrid filter: a sine-tapered
    bandpass along f, times per frequency column a highpass-in-speed fan
    with sine ramps between ``cs_min`` and ``cp_min``, then
    ``M += fliplr(M)``."""
    freq, knum = fk_axes(trace_shape, selected_channels, dx, fs)
    H = _bandpass_H_sine(freq, fmin, fmax, df_taper=4.0)
    M = np.tile(H, (len(knum), 1))

    in_cols = _col_range_mask(freq, fmin - 4.0, fmax + 4.0)
    K = knum[:, None]
    ks = freq / cs_min
    kp = freq / cp_min
    valid = ks != kp

    m1 = (K >= -ks) & (K <= -kp)
    m2 = (K <= ks) & (K >= kp)
    pb = (K < kp) & (K > -kp)
    with np.errstate(divide="ignore", invalid="ignore"):
        v1 = -_sine_ramp(K, -ks, -ks + (kp - ks))
        v2 = _sine_ramp(K, ks, ks + (kp - ks))
    col = np.where(pb, 1.0, np.where(m2 & valid, v2, np.where(m1 & valid, v1, 0.0)))
    M = np.where(in_cols[None, :], M * col, M)
    M += np.fliplr(M)
    return M


def hybrid_gs_filter_design(
    trace_shape, selected_channels, dx, fs,
    cs_min=1400.0, cp_min=1450.0, fmin=15.0, fmax=25.0, sigma=20.0,
) -> np.ndarray:
    """Infinite-wave-speed filter with Gaussian-smoothed edges: binary
    passband on ``[fmin, fmax]``, per-column binary speed passband
    ``|k| < f/cp_min``, ``fliplr`` symmetrisation, then a Gaussian
    smooth of width ``sigma``."""
    freq, knum = fk_axes(trace_shape, selected_channels, dx, fs)
    H = ((freq >= fmin) & (freq <= fmax)).astype(float)
    M = np.tile(H, (len(knum), 1))

    in_cols = _col_range_mask(freq, fmin - 4.0, fmax + 4.0)
    K = knum[:, None]
    kp = freq / cp_min
    col = ((K < kp) & (K > -kp)).astype(float)
    M = np.where(in_cols[None, :], M * col, M)
    M += np.fliplr(M)
    M = ndimage.gaussian_filter(M, sigma)
    return M


def hybrid_ninf_gs_filter_design(
    trace_shape, selected_channels, dx, fs,
    cs_min=1400.0, cp_min=1450.0, cp_max=3400.0, cs_max=3500.0,
    fmin=15.0, fmax=25.0, sigma=20.0,
) -> np.ndarray:
    """Band-limited filter with Gaussian-smoothed edges: binary passband
    in f, per-column binary annulus ``-f/cp_min < k < -f/cp_max``, the
    Gaussian smooth BEFORE the ``fliplr``/``flipud`` symmetrisations (the
    reference's order)."""
    freq, knum = fk_axes(trace_shape, selected_channels, dx, fs)
    H = ((freq >= fmin) & (freq <= fmax)).astype(float)
    M = np.tile(H, (len(knum), 1))

    in_cols = _col_range_mask(freq, fmin - 4.0, fmax + 4.0)
    K = knum[:, None]
    kp_min = freq / cp_min
    kp_max = freq / cp_max
    col = ((K > -kp_min) & (K < -kp_max)).astype(float)
    M = np.where(in_cols[None, :], M * col, M)
    M = ndimage.gaussian_filter(M, sigma)
    M += np.fliplr(M)
    M += np.flipud(M)
    return M


def speed_fan_mask(
    trace_shape, fs, dx, c_min, c_max, tint=1.0, xint=1.0, sigma=20.0,
) -> np.ndarray:
    """Gaussian-smoothed binary speed fan ``c_min < |f/k| < c_max``,
    min-max normalised to [0, 1] (the mask of the reference's
    ``dsp.fk_filt``; its chunked variant uses ``sigma=40``)."""
    nx, ns = trace_shape
    f = np.fft.fftshift(np.fft.fftfreq(ns, d=tint / fs))
    k = np.fft.fftshift(np.fft.fftfreq(nx, d=xint * dx))
    ff, kk = np.meshgrid(f, k)
    g = 1.0 * ((ff < kk * c_min) & (ff < -kk * c_min))
    g2 = 1.0 * ((ff < kk * c_max) & (ff < -kk * c_max))
    g = g + np.fliplr(g)
    g = g - (g2 + np.fliplr(g2))
    g = ndimage.gaussian_filter(g, sigma)
    g = (g - g.min()) / (g.max() - g.min())
    return g


def _mask_on(mask, trace: torch.Tensor) -> torch.Tensor:
    """A host or device mask as a tensor on ``trace``'s device."""
    if isinstance(mask, torch.Tensor):
        return mask.to(trace.device)
    return torch.as_tensor(np.ascontiguousarray(mask), device=trace.device)


def fk_filter_apply(trace: torch.Tensor, mask) -> torch.Tensor:
    """Apply an fftshifted f-k mask over the last two axes:
    ``real(ifft2(ifftshift(fftshift(fft2(x)) * M)))``, in ``trace``'s
    dtype (leading axes stack blocks)."""
    dims = (-2, -1)
    fk = torch.fft.fftshift(torch.fft.fft2(trace), dim=dims)
    fk = fk * _mask_on(mask, trace).to(fk.real.dtype)
    return torch.fft.ifft2(torch.fft.ifftshift(fk, dim=dims)).real.to(trace.dtype)


def _point_reflect(m: torch.Tensor) -> torch.Tensor:
    """``m[(-i) % N, (-j) % M]``: the spectral point reflection in fft
    order."""
    for ax in (0, 1):
        m = torch.roll(torch.flip(m, (ax,)), 1, dims=ax)
    return m


def fk_filter_apply_rfft(trace: torch.Tensor, mask) -> torch.Tensor:
    """Half-spectrum f-k apply of a ``[C, n]`` block, equal to
    :func:`fk_filter_apply`: the mask's Hermitian part ``(M(k, f) +
    M(-k, -f)) / 2`` on the rfft bins, rfft in time, FFT in channel."""
    nns = trace.shape[-1]
    mu = torch.fft.ifftshift(_mask_on(mask, trace), dim=(0, 1)).to(trace.dtype)
    msym = 0.5 * (mu + _point_reflect(mu))
    mask_half = msym[:, : nns // 2 + 1]
    spec = torch.fft.fft(torch.fft.rfft(trace, dim=1), dim=0)
    spec = spec * mask_half.to(spec.real.dtype)
    out = torch.fft.irfft(torch.fft.ifft(spec, dim=0), n=nns, dim=1)
    return out.real.to(trace.dtype)


def fk_filt(data: torch.Tensor, tint, fs, xint, dx, c_min, c_max,
            sigma: float = 20.0) -> torch.Tensor:
    """Design the Gaussian speed fan for ``data``'s shape and apply it
    (the reference's ``dsp.fk_filt``)."""
    mask = speed_fan_mask(tuple(data.shape[-2:]), fs, dx, c_min, c_max, tint=tint,
                          xint=xint, sigma=sigma)
    return fk_filter_apply(data, mask)


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
