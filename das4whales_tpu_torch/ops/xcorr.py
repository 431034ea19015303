"""Cross-correlation and FFT convolution (``torch.fft``).

The port's copy of ``das4whales_tpu.ops.xcorr``: the reference's
positive-lag correlations (``shift_xcorr``, ``shift_nxcorr``,
``compute_cross_correlogram``), the same-mode FFT convolutions of the
spectrogram-correlation family, and the true-length-template corrected
correlation of the matched filter. The
reference pads each template to the record length and correlates at
``nfft = next_fast_len(2n - 1)``; the same correlogram is recovered
exactly from the true-length template,

    corr[k] = (sum_j x[k+j] y_true[j] - mu * suffix_sum(x)[k]) / s,

at ``nfft = next_fast_len(n + m - 1)`` (``mu`` the padded template's
mean, ``s`` its peak magnitude) — half the FFT length.
"""

from __future__ import annotations

import numpy as np
import torch


def next_fast_len(n: int) -> int:
    """Smallest 5-smooth (2^a 3^b 5^c) integer >= n."""
    if n <= 6:
        return max(n, 1)
    best = 1 << (n - 1).bit_length()
    p5 = 1
    while p5 < best:
        p35 = p5
        while p35 < best:
            q = -(-n // p35)
            p2 = 1 << max(q - 1, 0).bit_length()
            cand = p2 * p35
            if cand == n:
                return n
            if cand < best:
                best = cand
            p35 *= 3
        p5 *= 5
    return best


def _xcorr_full_len(n: int, m: int) -> int:
    """FFT length for a linear (non-circular) correlation of n and m."""
    return next_fast_len(n + m - 1)


def shift_xcorr(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Positive-lag full cross-correlation of equal-length signals along
    the last axis: ``correlate(x, y, 'full')[len(x)-1:]`` (the
    reference's ``detect.shift_xcorr``)."""
    n, m = x.shape[-1], y.shape[-1]
    nfft = _xcorr_full_len(n, m)
    X = torch.fft.rfft(x, nfft)
    Y = torch.fft.rfft(y, nfft)
    return torch.fft.irfft(X * torch.conj(Y), nfft)[..., :n]


def shift_nxcorr(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """:func:`shift_xcorr` normalised by ``std(x) * std(y) * len(x)``
    (population standard deviations over every element, as ``jnp.std``;
    the reference's ``detect.shift_nxcorr``)."""
    corr = shift_xcorr(x, y)
    return corr / (torch.std(x, correction=0) * torch.std(y, correction=0) * x.shape[-1])


def _demean_peak_normalize(x: torch.Tensor, guard_zero: bool = False) -> torch.Tensor:
    """Demean each row, then divide by the peak magnitude of the RAW row;
    ``guard_zero`` makes an all-zero row correlate to 0 instead of NaN."""
    mx = x.abs().amax(dim=-1, keepdim=True)
    if guard_zero:
        mx = torch.clamp_min(mx, torch.finfo(x.dtype).tiny)
    return (x - x.mean(dim=-1, keepdim=True)) / mx


def normalized_block_and_suffix(data: torch.Tensor):
    """Normalized block ``xn`` and its suffix sums
    ``suffix[..., k] = sum_{i>=k} xn[..., i]``."""
    xn = _demean_peak_normalize(data, guard_zero=True)
    suffix = torch.flip(torch.cumsum(torch.flip(xn, (-1,)), dim=-1), (-1,))
    return xn, suffix


def corrected_from_raw(raw, suffix, mu, scale, dtype):
    """Subtract the padded-template mean term and rescale: ``raw [nT, ..., n]``
    is the positive-lag correlation against the true-length templates."""
    nd = raw.ndim - 1
    mu_b = mu.reshape((mu.shape[0],) + (1,) * nd)
    scale_b = scale.reshape((scale.shape[0],) + (1,) * nd)
    return ((raw - mu_b * suffix[None, ...]) / scale_b).to(dtype)


def compute_cross_correlogram(data: torch.Tensor, template: torch.Tensor) -> torch.Tensor:
    """Reference-normalised correlogram of every channel of ``data [...,
    n]`` against one ``template`` (both demeaned and peak-normalised),
    positive lags, one batched rfft product (the reference's
    ``detect.compute_cross_correlogram``)."""
    norm_data = _demean_peak_normalize(data)
    t = _demean_peak_normalize(template)
    n, m = data.shape[-1], t.shape[-1]
    nfft = _xcorr_full_len(n, m)
    X = torch.fft.rfft(norm_data, nfft, dim=-1)
    Y = torch.fft.rfft(t, nfft)
    return torch.fft.irfft(X * torch.conj(Y), nfft, dim=-1)[..., :n].to(data.dtype)


def compute_cross_correlograms_multi(data: torch.Tensor, templates: torch.Tensor) -> torch.Tensor:
    """Reference-normalized correlograms of ``data [..., n]`` against
    trace-length templates ``[nT, n]`` (both demeaned and peak-normalized),
    one forward rfft of the data shared by every template, at
    ``nfft = next_fast_len(2n - 1)``: returns ``[nT, ..., n]``. The
    full-artifact route's untiled correlate."""
    xn = _demean_peak_normalize(data)
    t = _demean_peak_normalize(templates)
    n, m = data.shape[-1], t.shape[-1]
    nfft = _xcorr_full_len(n, m)
    X = torch.fft.rfft(xn, nfft, dim=-1)
    Y = torch.fft.rfft(t, nfft, dim=-1)
    Yb = torch.conj(Y).reshape((Y.shape[0],) + (1,) * (X.ndim - 1) + (Y.shape[-1],))
    return torch.fft.irfft(X[None, ...] * Yb, nfft, dim=-1)[..., :n].to(data.dtype)


def padded_template_stats(templates_padded):
    """Decompose a trace-length zero-padded template stack into
    ``(templates_true [nT, m], mu [nT], scale [nT])`` host numpy: the
    stack cropped to the longest nonzero support, each padded template's
    mean and its own peak magnitude."""
    t = np.atleast_2d(np.asarray(templates_padded))
    m = 1
    for row in np.abs(t) > 0:
        idx = np.nonzero(row)[0]
        if idx.size:
            m = max(m, int(idx[-1]) + 1)
    mu = t.mean(axis=-1)
    scale = np.max(np.abs(t), axis=-1)
    return t[:, :m].copy(), mu.astype(t.dtype), scale.astype(t.dtype)


def compute_cross_correlograms_corrected(
    data: torch.Tensor, templates_true: torch.Tensor, mu: torch.Tensor,
    scale: torch.Tensor,
) -> torch.Tensor:
    """Reference-normalized positive-lag correlograms of ``data [..., n]``
    against every true-length template: returns ``[nT, ..., n]``."""
    n, m = data.shape[-1], templates_true.shape[-1]
    nfft = _xcorr_full_len(n, m)
    xn, suffix = normalized_block_and_suffix(data)
    X = torch.fft.rfft(xn, nfft, dim=-1)
    Y = torch.fft.rfft(templates_true, nfft, dim=-1)
    Yb = torch.conj(Y).reshape((Y.shape[0],) + (1,) * (xn.ndim - 1) + (Y.shape[-1],))
    raw = torch.fft.irfft(X[None, ...] * Yb, nfft, dim=-1)[..., :n]
    return corrected_from_raw(raw, suffix, mu, scale, data.dtype)


def fftconvolve_same_time(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """FFT convolution along the last (time) axis, ``mode='same'``,
    batched over leading axes (``scipy.signal.fftconvolve(..., mode='same',
    axes=-1)``)."""
    n, m = x.shape[-1], kernel.shape[-1]
    nfft = _xcorr_full_len(n, m)
    X = torch.fft.rfft(x, nfft, dim=-1)
    K = torch.fft.rfft(kernel, nfft, dim=-1)
    full = torch.fft.irfft(X * K, nfft, dim=-1)[..., : n + m - 1]
    start = (m - 1) // 2
    return full[..., start : start + n]


def fftconvolve2d_same(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """2-D FFT convolution over the last two axes, ``mode='same'``,
    batched over leading axes (``scipy.signal.fftconvolve(image, kernel,
    mode='same')``)."""
    n1, n2 = x.shape[-2], x.shape[-1]
    m1, m2 = kernel.shape[-2], kernel.shape[-1]
    s = (n1 + m1 - 1, n2 + m2 - 1)
    X = torch.fft.rfft2(x, s)
    K = torch.fft.rfft2(kernel, s)
    full = torch.fft.irfft2(X * K, s)
    a1, a2 = (m1 - 1) // 2, (m2 - 1) // 2
    return full[..., a1 : a1 + n1, a2 : a2 + n2]
