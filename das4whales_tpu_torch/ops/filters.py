"""Butterworth filters: host design, the exact IIR recurrence and the
FFT zero-phase apply (the port's copy of ``das4whales_tpu.ops.filters``).

* **Design** stays on the host (scipy ``butter``): the zero-phase
  ``|H(f)|^2`` gain of an SOS Butterworth bandpass, which the
  matched-filter design folds into the banded f-k mask
  (``fused_bandpass=True``) or applies as its own staged pass
  (:func:`fft_zero_phase_apply`); the same gain on the full fftshifted
  frequency grid (:func:`butter_zero_phase_gain_full`); and its
  truncated symmetric FIR (:func:`butter_zero_phase_fir`).
* **exact** — :func:`lfilter` / :func:`sosfilt` are the transposed
  direct-form II recurrence as a Python loop over time, each step one
  vector operation over every leading (channel) axis, in the input's
  dtype; :func:`filtfilt` / :func:`sosfiltfilt` wrap them in scipy's odd
  extension and ``zi`` initialisation. Run them in float64, as scipy
  does: the order-16 transfer function of ``bp_filt(mode="exact")`` is
  not stable in float32. On the card each step is a few launches over
  the channels, so the serial length T, not the channel count, sets the
  wall.
* **fft** — :func:`fft_zero_phase`: one rfft round trip times
  ``|H(f)|^2`` (``filtfilt``'s steady-state response) with the same odd
  extension at the edges.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import scipy.signal as sp
import torch


def butterworth_filter(filterspec, fs: float) -> np.ndarray:
    """Butterworth SOS design from ``(order, critical_freq [Hz], btype)``
    (the reference's ``dsp.butterworth_filter``)."""
    order, critical_freq, btype = filterspec
    wn = np.asarray(critical_freq) / (fs / 2)
    return sp.butter(order, wn, btype=btype, output="sos")


def butter_bandpass_ba(order: int, fmin: float, fmax: float, fs: float) -> Tuple[np.ndarray, np.ndarray]:
    """``(b, a)`` coefficients of the reference's bandpass."""
    return sp.butter(order, [fmin / (fs / 2), fmax / (fs / 2)], "bp")


def butter_zero_phase_gain(
    nfft: int, fs: float, band: Tuple[float, float], order: int = 8
) -> np.ndarray:
    """Zero-phase ``|H(f)|^2`` rFFT gain of a Butterworth bandpass for an
    ``nfft``-sample window (float32)."""
    sos = sp.butter(order, [band[0] / (fs / 2), band[1] / (fs / 2)], "bp", output="sos")
    return zero_phase_gain(np.fft.rfftfreq(nfft), sos).astype(np.float32)


def butter_zero_phase_gain_full(nns: int, fs: float, band, order: int = 8) -> np.ndarray:
    """Zero-phase ``|H(f)|^2`` Butterworth gain on the fftshifted FULL
    frequency grid of an ``nns``-sample window (float32). It is symmetric
    in f, so folding it into an fftshifted f-k mask before the Hermitian
    symmetrisation is exact (the long record's fused bandpass)."""
    sos = sp.butter(order, [band[0] / (fs / 2), band[1] / (fs / 2)], "bp", output="sos")
    freqs_cps = np.abs(np.fft.fftshift(np.fft.fftfreq(nns)))
    return zero_phase_gain(freqs_cps, sos).astype(np.float32)


def butter_zero_phase_fir(fs: float, band: Tuple[float, float], order: int = 8, *,
                          tol: float = 1e-7, max_half: int = 512,
                          design_n: int = 8192) -> Tuple[np.ndarray, int]:
    """Memoised symmetric zero-phase FIR truncation of the Butterworth
    ``|H(f)|^2`` impulse response: ``(h [2L+1] float32, L)``, read-only
    (:func:`_butter_zero_phase_fir_design`)."""
    return _butter_zero_phase_fir_design(
        float(fs), (float(band[0]), float(band[1])), int(order),
        tol=float(tol), max_half=int(max_half), design_n=int(design_n),
    )


@functools.lru_cache(maxsize=32)
def _butter_zero_phase_fir_design(fs: float, band: Tuple[float, float], order: int = 8, *,
                                  tol: float = 1e-7, max_half: int = 512,
                                  design_n: int = 8192) -> Tuple[np.ndarray, int]:
    """The gain sampled on a ``design_n``-point float64 grid,
    inverse-transformed, centred and truncated to the smallest half-length
    ``L`` whose discarded tail holds at most ``tol`` of the impulse
    energy (at most ``max_half``), then made exactly even."""
    sos = sp.butter(order, [band[0] / (fs / 2), band[1] / (fs / 2)], "bp", output="sos")
    n = int(design_n)
    gain = zero_phase_gain(np.fft.rfftfreq(n), sos)
    h = np.fft.fftshift(np.fft.irfft(gain, n=n))
    c = n // 2
    total = float(np.sum(h * h))
    L = int(max_half)
    for cand in range(1, int(max_half) + 1):
        seg = h[c - cand: c + cand + 1]
        if total - float(np.sum(seg * seg)) <= tol * total:
            L = cand
            break
    out = h[c - L: c + L + 1]
    out = 0.5 * (out + out[::-1])
    out = out.astype(np.float32)
    out.flags.writeable = False    # the cache shares this array
    return out, int(L)


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


# ---------------------------------------------------------------------------
# The exact IIR path: a recurrence over time, vectorised over every
# leading axis
# ---------------------------------------------------------------------------

def _as_tensor_like(v, x: torch.Tensor) -> torch.Tensor:
    """Host coefficients (or a tensor) as a tensor of ``x``'s dtype on its
    device; scipy may hand back a view with negative strides, which torch
    refuses."""
    if isinstance(v, torch.Tensor):
        return v.to(device=x.device, dtype=x.dtype)
    return torch.as_tensor(np.array(v), dtype=x.dtype, device=x.device)


def lfilter(b, a, x: torch.Tensor, zi: torch.Tensor | None = None):
    """Transposed direct-form II IIR filter along the last axis
    (``scipy.signal.lfilter``), in ``x``'s dtype. Returns ``(y, zf)``;
    ``zi`` broadcasts to ``x.shape[:-1] + (order,)``."""
    b = _as_tensor_like(b, x)
    a = _as_tensor_like(a, x)
    b = b / a[0]
    a = a / a[0]
    order = max(b.shape[0], a.shape[0]) - 1
    bp = torch.zeros(order + 1, dtype=x.dtype, device=x.device)
    ap = torch.zeros(order + 1, dtype=x.dtype, device=x.device)
    bp[: b.shape[0]] = b
    ap[: a.shape[0]] = a
    batch_shape = tuple(x.shape[:-1])
    if zi is None:
        z = x.new_zeros(batch_shape + (order,))
    else:
        z = _as_tensor_like(zi, x).expand(batch_shape + (order,)).clone()
    b0, b_rest, a_rest = bp[0], bp[1:], ap[1:]
    ys = []
    for xn in x.movedim(-1, 0):
        yn = b0 * xn + z[..., 0]
        # z_i <- b_{i+1} x + z_{i+1} - a_{i+1} y
        znext = b_rest * xn[..., None] - a_rest * yn[..., None]
        znext[..., :-1] += z[..., 1:]
        z = znext
        ys.append(yn)
    return torch.stack(ys, dim=-1), z


def filtfilt(b, a, x: torch.Tensor, padlen: int | None = None) -> torch.Tensor:
    """Zero-phase forward-backward IIR filter with scipy ``filtfilt``'s
    edges: odd extension by ``padlen`` (default ``3 * max(len(a),
    len(b))``) and ``lfilter_zi`` scaled by each pass's first sample."""
    b = np.asarray(b)
    a = np.asarray(a)
    if padlen is None:
        padlen = 3 * max(len(a), len(b))
    if padlen >= x.shape[-1]:
        raise ValueError("padlen must be less than the signal length")
    zi = _as_tensor_like(sp.lfilter_zi(np.asarray(b, float), np.asarray(a, float)), x)
    ext = odd_ext(x, padlen)
    y, _ = lfilter(b, a, ext, zi=zi * ext[..., :1])
    y = torch.flip(y, (-1,))
    y, _ = lfilter(b, a, y, zi=zi * y[..., :1])
    y = torch.flip(y, (-1,))
    return y[..., padlen:-padlen]


def sosfilt(sos, x: torch.Tensor, zi: torch.Tensor | None = None):
    """Cascaded second-order sections along the last axis
    (``scipy.signal.sosfilt``), every section once a time step, in
    ``x``'s dtype. Returns ``(y, zf)``; ``zi`` broadcasts to
    ``x.shape[:-1] + (n_sections, 2)``."""
    sos_np = np.atleast_2d(np.asarray(sos))
    coef = [tuple(_as_tensor_like(c, x) for c in sec) for sec in sos_np]
    n_sections = len(coef)
    batch_shape = tuple(x.shape[:-1])
    if zi is None:
        z0 = x.new_zeros(batch_shape + (n_sections, 2))
    else:
        z0 = _as_tensor_like(zi, x).expand(batch_shape + (n_sections, 2))
    z1 = [z0[..., k, 0].clone() for k in range(n_sections)]
    z2 = [z0[..., k, 1].clone() for k in range(n_sections)]
    ys = []
    for xn in x.movedim(-1, 0):
        xcur = xn
        for k, (b0, b1, b2, _, a1, a2) in enumerate(coef):
            yn = b0 * xcur + z1[k]
            z1[k] = b1 * xcur - a1 * yn + z2[k]
            z2[k] = b2 * xcur - a2 * yn
            xcur = yn
        ys.append(xcur)
    zf = torch.stack([torch.stack([z1[k], z2[k]], dim=-1) for k in range(n_sections)], dim=-2)
    return torch.stack(ys, dim=-1), zf


def sosfiltfilt(sos, x: torch.Tensor, padlen: int | None = None) -> torch.Tensor:
    """Zero-phase SOS filter with scipy ``sosfiltfilt``'s edges (its
    default ``padlen`` and ``sosfilt_zi`` scaled by each pass's first
    sample)."""
    sos_np = np.atleast_2d(np.asarray(sos))
    if padlen is None:
        ntaps = 2 * sos_np.shape[0] + 1
        padlen = 3 * (ntaps - min((sos_np[:, 2] == 0).sum(), (sos_np[:, 5] == 0).sum()))
    padlen = int(padlen)
    if padlen >= x.shape[-1]:
        raise ValueError("padlen must be less than the signal length")
    zi = _as_tensor_like(sp.sosfilt_zi(sos_np), x)       # [n_sections, 2]
    ext = odd_ext(x, padlen)
    y, _ = sosfilt(sos_np, ext, zi=zi * ext[..., 0][..., None, None])
    y = torch.flip(y, (-1,))
    y, _ = sosfilt(sos_np, y, zi=zi * y[..., 0][..., None, None])
    y = torch.flip(y, (-1,))
    return y[..., padlen:-padlen]


# ---------------------------------------------------------------------------
# The FFT zero-phase path
# ---------------------------------------------------------------------------

def fft_zero_phase(x: torch.Tensor, sos: np.ndarray, padlen: int = 0) -> torch.Tensor:
    """``|H(f)|^2`` of an SOS filter with zero phase in one rfft round
    trip; ``padlen > 0`` adds ``filtfilt``'s odd extension at the edges."""
    n = x.shape[-1] + 2 * padlen
    gain = zero_phase_gain(np.fft.rfftfreq(n), sos)
    return fft_zero_phase_apply(x, torch.as_tensor(gain, device=x.device), padlen)


def bp_filt(data: torch.Tensor, fs: float, fmin: float, fmax: float, *,
            mode: str = "fft") -> torch.Tensor:
    """Butterworth-8 zero-phase bandpass along time (the reference's
    ``dsp.bp_filt``). ``mode="exact"``: ``filtfilt`` of the ``(b, a)``
    design, as the reference runs it (use float64); ``mode="fft"``: the
    same ``|H(f)|^2`` in one rfft round trip with the SOS design's
    ``sosfiltfilt`` padlen."""
    if mode == "exact":
        b, a = butter_bandpass_ba(8, fmin, fmax, fs)
        return filtfilt(b, a, data)
    if mode != "fft":
        raise ValueError(f"unknown mode {mode!r}; expected 'fft' or 'exact'")
    sos = sp.butter(8, [fmin / (fs / 2), fmax / (fs / 2)], "bp", output="sos")
    padlen = 3 * (2 * len(sos) + 1)
    return fft_zero_phase(data, sos, padlen=padlen)
