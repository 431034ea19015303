"""Spectral transforms on ``torch.fft``: the Hann window, the analytic
signal and the Hilbert envelope (the port's copy of the matched-filter
half of ``das4whales_tpu.ops.spectral``)."""

from __future__ import annotations

import math

import torch


def hann_window(n: int, *, periodic: bool = False, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """Hann window: ``periodic=False`` matches ``numpy.hanning``,
    ``periodic=True`` librosa's STFT convention."""
    if n == 1:
        return torch.ones(1, dtype=dtype, device=device)
    denom = n if periodic else n - 1
    k = torch.arange(n, dtype=dtype, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * k / denom)


def analytic_signal(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Analytic signal of real ``x`` (``scipy.signal.hilbert``): rfft, the
    strictly interior positive bins doubled (DC and even-n Nyquist kept),
    zero-extended to the full length, complex ifft."""
    n = x.shape[dim]
    spec = torch.fft.rfft(x, dim=dim)
    nf = spec.shape[dim]
    h = torch.ones(nf, dtype=x.dtype, device=x.device)
    h[1 : (n + 1) // 2] = 2.0
    shape = [1] * x.ndim
    shape[dim] = nf
    spec = spec * h.reshape(shape)
    pad_shape = list(x.shape)
    pad_shape[dim] = n - nf
    full = torch.cat([spec, spec.new_zeros(pad_shape)], dim=dim)
    del spec
    return torch.fft.ifft(full, dim=dim)


def magnitude_sqrt(z: torch.Tensor) -> torch.Tensor:
    """``sqrt(re*re + im*im)`` of a complex tensor, each operation rounded
    on its own — never ``abs`` of the complex tensor, which rounds as a
    scaled hypot. The pick kernel computes the same three roundings."""
    re, im = z.real, z.imag
    return torch.sqrt(re * re + im * im)


def envelope_sqrt(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Hilbert envelope of real ``x`` as the explicit ``sqrt(re² + im²)``."""
    return magnitude_sqrt(analytic_signal(x, dim=dim))
