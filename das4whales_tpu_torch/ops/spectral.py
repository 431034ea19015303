"""Spectral transforms on ``torch.fft``: the Hann and Tukey windows, the
analytic signal, the Hilbert envelope, the envelope SNR, the STFT
magnitude with its engine switch, and the reference's ``dsp.py`` helpers
(``fx_transform``, ``spectrogram``, ``instant_freq``, ``taper_data``) —
the port's copy of ``das4whales_tpu.ops.spectral``. ``unwrap`` is
``jnp.unwrap``/``np.unwrap``, which torch lacks."""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(n: int, *, periodic: bool = False, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """Hann window: ``periodic=False`` matches ``numpy.hanning``,
    ``periodic=True`` librosa's STFT convention."""
    if n == 1:
        return torch.ones(1, dtype=dtype, device=device)
    denom = n if periodic else n - 1
    k = torch.arange(n, dtype=dtype, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * k / denom)


def tukey_window(n: int, alpha: float = 0.03, dtype=torch.float32,
                 device=None) -> torch.Tensor:
    """Tukey (tapered cosine) window, ``scipy.signal.windows.tukey``
    (the reference's data taper), evaluated in ``dtype``."""
    if alpha <= 0:
        return torch.ones(n, dtype=dtype, device=device)
    if alpha >= 1:
        return hann_window(n, dtype=dtype, device=device)
    k = torch.arange(n, dtype=dtype, device=device)
    width = alpha * (n - 1) / 2.0
    rising = 0.5 * (1 + torch.cos(math.pi * (k / width - 1.0)))
    falling = 0.5 * (1 + torch.cos(math.pi * ((k - (n - 1)) / width + 1.0)))
    one = torch.ones((), dtype=dtype, device=device)
    return torch.where(k < width, rising, torch.where(k > (n - 1) - width, falling, one))


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


def envelope(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Hilbert envelope as ``abs`` of the complex analytic signal (the
    reference's form; :func:`envelope_sqrt` is the detectors')."""
    return torch.abs(analytic_signal(x, dim=dim))


def snr_tr_array(trace: torch.Tensor, env: bool = False) -> torch.Tensor:
    """Per-sample SNR in dB against each row's standard deviation
    (population, ddof 0, as ``jnp.std``): ``10 log10(num / std^2)`` with
    ``num`` the squared samples, or with ``env`` the squared ``abs`` of the
    analytic signal (``abs`` first, then the square, as the reference)."""
    std = torch.std(trace, dim=-1, keepdim=True, correction=0)
    num = torch.abs(analytic_signal(trace, dim=-1)) ** 2 if env else trace ** 2
    return 10.0 * torch.log10(num / std ** 2)


def stft(x: torch.Tensor, n_fft: int, hop: int, *, window: str = "hann",
         center: bool = True) -> torch.Tensor:
    """Complex short-time Fourier transform with librosa's conventions:
    periodic Hann window, centred frames with zero padding, output
    ``[..., n_fft//2 + 1, n_frames]`` with ``n_frames = 1 + n//hop``
    (``1 + (n - n_fft)//hop`` without centring). The frames are an
    ``unfold`` view; one batched rfft transforms them all."""
    if window == "hann":
        win = hann_window(n_fft, periodic=True, dtype=x.dtype, device=x.device)
    elif window == "ones":
        win = torch.ones(n_fft, dtype=x.dtype, device=x.device)
    else:
        raise ValueError(f"unknown window {window!r}")
    n = x.shape[-1]
    if not center and n < n_fft:
        raise ValueError(f"center=False needs at least n_fft={n_fft} samples, got {n}")
    n_frames = 1 + (n // hop if center else (n - n_fft) // hop)
    if center:
        x = F.pad(x, (n_fft // 2, n_fft // 2))
    need = (n_frames - 1) * hop + n_fft
    if x.shape[-1] < need:
        # an odd n_fft leaves the last frame one sample short: it reads zero
        x = F.pad(x, (0, need - x.shape[-1]))
    frames = x.unfold(-1, n_fft, hop)[..., :n_frames, :] * win   # [..., n_frames, n_fft]
    return torch.fft.rfft(frames, dim=-1).transpose(-1, -2)


#: STFT-magnitude engines of the port. ``"rfft"`` is the batched-FFT
#: path (:func:`stft`); ``"matmul"`` the framed windowed-DFT product
#: (:func:`stft_magnitude_matmul`); ``"fused"`` the CUDA kernel of
#: ``ops.fused_stft`` (the counterpart of the JAX package's ``"pallas"``),
#: its plain version on a CPU tensor.
STFT_ENGINES = ("rfft", "matmul", "fused")


def check_stft_engine(engine: str) -> str:
    """``engine`` when it is one of :data:`STFT_ENGINES`, else
    ``ValueError``. The functions here take a concrete engine only: the
    default, ``DAS4WHALES_STFT_ENGINE`` and ``"auto"`` are resolved in one
    place, ``ops.mxu.resolve_stft_engine_ab``."""
    if engine not in STFT_ENGINES:
        raise ValueError(f"unknown stft engine {engine!r}; expected one of {STFT_ENGINES} "
                         "(resolve 'auto' with ops.mxu.resolve_stft_engine_ab)")
    return engine


def resolve_stft_engine(engine: str = "auto", device=None) -> str:
    """A concrete STFT engine without the shape: ``engine`` when concrete,
    else ``DAS4WHALES_STFT_ENGINE`` when set and concrete, else the
    device's kernel route: ``"fused"`` on a CUDA device (None: the card),
    ``"rfft"`` elsewhere (the JAX package: ``"pallas"`` on a TPU, else
    ``"rfft"``). The per-shape A/B router is
    ``ops.mxu.resolve_stft_engine_ab``; forced engines and the env
    override resolve identically through both."""
    import os

    if engine == "auto":
        engine = os.environ.get("DAS4WHALES_STFT_ENGINE", "") or "auto"
    if engine == "auto":
        dev = torch.device("cuda" if device is None else device)
        engine = "fused" if dev.type == "cuda" else "rfft"
    return check_stft_engine(engine)


@functools.lru_cache(maxsize=8)
def _stft_matmul_matrix(nfft: int) -> np.ndarray:
    """The windowed real-DFT matrix ``[nfft, 2F]``, cos | sin halves for
    bins ``0..nfft//2`` with the periodic Hann folded in: ``frames @ M``
    is (re | -im) of ``rfft(frames * win)``. Float64 angle grid, cast to
    float32 once an ``nfft``; read-only (the cache shares it)."""
    k = np.arange(nfft)[:, None]
    f = np.arange(nfft // 2 + 1)[None, :]
    ang = 2.0 * np.pi * k * f / nfft
    win = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(nfft) / nfft)
    out = np.concatenate([np.cos(ang) * win[:, None], np.sin(ang) * win[:, None]],
                         axis=1).astype(np.float32)
    out.flags.writeable = False
    return out


def stft_magnitude_matmul(x: torch.Tensor, nfft: int, hop: int) -> torch.Tensor:
    """``|STFT|`` of ``x [..., T]`` as the framed ``[frames, tap] @ [tap,
    2F]`` product: the framing of :func:`stft` (centred, zero-padded), the
    window and the DFT in one matrix (:func:`_stft_matmul_matrix`), the
    magnitude as ``sqrt(re*re + im*im)``. ``[..., nfft//2 + 1, frames]``,
    equal to ``abs(stft(...))`` up to matmul-against-FFT rounding."""
    n = x.shape[-1]
    n_frames = 1 + n // hop
    xp = F.pad(x, (nfft // 2, nfft // 2))
    need = (n_frames - 1) * hop + nfft
    if xp.shape[-1] < need:
        # an odd nfft leaves the last frame one sample short: it reads zero
        xp = F.pad(xp, (0, need - xp.shape[-1]))
    frames = xp.unfold(-1, nfft, hop)[..., :n_frames, :]      # [..., frames, nfft]
    mat = torch.tensor(_stft_matmul_matrix(nfft), device=x.device)
    proj = torch.matmul(frames.to(torch.float32), mat)         # [..., frames, 2F]
    nf = nfft // 2 + 1
    re, im = proj[..., :nf], proj[..., nf:]
    return torch.sqrt(re * re + im * im).to(x.dtype).transpose(-1, -2)


def stft_magnitude(x: torch.Tensor, nfft: int, hop: int, *,
                   engine: str = "fused") -> torch.Tensor:
    """``|STFT|`` of ``x [..., T]``, ``[..., nfft//2 + 1, n_frames]``,
    centred, periodic Hann. ``"rfft"``: ``abs`` of :func:`stft`;
    ``"matmul"``: :func:`stft_magnitude_matmul`; ``"fused"``: ``sqrt`` of
    the kernel's power (``ops.fused_stft``) — each engine keeps its own
    form, as in the JAX package."""
    engine = check_stft_engine(engine)
    if engine == "rfft":
        return torch.abs(stft(x, nfft, hop))
    if engine == "matmul":
        return stft_magnitude_matmul(x, nfft, hop)
    from .fused_stft import stft_power

    lead = tuple(x.shape[:-1])
    power = stft_power(x.reshape(-1, x.shape[-1]), nfft, hop)
    return torch.sqrt(power).reshape(lead + tuple(power.shape[1:]))


def fx_transform(trace: torch.Tensor, nfft: int) -> torch.Tensor:
    """Per-channel two-sided fftshifted FFT magnitude at ``nfft`` points,
    scaled by ``2/nfft`` and expressed in nanostrain (the reference's
    ``dsp.get_fx``)."""
    fx = 2.0 * torch.abs(torch.fft.fftshift(torch.fft.fft(trace, n=nfft, dim=-1), dim=-1))
    return fx / nfft * 1e9


def spectrogram(waveform: torch.Tensor, fs: float, nfft: int = 128,
                overlap_pct: float = 0.8) -> Tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """Spectrogram in dB re its maximum, with its time and frequency axes
    (the reference's ``dsp.get_spectrogram``): hop ``floor(nfft * (1 -
    overlap_pct))``, ``|STFT|`` of :func:`stft`, axes as linspace ramps
    over the duration and the Nyquist band."""
    hop = int(np.floor(nfft * (1 - overlap_pct)))
    mag = torch.abs(stft(waveform, nfft, hop))
    p = 20.0 * torch.log10(mag / torch.max(mag))
    height, width = p.shape[-2], p.shape[-1]
    tt = np.linspace(0, waveform.shape[-1] / fs, num=width)
    ff = np.linspace(0, fs / 2, num=height)
    return p, tt, ff


def unwrap(p: torch.Tensor, dim: int = -1, period: float = 2 * math.pi) -> torch.Tensor:
    """Phase unwrap along ``dim`` (``np.unwrap`` / ``jnp.unwrap`` with
    ``discont = period / 2``): jumps larger than half a period are
    replaced by their complement, and the corrections accumulate."""
    interval = period / 2
    dd = torch.diff(p, dim=dim)
    ddmod = torch.remainder(dd + interval, period) - interval
    ddmod = torch.where((ddmod == -interval) & (dd > 0), torch.full_like(ddmod, interval), ddmod)
    ph_correct = torch.where(torch.abs(dd) < interval, torch.zeros_like(dd), ddmod - dd)
    head = p.narrow(dim, 0, 1)
    tail = p.narrow(dim, 1, p.shape[dim] - 1) + torch.cumsum(ph_correct, dim=dim)
    return torch.cat([head, tail], dim=dim)


def instant_freq(channel: torch.Tensor, fs: float) -> torch.Tensor:
    """Instantaneous frequency [Hz] from the unwrapped analytic phase
    (the reference's ``dsp.instant_freq``), over any leading axes."""
    phase = unwrap(torch.angle(analytic_signal(channel, dim=-1)), dim=-1)
    return torch.diff(phase, dim=-1) / (2.0 * math.pi) * fs


def taper_data(trace: torch.Tensor, alpha: float = 0.03) -> torch.Tensor:
    """A Tukey taper along time (the reference's ``dsp.taper_data``)."""
    return trace * tukey_window(trace.shape[-1], alpha, dtype=trace.dtype, device=trace.device)
