"""Spectrogram-correlation whale-call detector in PyTorch.

The port of ``das4whales_tpu.models.spectro``: per-channel sliced
spectrograms cross-correlated along time with a hat-function kernel
traced along the call's hyperbolic frequency contour. The whole array
goes through one batched STFT per channel chunk — on the card the fused
``|STFT|²`` kernel (``ops.fused_stft``, engine ``"fused"``) — and one
batched FFT convolution.

Differences of procedure from the JAX package, none of result:

* the frequency and time axes of the spectrogram are computed from the
  shapes (``spectro_axes``) instead of from an STFT of channel 0;
* the hat kernel is built once per shape and kept on the device
  (``_hat_kernel``): a host-to-device copy from pageable memory would
  wait for the stream at every call;
* the spectrogram is sliced to the band before it is divided by its
  per-channel maximum, which is taken over all frequencies as before —
  the same values without the full-band quotient.

Two reductions are spelled out: ``jnp.median`` is the midpoint of the two
middle order statistics (``torch.median`` returns the lower one), and
``jnp.std`` has ``ddof=0``.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..config import SPECTRO_HF_KERNEL, SPECTRO_LF_KERNEL, as_metadata
from ..ops import peaks as peak_ops
from ..ops import mxu, spectral, xcorr
from ..utils.device import resolve_device
from ..utils.views import cached_shallow_view
from .templates import gen_hyperbolic_chirp

#: Channel-chunk defaults of the spectrogram sweep, by STFT engine: the
#: fused kernel frames in shared memory; the rFFT route materializes the
#: 95 %-overlap frame tensor (``nfft/hop`` times the block) on the device.
FUSED_DEFAULT_BATCH = 4096
RFFT_DEFAULT_BATCH = 1024
#: the JAX package's name for :data:`FUSED_DEFAULT_BATCH` (its STFT kernel
#: is the Pallas one)
PALLAS_DEFAULT_BATCH = FUSED_DEFAULT_BATCH


def median_midpoint(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """``jnp.median`` over the last ``ndim`` axes: ``(lo + hi) * 0.5`` of
    the two middle order statistics (equal when the count is odd)."""
    flat = x.reshape(tuple(x.shape[: x.ndim - ndim]) + (-1,))
    n = flat.shape[-1]
    lo = torch.kthvalue(flat, (n - 1) // 2 + 1, dim=-1).values
    hi = lo if n % 2 else torch.kthvalue(flat, n // 2 + 1, dim=-1).values
    return (lo + hi) * 0.5


def spectro_axes(n: int, fs: float, nperseg: int, nhop: int) -> Tuple[np.ndarray, np.ndarray]:
    """``(ff, tt)``: the frequency [Hz] and time [s] axes of the centred
    STFT of an ``n``-sample signal — ``nperseg//2 + 1`` bins up to
    Nyquist and ``1 + n//nhop`` frames over the record, as linspace ramps
    (reference ``detect.get_sliced_nspectrogram``)."""
    ff = np.linspace(0, fs / 2, num=nperseg // 2 + 1)
    tt = np.linspace(0, n / fs, num=1 + n // nhop)
    return ff, tt


def _band(ff: np.ndarray, fmin: float, fmax: float) -> slice:
    """The contiguous run of ``ff`` inside ``[fmin, fmax]`` as a slice."""
    sel = np.where((ff >= fmin) & (ff <= fmax))[0]
    return slice(int(sel[0]), int(sel[-1]) + 1) if sel.size else slice(0, 0)


def _normalise_slice(mag: torch.Tensor, band: slice) -> torch.Tensor:
    """``mag`` divided by its per-signal max over (freq, time), sliced to
    ``band`` — the slice is taken before the division."""
    return mag[..., band, :] / mag.amax(dim=(-2, -1), keepdim=True)


def sliced_spectrogram(trace: torch.Tensor, fs: float, fmin: float, fmax: float,
                       nperseg: int, nhop: int, engine: str = "fused"):
    """Max-normalized STFT magnitude sliced to ``[fmin, fmax]``, batched
    over leading axes (reference ``detect.get_sliced_nspectrogram``).
    Returns ``(p, ff, tt)``."""
    mag = spectral.stft_magnitude(trace, nperseg, nhop, engine=engine)
    ff, tt = spectro_axes(trace.shape[-1], fs, nperseg, nhop)
    band = _band(ff, fmin, fmax)
    return _normalise_slice(mag, band), ff[band], tt


def buildkernel(f0: float, f1: float, bdwdth: float, dur: float, f: np.ndarray,
                t: np.ndarray, samp: float, fmin: float, fmax: float):
    """Mexican-hat-in-frequency kernel along the hyperbolic contour
    ``f(t) = f0 f1 dur / ((f0 - f1) t + f1 dur)`` (reference
    ``detect.buildkernel``): as many time bins as the spectrogram has
    within one call duration, a symmetric Hann taper along time. Host
    float64. Returns ``(tvec, fvec, kernel)``."""
    n_t = np.size(np.nonzero((t < dur * 8) & (t > dur * 7)))
    tvec = np.linspace(0, dur, n_t)
    fvec = np.asarray(f)
    x = fvec[:, None] - (f0 * f1 * dur / ((f0 - f1) * tvec[None, :] + f1 * dur))
    kernel = (1 - np.square(x) / (bdwdth * bdwdth)) * np.exp(-np.square(x) / (2 * bdwdth * bdwdth))
    kernel = kernel * np.hanning(len(tvec))[None, :]
    return tvec, fvec, kernel


def buildkernel_from_template(fmin: float, fmax: float, dur: float, fs: float,
                              nperseg: int, nhop: int, device=None) -> np.ndarray:
    """Kernel as the sliced spectrogram of a Hann-windowed hyperbolic
    chirp (reference ``detect.buildkernel_from_template``), computed on
    ``device`` (the card unless ``"cpu"``), returned as host numpy."""
    tmpl = gen_hyperbolic_chirp(fmin, fmax, dur, fs)
    tmpl = tmpl * np.hanning(len(tmpl))
    x = torch.as_tensor(tmpl, dtype=torch.float32, device=resolve_device(device))
    spec, _, _ = sliced_spectrogram(x, fs, fmin, fmax, nperseg, nhop)
    return spec.cpu().numpy()


def xcorr2d(spectro: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Time-axis kernel correlation summed over frequency, half-wave
    rectified, divided by ``median(spectro) * kernel_width`` per signal
    (reference ``detect.xcorr2d``), batched over leading axes."""
    conv = xcorr.fftconvolve_same_time(spectro, torch.flip(kernel, (-1,)))
    out = conv.sum(dim=-2)
    out = torch.where(out < 0, 0.0, out)
    med = median_midpoint(spectro, 2)
    return out / (med[..., None] * kernel.shape[-1])


def nxcorr2d(spectro: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Std-normalized 2-D correlation, max over frequency (reference
    ``detect.nxcorr2d``); each channel's std over its own (freq, time)
    plane, ``ddof=0``."""
    conv = xcorr.fftconvolve2d_same(spectro, torch.flip(kernel, (-1, -2)))
    std = spectro.std(dim=(-2, -1), keepdim=True, correction=0)
    corr = conv / (std * kernel.std(correction=0) * spectro.shape[-1])
    return corr.amax(dim=-2)


def xcorr_sliding(t, f, Sxx, tvec, fvec, kernel):
    """Valid-mode sliding-window kernel correlation (reference
    ``detect.xcorr``) as one FFT correlation; the median is over all of
    ``Sxx``. Returns ``[t_scale, CorrVal]``."""
    Sxx = torch.as_tensor(Sxx)
    kernel = torch.as_tensor(kernel, dtype=Sxx.dtype, device=Sxx.device)
    tvec_size, fvec_size = kernel.shape[-1], kernel.shape[-2]
    n = Sxx.shape[-1]
    conv = xcorr.fftconvolve_same_time(Sxx[..., :fvec_size, :], torch.flip(kernel, (-1,)))
    summed = conv.sum(dim=-2)
    # the 'valid' alignment of the 'same' output
    start = tvec_size // 2
    vals = summed[..., start : start + n - tvec_size + 1]
    vals = vals / (median_midpoint(Sxx, Sxx.ndim) * tvec_size)
    vals[..., 0] = 0
    vals[..., -1] = 0
    vals = torch.where(vals < 0, 0.0, vals)
    t_scale = np.asarray(t)[int(tvec_size / 2) - 1 : -int(np.ceil(tvec_size / 2))]
    return [t_scale, vals]


def effective_band(flims: Tuple[float, float], kernel: Dict) -> Tuple[float, float]:
    """The reference widens the spectrogram band to fit the hat function
    (detect.py:693-696)."""
    fmin, fmax = flims
    if fmax - kernel["f1"] < 2 * kernel["bdwidth"]:
        fmax = kernel["f1"] + 3 * kernel["bdwidth"]
    if kernel["f0"] - fmin < 2 * kernel["bdwidth"]:
        fmin = kernel["f0"] - 3 * kernel["bdwidth"]
    return fmin, fmax


@functools.lru_cache(maxsize=32)
def _hat_kernel(kernel_items: tuple, n: int, fs: float, nperseg: int, nhop: int,
                fmin: float, fmax: float, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    """The hat kernel on the spectrogram's sliced axes, on ``device``,
    made once per (kernel, shape, band, device)."""
    k = dict(kernel_items)
    ff, tt = spectro_axes(n, fs, nperseg, nhop)
    _, _, ker = buildkernel(k["f0"], k["f1"], k["bdwidth"], k["dur"], ff[_band(ff, fmin, fmax)],
                            tt, fs, fmin, fmax)
    if dtype == torch.float32:
        # rounded on the host (as torch would round it), so no float64
        # tensor enters the program
        ker = np.asarray(ker, dtype=np.float32)
    return torch.as_tensor(ker, dtype=dtype, device=device)


def compute_cross_correlogram_spectrocorr(
    data: torch.Tensor,
    fs: float,
    flims: Tuple[float, float],
    kernel: Dict,
    win_size: float,
    overlap_pct: float,
    batch_channels: int | None = None,
    stft_engine: str = "fused",
    stage_hook: Callable[[str], None] | None = None,
) -> torch.Tensor:
    """Spectrogram-correlation correlograms ``[C, n_frames]`` of every
    channel of ``data [C, T]`` (reference
    ``detect.compute_cross_correlogram_spectrocorr``): per-channel demean
    and peak normalization, then per chunk of ``batch_channels`` channels
    the sliced spectrogram and the hat-kernel correlation.
    ``batch_channels`` defaults by engine (:data:`FUSED_DEFAULT_BATCH`,
    :data:`RFFT_DEFAULT_BATCH`). ``stage_hook(name)``, when given, is
    called after ``normalise`` and, per chunk, after ``stft``, ``slice``
    and ``xcorr2d``; it must not synchronize."""
    hook = stage_hook or (lambda name: None)
    engine = spectral.check_stft_engine(stft_engine)
    if batch_channels is None:
        batch_channels = FUSED_DEFAULT_BATCH if engine == "fused" else RFFT_DEFAULT_BATCH
    nperseg = int(win_size * fs)
    nhop = int(np.floor(nperseg * (1 - overlap_pct)))
    fmin, fmax = effective_band(flims, kernel)

    norm = data - data.mean(dim=-1, keepdim=True)
    norm = norm / data.abs().amax(dim=-1, keepdim=True)
    hook("normalise")

    n = data.shape[-1]
    band = _band(spectro_axes(n, fs, nperseg, nhop)[0], fmin, fmax)
    ker = _hat_kernel(tuple(sorted(kernel.items())), n, float(fs), nperseg, nhop,
                      float(fmin), float(fmax), data.dtype, data.device)
    chunks = [
        _chunk_correlogram(norm[i : i + batch_channels], ker, band, nperseg, nhop, engine, hook)
        for i in range(0, norm.shape[0], batch_channels)
    ]
    return torch.cat(chunks, dim=0) if len(chunks) > 1 else chunks[0]


def _chunk_correlogram(chunk: torch.Tensor, ker: torch.Tensor, band: slice, nperseg: int,
                       nhop: int, engine: str, hook: Callable[[str], None]) -> torch.Tensor:
    """One channel chunk's sliced spectrogram and hat-kernel correlation."""
    mag = spectral.stft_magnitude(chunk, nperseg, nhop, engine=engine)
    hook("stft")
    spec = _normalise_slice(mag, band)
    del mag
    hook("slice")
    out = xcorr2d(spec, ker)
    hook("xcorr2d")
    return out


class SpectroCorrDetector:
    """Design-once / detect-many façade for spectrogram correlation.

    Defaults reproduce ``main_spectrodetect.py``: 0.8 s window, 95 %
    overlap, HF/LF hat kernels, absolute pick threshold 14. Plain
    counters on the instance: ``syncs`` (device->host reads) and
    ``escalations`` (K0 -> K reruns, one per kernel that saturated).

    ``stft_engine``: ``"fused"`` (the kernel), ``"rfft"`` or ``"matmul"``
    forced; None takes ``DAS4WHALES_STFT_ENGINE``, else ``"fused"``;
    ``"auto"`` runs ``ops.mxu.resolve_stft_engine_ab`` at the first
    block's shape (``"rfft"`` off a CUDA device, where it resolves at
    once). The resolved engine and its reason land on ``stft_engine`` /
    ``stft_engine_reason``.
    """

    def __init__(
        self,
        metadata,
        flims: Tuple[float, float] = (14.0, 30.0),
        kernels: Dict[str, Dict] | None = None,
        win_size: float = 0.8,
        overlap_pct: float = 0.95,
        threshold: float = 14.0,
        max_peaks: int = 256,
        batch_channels: int | None = None,
        stft_engine: str | None = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.metadata = as_metadata(metadata)
        self.flims = flims
        self.kernels = kernels or {"HF": SPECTRO_HF_KERNEL, "LF": SPECTRO_LF_KERNEL}
        self.win_size = win_size
        self.overlap_pct = overlap_pct
        self.threshold = threshold
        self.max_peaks = max_peaks
        self.batch_channels = batch_channels
        self._stft_engine_req = stft_engine
        self.stft_engine: str | None = None
        self.stft_engine_reason: str | None = None
        self.resolve_engine()
        self.syncs = self.escalations = 0

    def resolve_engine(self, trace_shape=None) -> str | None:
        """The STFT engine, resolved once and cached: a forced engine (or
        ``"auto"`` off a CUDA device) at construction, ``"auto"`` on the
        card at the sweep's ``[C, T]`` shape, the first block's."""
        if self.stft_engine is None:
            req = mxu.requested_stft_engine(self._stft_engine_req)
            if req == "auto" and self.device.type == "cuda" and trace_shape is None:
                return None
            C, T = (0, 0) if trace_shape is None else tuple(trace_shape[-2:])
            nperseg = int(self.win_size * self.metadata.fs)
            nhop = max(1, int(np.floor(nperseg * (1 - self.overlap_pct))))
            self.stft_engine, self.stft_engine_reason = mxu.resolve_stft_engine_ab(
                req, C, T, nperseg, nhop, device=self.device)
        return self.stft_engine

    def tiled_view(self) -> "SpectroCorrDetector":
        """A shallow view sweeping the spectrogram in smaller channel
        chunks — the planner ladder's memory-lean rung for this family
        (``workflows.planner.SpectroProgram``): the live STFT temps
        shrink proportionally, and every stage is per-channel math, so
        the picks are the untiled sweep's. Never larger than the chunk
        that just ran out of memory, and strictly smaller whenever the
        16-channel floor allows. Cached: repeated calls return the same
        view."""
        base = self.batch_channels or (
            FUSED_DEFAULT_BATCH if self.stft_engine == "fused" else RFFT_DEFAULT_BATCH)

        def mutate(det):
            det.batch_channels = min(base, max(16, base // 8))

        return cached_shallow_view(self, "_tiled_view_cache", mutate)

    def host_view(self) -> "SpectroCorrDetector":
        """This detector on the CPU (the ladder's host rung): every stage
        runs its plain PyTorch version there, the STFT kernel's included.
        Cached: repeated calls return the same view."""

        def mutate(det):
            det.device = torch.device("cpu")

        return cached_shallow_view(self, "_host_view_cache", mutate)

    def correlograms(self, trf_fk, stage_hook: Callable[[str], None] | None = None
                     ) -> Dict[str, torch.Tensor]:
        """Per-kernel spectro correlograms ``[C, n_frames]`` on the device;
        the stage names reaching ``stage_hook`` are prefixed with the
        kernel's name (``"HF.stft"``)."""
        x = torch.as_tensor(trf_fk).to(self.device, torch.float32)
        self.resolve_engine(x.shape)
        out = {}
        for name, ker in self.kernels.items():
            hook = None if stage_hook is None else (
                lambda stage, name=name: stage_hook(f"{name}.{stage}"))
            out[name] = compute_cross_correlogram_spectrocorr(
                x, self.metadata.fs, self.flims, ker, self.win_size, self.overlap_pct,
                batch_channels=self.batch_channels, stft_engine=self.stft_engine,
                stage_hook=hook)
        return out

    def picks_from_correlograms(self, correlograms: Dict[str, torch.Tensor],
                                stage_hook: Callable[[str], None] | None = None):
        """Adaptive-K picks per kernel (the correlograms are half-wave
        rectified, so the height-prefiltered sparse route is exact),
        compacted on the device, and the correlogram sampling rate.
        Device->host reads: one saturation check and one packed fetch per
        kernel; one more for the saturated-row count after an escalation,
        and one on a capacity overflow."""
        hook = stage_hook or (lambda name: None)
        syncs = peak_ops.SyncCounter()
        k0 = min(64, self.max_peaks)
        picks = {}
        for name, corr in correlograms.items():
            attempts = []

            def run(k, corr=corr, attempts=attempts):
                attempts.append(k)
                return peak_ops.find_peaks_sparse(
                    corr, self.threshold, max_peaks=k,
                    method=peak_ops.escalation_method(k, self.max_peaks))

            res = peak_ops.picks_with_escalation(run, k0, self.max_peaks, syncs)
            if len(attempts) > 1:
                self.escalations += 1
            if k0 < self.max_peaks and len(attempts) == 1:
                n_sat = 0      # the K0 check read no saturated row
            else:
                n_sat = int(res.saturated.sum())
                syncs.add()
            peak_ops.warn_saturated(n_sat, f"kernel {name}", self.max_peaks)
            picks[name] = peak_ops.pick_times_compacted(res.positions, res.selected,
                                                        syncs=syncs)
            hook(f"{name}.picks")
        self.syncs += syncs.count
        nt = next(iter(correlograms.values())).shape[-1]
        spectro_fs = nt / (self.metadata.ns / self.metadata.fs)
        return picks, spectro_fs

    def __call__(self, trf_fk, stage_hook: Callable[[str], None] | None = None):
        """``(correlograms, picks, spectro_fs)`` of one filtered block."""
        correlograms = self.correlograms(trf_fk, stage_hook=stage_hook)
        picks, spectro_fs = self.picks_from_correlograms(correlograms, stage_hook=stage_hook)
        return correlograms, picks, spectro_fs
