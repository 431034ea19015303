"""The matched filter's matmul engines for its heavy stages, their per-shape
calibration table, the precision gates and the engine routers (the
port's copy of ``das4whales_tpu.ops.mxu``).

Two stages of the matched filter have a matmul form beside their FFT
form:

* **The correlate as a banded-Toeplitz contraction.** The templates are
  about 150 taps against 12000-sample records, so the positive-lag raw
  correlation ``raw[t, c, k] = sum_j xn[c, k + j] y[t, j]`` is a
  ``[channel, lag, tap] @ [tap, template]`` product: ``F.conv1d`` over
  ``[rows, 1, n]`` (no flip in the ML convention), right-padded ``m - 1``
  by ``F.pad`` so every lag of ``[0, n)`` comes out as the FFT route's
  truncated linear correlation. The normalisation before it and the
  padded-template correction after it are ``ops.xcorr``'s own, so the
  engines differ only in how the raw correlation rounds.
  ``"matmul-bf16"`` rounds both inputs to bf16 and convolves the rounded
  values in float32 (TF32 off, as everywhere in the port): the products
  of bf16 values are exact in float32 and the sums float32, so the output
  is JAX's bf16-in, float32-accumulate contraction — never a bf16
  output, which would round a second time. bf16 rounding is a step
  function: where two devices' filtered blocks differ in the last float32
  bits, some inputs round to neighbouring bf16 values, so the route's
  card and CPU correlograms part by about 1e-4 of their max while the
  contraction itself agrees on one input. ``"matmul-fused"`` folds the
  zero-phase
  bandpass FIR into the taps (:func:`fused_template_taps`), so one
  ``m + 2L``-tap contraction of the unfiltered block replaces the
  bandpass pass.
* **The f-k apply as a DFT-matrix product.** The channel-axis FFT pair
  of the banded applier (``ops.fk.fk_filter_apply_rfft_banded``) becomes
  eight real ``[C, C] @ [C, band]`` products against the ``[C, C]`` DFT
  matrix with the mask between them; the time-axis rfft stays an FFT.

The routers (:func:`resolve_mf_engine`, :func:`resolve_fk_engine`,
:func:`resolve_stft_engine_ab`, :func:`resolve_gabor_engine`) take a
forced engine as given and run ``"auto"`` through a per-shape A/B
measured once on the live device and kept in a
:class:`CalibrationTable` on disk (``config.calibration_cache_path``).
The bf16 and tap-folded correlates are eligible only where a precision
gate finds their picks bitwise the float32 FFT route's on a fixed-seed
record; a failed gate records why and the router falls back to the
float32 matmul. ``"auto"`` never takes the bf16 route: here it is the
float32 contraction plus two rounding passes, so it cannot beat
``"matmul"`` and runs only when forced. Off a CUDA device ``"auto"`` is
the FFT route. Every
key's backend part is ``cuda:<card name>`` on the card and ``cpu`` on
the CPU, so one card's verdicts never route another card.

The port's defaults stay the FFT routes: ``"auto"`` runs only when a
caller or an environment variable asks for it (``config``).
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import config
from ..utils.device import resolve_device
from . import fk as fk_ops
from . import peaks as peak_ops
from . import spectral, xcorr

#: Matched-filter correlate engines (the routers' vocabulary adds "auto").
MF_ENGINES = ("fft", "matmul", "matmul-bf16", "matmul-fused")

#: f-k apply engines. The DFT product stays float32: the mask sits
#: between two C-length transforms whose bf16 rounding would compound.
FK_ENGINES = ("fft", "matmul")


# ---------------------------------------------------------------------------
# The correlate as a banded-Toeplitz contraction
# ---------------------------------------------------------------------------


def correlate_taps(xn: torch.Tensor, templates_true: torch.Tensor, bf16: bool = False,
                   pad: Tuple[int, int] | None = None) -> torch.Tensor:
    """Positive-lag raw correlation ``sum_j xn[..., k + j] * y[t, j]`` of
    ``xn [..., n]`` with every row of ``templates_true [nT, m]`` as one
    ``F.conv1d`` over ``[rows, 1, n]``, edge-padded ``(0, m - 1)`` (or
    ``pad``) by ``F.pad``: returns ``[nT, ..., lags]`` float32. ``bf16``
    rounds both inputs to bf16 first (the module docstring). The
    tap-folded engine correlates against rows of
    ``m + 2L`` taps whose lag origin sits ``L`` taps in, so it pads
    ``(L, m - 1 + L)``."""
    n = xn.shape[-1]
    nT, m = templates_true.shape
    lead = tuple(xn.shape[:-1])
    lhs = xn.reshape(-1, 1, n).to(torch.float32)
    rhs = templates_true.to(torch.float32)[:, None, :]
    if bf16:
        lhs = lhs.to(torch.bfloat16).to(torch.float32)
        rhs = rhs.to(torch.bfloat16).to(torch.float32)
    lo, hi = (0, m - 1) if pad is None else (int(pad[0]), int(pad[1]))
    out = F.conv1d(F.pad(lhs, (lo, hi)), rhs)           # [rows, nT, lags]
    return out.movedim(1, 0).reshape((nT,) + lead + (out.shape[-1],))


def compute_cross_correlograms_matmul(data: torch.Tensor, templates_true: torch.Tensor,
                                      mu: torch.Tensor, scale: torch.Tensor,
                                      bf16: bool = False) -> torch.Tensor:
    """The matmul twin of ``xcorr.compute_cross_correlograms_corrected``:
    same signature, same ``[nT, ..., n]`` output, the same normalisation
    and correction helpers; only the raw correlation differs
    (:func:`correlate_taps`). ``bf16=True`` rounds the contraction's
    inputs to bf16 (a forced, gated ``"matmul-bf16"``)."""
    xn, suffix = xcorr.normalized_block_and_suffix(data)
    raw = correlate_taps(xn, templates_true, bf16=bf16)
    return xcorr.corrected_from_raw(raw, suffix, mu, scale, data.dtype)


# ---------------------------------------------------------------------------
# Tap folding: the bandpass inside the correlate contraction
# ---------------------------------------------------------------------------


def fused_template_taps(templates_true, fir) -> Tuple[np.ndarray, np.ndarray, int]:
    """Fold the zero-phase bandpass FIR ``h`` (half-length ``L``,
    ``ops.filters.butter_zero_phase_fir``) into each template's taps: the
    staged route correlates the FILTERED block against the template, and
    ``sum_j (h * x)[k + j] y[t, j] == sum_u x[k + u] (h conv y_t)[u]``
    with ``u in [-L, m - 1 + L]``.

    Returns ``(folded [nT + 1, m + 2L] float32, tcum [nT, m + 1] float32,
    L)``. The last row of ``folded`` is ``h`` itself, so the same
    contraction also yields the bandpassed block ``g = h * x``;
    ``tcum[t, r]`` is the prefix sum ``sum_{j < r} y[t, j]`` the closed
    form's demean term needs at partial-overlap lags. Designed on the host
    in float64 and cast to float32 once."""
    tt = np.atleast_2d(np.asarray(templates_true, dtype=np.float64))
    h = np.asarray(fir, dtype=np.float64)
    L = (int(h.shape[0]) - 1) // 2
    nT, m = tt.shape
    folded = np.zeros((nT + 1, m + 2 * L))
    for i in range(nT):
        folded[i] = np.convolve(h, tt[i])                # length m + 2L
    folded[nT, : 2 * L + 1] = h
    tcum = np.concatenate([np.zeros((nT, 1)), np.cumsum(tt, axis=-1)], axis=-1)
    return folded.astype(np.float32), tcum.astype(np.float32), L


def compute_cross_correlograms_fused(data, templates_true, folded_taps, tcum, mu, scale,
                                     fir_half: int) -> torch.Tensor:
    """Corrected correlograms from the UNFILTERED block with the bandpass
    folded into the taps: one ``m + 2L``-tap contraction and an
    elementwise epilogue instead of bandpass -> normalise -> correlate ->
    correct.

    With ``g = h * x`` (row ``nT`` of the contraction, run ``m - 1`` lags
    past the record so its ring-down tail is there), ``mg = mean(g[:n])``,
    ``Mg = max|g[:n]|`` (guarded like ``_demean_peak_normalize``) and
    ``suffix_g[k] = sum_{i >= k} g[i]``, the staged route's correlogram is

        corr[t, c, k] = (raw - tail - mg tcum[t, w(k)]
                         - mu_t (suffix_g[k] - (n - k) mg)) / (Mg s_t),

    ``w(k) = min(m, n - k)``: ``raw`` (rows ``0..nT-1``) integrates the
    full overlap, and ``tail`` correlates the ``m - 1`` ring-down samples
    ``g[n:]`` against the template tails to take away what the staged
    route's zero padding never sees. It equals the staged route on a
    LINEARLY filtered block to float32 rounding; against the shipping
    routes' circular bandpass it differs near the record's ends, which is
    why this engine is gated (:func:`fused_correlate_gate`). Float32
    throughout, cast to ``data.dtype`` on return."""
    L = int(fir_half)
    P = int(folded_taps.shape[-1])
    nT = int(folded_taps.shape[0]) - 1
    m = int(tcum.shape[-1]) - 1
    n = data.shape[-1]
    x32 = data.to(torch.float32)
    out = correlate_taps(x32, folded_taps.to(torch.float32), pad=(L, P - 1 - L + m - 1))
    g_ext = out[-1]
    g = g_ext[..., :n]                                   # the bandpassed block
    raw = out[:-1][..., :n]
    mg = g.mean(dim=-1, keepdim=True)
    big = torch.clamp_min(g.abs().amax(dim=-1, keepdim=True), torch.finfo(torch.float32).tiny)
    suffix_g = torch.flip(torch.cumsum(torch.flip(g, (-1,)), dim=-1), (-1,))
    nd = raw.ndim - 1
    mu_b = mu.to(torch.float32).reshape((nT,) + (1,) * nd)
    sc_b = scale.to(torch.float32).reshape((nT,) + (1,) * nd)
    # T[t, c, n - r] = sum_i g[c, n + i] y[t, r + i]: left-padding m - 1
    # puts the template-leads-by-r family at output index m - 1 - r
    tail_corr = correlate_taps(g_ext[..., n:], templates_true.to(torch.float32),
                               pad=(m - 1, 0))            # [nT, ..., m - 1]
    tail = torch.zeros(raw.shape, dtype=torch.float32, device=raw.device)
    tail[..., n - m + 1:] = tail_corr
    w = torch.clamp(n - torch.arange(n, device=raw.device), 0, m)
    coeff = tcum.to(torch.float32)[:, w].reshape((nT,) + (1,) * (nd - 1) + (n,))
    remaining = torch.arange(n, 0, -1, dtype=torch.float32, device=raw.device)
    corr = (raw - tail - mg[None] * coeff
            - mu_b * (suffix_g[None] - remaining * mg[None]))
    return (corr / (big[None] * sc_b)).to(data.dtype)


def correlograms_body(data, templates_true, mu, scale, engine: str, fused=None,
                      fir_half: int = 0) -> torch.Tensor:
    """The correlate stage on ``engine``. ``fused`` is the ``(folded_taps,
    tcum)`` device pair of the ``"matmul-fused"`` engine (None elsewhere);
    on that engine ``data`` is the UNFILTERED block."""
    if engine == "fft":
        return xcorr.compute_cross_correlograms_corrected(data, templates_true, mu, scale)
    if engine == "matmul-fused":
        if fused is None:
            raise ValueError("matmul-fused engine needs the (folded_taps, tcum) pair "
                             "from fused_template_taps")
        folded_taps, tcum = fused
        return compute_cross_correlograms_fused(data, templates_true, folded_taps, tcum, mu,
                                                scale, fir_half)
    if engine not in ("matmul", "matmul-bf16"):
        raise ValueError(f"unknown mf_engine {engine!r}; expected one of {MF_ENGINES}")
    return compute_cross_correlograms_matmul(data, templates_true, mu, scale,
                                             bf16=engine == "matmul-bf16")


# ---------------------------------------------------------------------------
# The f-k apply as a channel-axis DFT-matrix product
# ---------------------------------------------------------------------------


def dft_matrices(n: int, dtype=np.float32) -> Tuple[np.ndarray, np.ndarray]:
    """``(cos, sin)`` of the forward DFT matrix ``W[j, k] = exp(-2 pi i j k
    / n)``, the phase from ``(j k) mod n`` in float64, cast to ``dtype``.
    The inverse reuses the pair: ``W^-1 = (cos - i sin) / n``. Built in
    row blocks on a few threads (elementwise, so the blocks are the whole
    matrix's values bit for bit): at 22050 channels the float64 grid
    alone is 3.9 GB."""
    k = np.arange(n, dtype=np.float64)
    cos, sin = np.empty((n, n), dtype), np.empty((n, n), dtype)
    rows = 512

    def block(lo):
        ang = (-2.0 * np.pi / n) * (np.outer(k[lo : lo + rows], k) % n)
        cos[lo : lo + rows] = np.cos(ang)
        sin[lo : lo + rows] = np.sin(ang)

    with ThreadPoolExecutor(max(1, min(8, os.cpu_count() or 1)),
                            thread_name_prefix="das-dft") as pool:
        list(pool.map(block, range(0, n, rows)))
    return cos, sin


def _mm(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``w [C, C] @ x [..., C, N]``: one 2-D product over every leading
    axis (a broadcast matmul would copy ``w`` once a file)."""
    if x.ndim == 2:
        return w @ x
    lead, (C, N) = tuple(x.shape[:-2]), tuple(x.shape[-2:])
    y = w @ x.movedim(-2, 0).reshape(C, -1)
    return y.reshape((C,) + lead + (N,)).movedim(0, -2)


def fk_apply_dft_matmul(trace: torch.Tensor, mask_band: torch.Tensor, lo: int, hi: int,
                        wr: torch.Tensor, wi: torch.Tensor) -> torch.Tensor:
    """``fk_filter_apply_rfft_banded`` of ``trace [..., C, n]`` with the
    channel-axis FFT pair as DFT-matrix products around the mask: ``Z =
    W^-1 (M . (W X))`` as eight real ``[C, C] @ [C, band]`` products on
    the in-band rfft columns. ``(wr, wi)`` is :func:`dft_matrices` at the
    trace's channel count. Equal to the banded FFT applier up to
    matmul-against-FFT rounding."""
    nnx, nns = trace.shape[-2], trace.shape[-1]
    Xf = torch.fft.rfft(trace, dim=-1)                   # [..., C, F]
    xr = Xf.real[..., lo:hi]
    xi = Xf.imag[..., lo:hi]
    yr = _mm(wr, xr) - _mm(wi, xi)
    yi = _mm(wr, xi) + _mm(wi, xr)
    m = mask_band.to(yr.dtype)
    yr = yr * m
    yi = yi * m
    inv = float(np.float32(1.0 / nnx))
    zr = (_mm(wr, yr) + _mm(wi, yi)) * inv
    zi = (_mm(wr, yi) - _mm(wi, yr)) * inv
    del yr, yi
    Z = torch.zeros_like(Xf)
    Z[..., lo:hi] = torch.complex(zr, zi)
    del Xf, zr, zi
    return torch.fft.irfft(Z, n=nns, dim=-1).to(trace.dtype)


def fk_apply_body(trace, mask_band, lo, hi, engine: str, fk_dft) -> torch.Tensor:
    """The f-k apply on ``engine``; ``fk_dft`` is the ``(wr, wi)`` device
    pair of the matmul engine (None on the FFT route)."""
    if engine == "matmul":
        wr, wi = fk_dft
        return fk_apply_dft_matmul(trace, mask_band, lo, hi, wr, wi)
    if engine != "fft":
        raise ValueError(f"unknown fk_engine {engine!r}; expected one of {FK_ENGINES}")
    return fk_ops.fk_filter_apply_rfft_banded(trace, mask_band, lo, hi)


# ---------------------------------------------------------------------------
# The per-shape A/B calibration table
# ---------------------------------------------------------------------------


_path_locks: Dict[str, threading.Lock] = {}
_path_locks_guard = threading.Lock()


def _path_lock(path: str) -> threading.Lock:
    """One lock a table file, shared by every instance on that path in
    this process, so their merge-on-write puts never interleave."""
    key = os.path.abspath(path)
    with _path_locks_guard:
        return _path_locks.setdefault(key, threading.Lock())


class CalibrationTable:
    """A small key -> record store on disk for the routers: per-shape A/B
    walls and the precision gates' verdicts, measured once per (backend,
    shape) and kept so later processes route without measuring again. A
    missing or corrupt file reads as empty; a write merges the entries on
    disk under this instance's and replaces the file atomically (its own
    temporary file, so threads and processes never share one); a failed
    write never breaks routing. Instances on one path share a lock, so
    the threads of one process (the service's tenants share the default
    table) never interleave a merge; across processes the last writer
    wins per key."""

    def __init__(self, path: str | None = None):
        self.path = path or config.calibration_cache_path()
        self._mem: Dict[str, dict] = {}
        self._loaded = False
        self._lock = _path_lock(self.path)

    def _load(self) -> None:
        if not self._loaded:
            self._loaded = True
            self._mem.update(self._read_disk())

    def _read_disk(self) -> Dict[str, dict]:
        try:
            with open(self.path) as fh:
                data = json.load(fh)
            if isinstance(data, dict):
                return {k: v for k, v in data.items() if isinstance(v, dict)}
        except (OSError, json.JSONDecodeError, ValueError):
            pass
        return {}

    def get(self, key: str) -> dict | None:
        with self._lock:
            self._load()
            return self._mem.get(key)

    def put(self, key: str, value: dict) -> None:
        with self._lock:
            self._load()
            self._mem[key] = dict(value)
            tmp = None
            try:
                d = os.path.dirname(self.path) or "."
                os.makedirs(d, exist_ok=True)
                # another process may have kept shapes this one never loaded:
                # merge them under ours (last writer wins per key)
                merged = self._read_disk()
                merged.update(self._mem)
                self._mem = merged
                fd, tmp = tempfile.mkstemp(prefix=os.path.basename(self.path) + ".", dir=d)
                with os.fdopen(fd, "w") as fh:
                    json.dump(merged, fh, indent=0, sort_keys=True)
                os.replace(tmp, self.path)
            except OSError:
                if tmp is not None:
                    try:
                        os.unlink(tmp)
                    except OSError:
                        pass


_default_table_cache: Dict[str, CalibrationTable] = {}
_default_table_lock = threading.Lock()


def default_table() -> CalibrationTable:
    """The process's calibration table at the configured path (one a path,
    so ``DAS_CALIBRATION_CACHE`` pointed elsewhere gets its own)."""
    path = config.calibration_cache_path()
    with _default_table_lock:
        tab = _default_table_cache.get(path)
        if tab is None:
            tab = _default_table_cache[path] = CalibrationTable(path)
        return tab


def backend_key(device) -> str:
    """The backend part of every table key: ``cuda:<card name>`` on a CUDA
    device, else the device type (``cpu``)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(dev)}"
    return dev.type


def _on_card(backend: str) -> bool:
    return str(backend).startswith("cuda")


def _resolve(backend, device) -> Tuple[str, torch.device | None]:
    """``(backend key, device or None)``: the key from ``device`` when no
    ``backend`` is given (``None``: the card, as every entry point)."""
    if backend is not None:
        dev = None if device is None else resolve_device(device)
        return str(backend), dev
    dev = resolve_device(device)
    return backend_key(dev), dev


def _measure_on(backend: str, dev) -> torch.device:
    """The device a measurement runs on: the caller's, else the backend's."""
    return dev if dev is not None else resolve_device("cuda" if _on_card(backend) else "cpu")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _best_wall(fn, repeats: int = 2, device=None) -> float:
    """Best wall of ``repeats`` calls of ``fn`` after a warm-up call (cuFFT
    plans, cuDNN's algorithm choice), the card synchronised before each
    read of the clock."""
    dev = torch.device("cpu" if device is None else device)
    fn()
    _sync(dev)
    best = float("inf")
    for _ in range(max(1, repeats)):
        _sync(dev)
        t0 = time.perf_counter()
        fn()
        _sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best


#: A/B channel cap: both correlate engines are linear in channels, so the
#: comparison at <= 2048 rows decides the full shape.
_CAL_MAX_CHANNELS = 2048


def _rand(rng, shape, dev) -> torch.Tensor:
    return torch.as_tensor(rng.normal(size=shape).astype(np.float32), device=dev)


def calibrate_correlate(C: int, n: int, m: int, nT: int, *,
                        table: CalibrationTable | None = None, backend: str | None = None,
                        device=None, repeats: int = 2) -> dict:
    """A/B the float32 correlate engines (fft, matmul) at the shape on the
    device, measured once and kept in the table, at ``min(C, 2048)`` rows
    (``cal_channels``). The bf16 route is not a candidate (``"auto"``
    never takes it)."""
    table = table or default_table()
    backend, dev = _resolve(backend, device)
    key = f"correlate|{backend}|C{C}xN{n}|m{m}T{nT}"
    hit = table.get(key)
    if hit is not None:
        return hit
    dev = _measure_on(backend, dev)
    Cc = min(int(C), _CAL_MAX_CHANNELS)
    rng = np.random.default_rng(0)
    x = _rand(rng, (Cc, n), dev)
    tt = _rand(rng, (nT, m), dev)
    mu = torch.zeros((nT,), dtype=torch.float32, device=dev)
    sc = torch.ones((nT,), dtype=torch.float32, device=dev)
    entry = {"cal_channels": Cc}
    entry["fft_s"] = _best_wall(
        lambda: xcorr.compute_cross_correlograms_corrected(x, tt, mu, sc), repeats, dev)
    entry["matmul_s"] = _best_wall(
        lambda: compute_cross_correlograms_matmul(x, tt, mu, sc, bf16=False), repeats, dev)
    entry["winner"] = "fft" if entry["fft_s"] <= entry["matmul_s"] else "matmul"
    table.put(key, entry)
    return entry


def calibrate_fk(C: int, n: int, lo: int, hi: int, *, table: CalibrationTable | None = None,
                 backend: str | None = None, device=None, repeats: int = 2) -> dict:
    """A/B the banded f-k appliers (channel FFT pair against the DFT
    product) at the shape; measured once and kept. The DFT pair is built
    for the measurement and dropped."""
    table = table or default_table()
    backend, dev = _resolve(backend, device)
    key = f"fk|{backend}|C{C}xN{n}|band{hi - lo}"
    hit = table.get(key)
    if hit is not None:
        return hit
    dev = _measure_on(backend, dev)
    rng = np.random.default_rng(0)
    x = _rand(rng, (int(C), int(n)), dev)
    mb = torch.as_tensor(rng.uniform(size=(int(C), int(hi - lo))).astype(np.float32),
                         device=dev)
    wr, wi = (torch.as_tensor(a, device=dev) for a in dft_matrices(int(C)))
    entry = {
        "fft_s": _best_wall(
            lambda: fk_ops.fk_filter_apply_rfft_banded(x, mb, int(lo), int(hi)), repeats, dev),
        "matmul_s": _best_wall(
            lambda: fk_apply_dft_matmul(x, mb, int(lo), int(hi), wr, wi), repeats, dev),
    }
    del wr, wi
    entry["winner"] = "fft" if entry["fft_s"] <= entry["matmul_s"] else "matmul"
    table.put(key, entry)
    return entry


def calibrate_stft(C: int, n: int, nfft: int, hop: int, *,
                   table: CalibrationTable | None = None, backend: str | None = None,
                   device=None, repeats: int = 2) -> dict:
    """A/B the STFT-magnitude engines (the batched rFFT, the framed
    windowed-DFT matmul and, on a CUDA device, the ``fused_stft`` kernel)
    at the shape; measured once and kept, at ``min(C, 2048)`` rows."""
    table = table or default_table()
    backend, dev = _resolve(backend, device)
    key = f"stft|{backend}|C{C}xN{n}|nfft{nfft}h{hop}"
    hit = table.get(key)
    if hit is not None:
        return hit
    dev = _measure_on(backend, dev)
    Cc = min(int(C), _CAL_MAX_CHANNELS)
    rng = np.random.default_rng(0)
    x = _rand(rng, (Cc, int(n)), dev)
    entry = {"cal_channels": Cc}
    candidates = ("rfft", "matmul") + (("fused",) if _on_card(backend) else ())
    for eng in candidates:
        entry[f"{eng}_s"] = _best_wall(
            lambda e=eng: spectral.stft_magnitude(x, int(nfft), int(hop), engine=e),
            repeats, dev)
    entry["winner"] = min(candidates, key=lambda e: entry[f"{e}_s"])
    table.put(key, entry)
    return entry


def calibrate_gabor(H: int, W: int, m1: int, m2: int, *,
                    table: CalibrationTable | None = None, backend: str | None = None,
                    device=None, repeats: int = 2) -> dict:
    """A/B the 2-D same-correlation engines (the batched FFT product
    against ``F.conv2d``) at the binned-image and kernel shape; measured
    once and kept."""
    from . import image as image_ops

    table = table or default_table()
    backend, dev = _resolve(backend, device)
    key = f"gabor|{backend}|H{H}xW{W}|k{m1}x{m2}"
    hit = table.get(key)
    if hit is not None:
        return hit
    dev = _measure_on(backend, dev)
    rng = np.random.default_rng(0)
    img = _rand(rng, (int(H), int(W)), dev)
    ker = _rand(rng, (int(m1), int(m2)), dev)
    entry = {
        "fft_s": _best_wall(lambda: image_ops.filter2d_same(img, ker, engine="fft"),
                            repeats, dev),
        "conv_s": _best_wall(lambda: image_ops.filter2d_same(img, ker, engine="conv"),
                             repeats, dev),
    }
    entry["winner"] = "fft" if entry["fft_s"] <= entry["conv_s"] else "conv"
    table.put(key, entry)
    return entry


# ---------------------------------------------------------------------------
# The precision gates
# ---------------------------------------------------------------------------


def calibration_record(shape, templates_true, seed: int = 2408,
                       noise_rms: float = 0.02) -> np.ndarray:
    """The gates' fixed-seed record: noise with the ACTUAL templates
    injected at staggered channels and onsets and graded amplitudes
    (strong and near-threshold copies)."""
    C, n = int(shape[0]), int(shape[1])
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, noise_rms, size=(C, n)).astype(np.float32)
    tt = np.atleast_2d(np.asarray(templates_true, np.float32))
    nT, m = tt.shape
    k = 0
    for amp in (0.6, 0.25, 0.1):
        for i in range(nT):
            ch = (k * 7 + 3) % C
            onset = (k * (n // 7) + n // 11) % max(1, n - m)
            x[ch, onset : onset + m] += amp * tt[i]
            k += 1
    return x


def _gate_picks(corr: torch.Tensor, max_peaks: int = 64) -> peak_ops.SparsePicks:
    """The gates' engine-independent downstream: the reference threshold
    policy, the envelope and fixed-capacity sparse peaks."""
    from ..models.matched_filter import REL_THRESHOLD, reference_threshold_factors

    env = spectral.envelope_sqrt(corr, dim=-1)
    fac = torch.as_tensor(reference_threshold_factors(corr.shape[0]), device=corr.device)
    thr = (REL_THRESHOLD * corr.amax()) * fac.to(corr.dtype)
    return peak_ops.find_peaks_sparse_batched(env, thr[:, None], max_peaks=max_peaks,
                                              method="topk")


#: Gate-record channel cap: the gate's math is per channel, so 512 rows of
#: the record length decide eligibility.
_GATE_MAX_CHANNELS = 512


def _digest(*arrays) -> str:
    return hashlib.sha1(b"".join(np.ascontiguousarray(a, np.float32).tobytes()
                                 for a in arrays)).hexdigest()[:10]


def gate_key(backend, trace_shape, templates_true, mu, scale) -> str:
    """The bf16 gate's table key, with a digest of the template triple's
    CONTENT: two banks of equal shapes can gate differently."""
    tt = np.atleast_2d(np.asarray(templates_true))
    nT, m = tt.shape
    C, n = int(trace_shape[0]), int(trace_shape[1])
    return f"bf16gate|{backend}|C{C}xN{n}|m{m}T{nT}|t{_digest(tt, mu, scale)}"


def fused_gate_key(backend, trace_shape, templates_true, mu, scale, fir) -> str:
    """The tap-fold gate's table key: the bf16 key's content digest with
    the FIR in it, and its half-length in the key."""
    tt = np.atleast_2d(np.asarray(templates_true))
    h = np.asarray(fir)
    nT, m = tt.shape
    C, n = int(trace_shape[0]), int(trace_shape[1])
    L = (int(h.shape[0]) - 1) // 2
    return f"fusedgate|{backend}|C{C}xN{n}|m{m}T{nT}|L{L}|t{_digest(tt, mu, scale, h)}"


def _same_picks(ref, got) -> Tuple[bool, int, str, int]:
    """``(identical, differing count, what differs, reference picks)``."""
    ref_sel, got_sel = ref.selected.cpu().numpy(), got.selected.cpu().numpy()
    ref_pos, got_pos = ref.positions.cpu().numpy(), got.positions.cpu().numpy()
    if not np.array_equal(ref_sel, got_sel):
        return False, int((ref_sel != got_sel).sum()), "pick slots", int(ref_sel.sum())
    n_diff = int((ref_pos[ref_sel] != got_pos[ref_sel]).sum())
    return n_diff == 0, n_diff, "pick positions", int(ref_sel.sum())


def _gate_inputs(record, tt, mu, scale, dev) -> tuple:
    return (torch.as_tensor(np.asarray(record, np.float32), device=dev),
            torch.as_tensor(tt.astype(np.float32), device=dev),
            torch.as_tensor(np.asarray(mu, np.float32), device=dev),
            torch.as_tensor(np.asarray(scale, np.float32), device=dev))


def bf16_correlate_gate(trace_shape, templates_true, mu, scale, *,
                        table: CalibrationTable | None = None, backend: str | None = None,
                        device=None, record=None) -> Tuple[bool, str]:
    """Whether the bf16 matmul correlate may serve ``trace_shape``: its
    picks must be BITWISE the float32 FFT route's on the calibration
    record. Returns ``(eligible, reason)``, kept in the table per
    (backend, shape, template set); ``record`` overrides the fixed-seed
    record and bypasses the table (the tests pin both outcomes with it)."""
    table = table or default_table()
    backend, dev = _resolve(backend, device)
    tt = np.atleast_2d(np.asarray(templates_true))
    C, n = int(trace_shape[0]), int(trace_shape[1])
    key = gate_key(backend, trace_shape, tt, mu, scale)
    cached = record is None
    if cached:
        hit = table.get(key)
        if hit is not None:
            return bool(hit["eligible"]), str(hit["reason"])
        record = calibration_record((min(C, _GATE_MAX_CHANNELS), n), tt)
    x, tt_d, mu_d, sc_d = _gate_inputs(record, tt, mu, scale, _measure_on(backend, dev))
    ref = _gate_picks(xcorr.compute_cross_correlograms_corrected(x, tt_d, mu_d, sc_d))
    got = _gate_picks(compute_cross_correlograms_matmul(x, tt_d, mu_d, sc_d, bf16=True))
    same, n_diff, what, n_ref = _same_picks(ref, got)
    if same:
        eligible, reason = True, (
            f"picks bit-identical to the f32 FFT route on the [{x.shape[0]}x{n}] "
            f"calibration record ({n_ref} picks)")
    else:
        eligible, reason = False, (
            f"{n_diff} {what} differ from the f32 FFT route on the [{x.shape[0]}x{n}] "
            f"calibration record ({n_ref} f32 picks)")
    if cached:
        table.put(key, {"eligible": eligible, "reason": reason})
    return eligible, reason


def fused_correlate_gate(trace_shape, templates_true, mu, scale, fir, gain_n, *,
                         table: CalibrationTable | None = None, backend: str | None = None,
                         device=None, record=None) -> Tuple[bool, str]:
    """Whether the tap-folded correlate may serve ``trace_shape``: its
    picks (raw record -> folded contraction) must be BITWISE the staged
    route's (the circular gain ``gain_n`` at the record length, then the
    float32 FFT correlate) on the calibration record. They differ by the
    FIR's truncation and by linear against circular edges, so this is a
    measured verdict per (backend, shape, template set, FIR), kept like
    :func:`bf16_correlate_gate`'s."""
    from .filters import fft_zero_phase_apply

    table = table or default_table()
    backend, dev = _resolve(backend, device)
    tt = np.atleast_2d(np.asarray(templates_true))
    C, n = int(trace_shape[0]), int(trace_shape[1])
    key = fused_gate_key(backend, trace_shape, tt, mu, scale, fir)
    cached = record is None
    if cached:
        hit = table.get(key)
        if hit is not None:
            return bool(hit["eligible"]), str(hit["reason"])
        record = calibration_record((min(C, _GATE_MAX_CHANNELS), n), tt)
    dev = _measure_on(backend, dev)
    x, tt_d, mu_d, sc_d = _gate_inputs(record, tt, mu, scale, dev)
    gain_d = torch.as_tensor(np.asarray(gain_n, np.float32), device=dev)
    folded, tcum, L = fused_template_taps(tt, fir)
    g_ref = fft_zero_phase_apply(x, gain_d, 0)
    ref = _gate_picks(xcorr.compute_cross_correlograms_corrected(g_ref, tt_d, mu_d, sc_d))
    got = _gate_picks(compute_cross_correlograms_fused(
        x, tt_d, torch.as_tensor(folded, device=dev), torch.as_tensor(tcum, device=dev),
        mu_d, sc_d, L))
    same, n_diff, what, n_ref = _same_picks(ref, got)
    if same:
        eligible, reason = True, (
            f"picks bit-identical to the staged f32 route on the [{x.shape[0]}x{n}] "
            f"calibration record ({n_ref} picks; L={L})")
    else:
        eligible, reason = False, (
            f"{n_diff} {what} differ from the staged f32 route on the [{x.shape[0]}x{n}] "
            f"calibration record ({n_ref} staged picks; L={L})")
    if cached:
        table.put(key, {"eligible": eligible, "reason": reason})
    return eligible, reason


def calibrate_correlate_fused(C: int, n: int, m: int, nT: int, L: int, *,
                              table: CalibrationTable | None = None,
                              backend: str | None = None, device=None,
                              repeats: int = 2) -> dict:
    """A/B the STAGED chain (circular-gain bandpass + float32 FFT
    correlate) against the tap-folded contraction at the shape, on
    synthetic taps at the real ``(m, L)``; measured once and kept. The
    verdict compares walls; eligibility is the gate's."""
    from .filters import fft_zero_phase_apply

    table = table or default_table()
    backend, dev = _resolve(backend, device)
    key = f"correlate-fused|{backend}|C{C}xN{n}|m{m}T{nT}|L{L}"
    hit = table.get(key)
    if hit is not None:
        return hit
    dev = _measure_on(backend, dev)
    Cc = min(int(C), _CAL_MAX_CHANNELS)
    rng = np.random.default_rng(0)
    x = _rand(rng, (Cc, n), dev)
    tt_np = rng.normal(size=(nT, m)).astype(np.float32)
    tt = torch.as_tensor(tt_np, device=dev)
    mu = torch.zeros((nT,), dtype=torch.float32, device=dev)
    sc = torch.ones((nT,), dtype=torch.float32, device=dev)
    gain = torch.as_tensor(rng.uniform(size=(n // 2 + 1,)).astype(np.float32), device=dev)
    h = rng.normal(size=(2 * int(L) + 1,)).astype(np.float32)
    folded, tcum, _ = fused_template_taps(tt_np, h)
    folded_d, tcum_d = (torch.as_tensor(a, device=dev) for a in (folded, tcum))

    def staged():
        g = fft_zero_phase_apply(x, gain, 0)
        return xcorr.compute_cross_correlograms_corrected(g, tt, mu, sc)

    entry = {"cal_channels": Cc}
    entry["staged_s"] = _best_wall(staged, repeats, dev)
    entry["fused_s"] = _best_wall(
        lambda: compute_cross_correlograms_fused(x, tt, folded_d, tcum_d, mu, sc, int(L)),
        repeats, dev)
    entry["winner"] = "matmul-fused" if entry["fused_s"] < entry["staged_s"] else "staged"
    table.put(key, entry)
    return entry


# ---------------------------------------------------------------------------
# The engine routers
# ---------------------------------------------------------------------------


def _no_mxu(backend: str, route: str = "FFT") -> str:
    return f"auto: backend {backend!r} has no MXU; {route} route"


def resolve_mf_engine(requested, trace_shape, templates_true, mu, scale, *,
                      table: CalibrationTable | None = None, backend: str | None = None,
                      device=None, fused_design=None) -> Tuple[str, str]:
    """The correlate engine for a detector at ``trace_shape``: ``(engine,
    reason)``.

    ``requested``: ``"fft"``/``"matmul"`` (forced), ``"matmul-bf16"``/
    ``"matmul-fused"`` (forced but gated: an ineligible shape falls back
    to the float32 matmul with the gate's reason), ``"auto"``, or None
    (``config.mf_engine_default``: ``DAS_MF_ENGINE``, else ``"fft"``).
    ``"auto"`` is the FFT route off a CUDA device; on the card the A/B
    picks the faster of fft and matmul, and the tap-folded engine (only
    with ``fused_design``, the ``(fir, gain_n)`` pair of the detector's
    bandpass) needs its gate AND a staged-against-fused A/B win. It never
    takes ``"matmul-bf16"``: the port's bf16 route is the float32
    contraction of rounded inputs, never faster than ``"matmul"`` (the
    JAX package's router weighs it where bf16 has its own MXU path)."""
    req = requested or config.mf_engine_default()
    if req in ("fft", "matmul"):
        return req, "forced"
    tt = np.atleast_2d(np.asarray(templates_true))
    nT, m = tt.shape
    if req == "matmul-bf16":
        ok, why = bf16_correlate_gate(trace_shape, tt, mu, scale, table=table,
                                      backend=backend, device=device)
        if ok:
            return "matmul-bf16", f"forced; precision gate passed: {why}"
        return "matmul", f"bf16 ineligible, f32 matmul fallback: {why}"
    if req == "matmul-fused":
        if fused_design is None:
            return "matmul", ("matmul-fused unavailable without the bandpass FIR "
                              "(fused_design); f32 matmul fallback")
        fir, gain_n = fused_design
        ok, why = fused_correlate_gate(trace_shape, tt, mu, scale, fir, gain_n, table=table,
                                       backend=backend, device=device)
        if ok:
            return "matmul-fused", f"forced; precision gate passed: {why}"
        return "matmul", f"fused-taps ineligible, f32 matmul fallback: {why}"
    if req != "auto":
        raise ValueError(f"unknown mf_engine {req!r}; expected one of "
                         f"{MF_ENGINES + ('auto',)}")
    backend, dev = _resolve(backend, device)
    if not _on_card(backend):
        return "fft", _no_mxu(backend)
    C, n = int(trace_shape[0]), int(trace_shape[1])
    ab = calibrate_correlate(C, n, m, nT, table=table, backend=backend, device=dev)
    if fused_design is not None:
        fir, gain_n = fused_design
        L = (int(np.asarray(fir).shape[0]) - 1) // 2
        abf = calibrate_correlate_fused(C, n, m, nT, L, table=table, backend=backend,
                                        device=dev)
        if abf["winner"] == "matmul-fused":
            ok, why = fused_correlate_gate(trace_shape, tt, mu, scale, fir, gain_n,
                                           table=table, backend=backend, device=dev)
            if ok:
                return "matmul-fused", (f"auto: A/B fused {abf['fused_s']:.4g}s < staged "
                                        f"{abf['staged_s']:.4g}s; precision gate passed: "
                                        f"{why}")
    if ab["winner"] == "fft":
        return "fft", f"auto: A/B fft {ab['fft_s']:.4g}s <= matmul {ab['matmul_s']:.4g}s"
    return "matmul", f"auto: A/B matmul {ab['matmul_s']:.4g}s < fft {ab['fft_s']:.4g}s"


def resolve_fk_engine(requested, n_channels, time_samples, band, *,
                      table: CalibrationTable | None = None, backend: str | None = None,
                      device=None) -> Tuple[str, str]:
    """The f-k apply engine at ``n_channels`` (the f-k transform's count,
    padded for a channel-padded design): ``"fft"``/``"matmul"`` forced
    (the caller owns the ``[C, C]`` matrices' memory), ``"auto"``, or None
    (``config.fk_engine_default``). ``"auto"``: the FFT route off a CUDA
    device; on the card the matmul only at or below
    ``config.fk_matmul_max_channels()`` AND where the A/B says it wins."""
    req = requested or config.fk_engine_default()
    if req in FK_ENGINES:
        return req, "forced"
    if req != "auto":
        raise ValueError(f"unknown fk_engine {req!r}; expected one of "
                         f"{FK_ENGINES + ('auto',)}")
    backend, dev = _resolve(backend, device)
    if not _on_card(backend):
        return "fft", _no_mxu(backend)
    C = int(n_channels)
    cap = config.fk_matmul_max_channels()
    if C > cap:
        return "fft", (f"auto: C={C} above DAS_FK_MATMUL_MAX_CHANNELS={cap} "
                       f"(O(C^2) DFT matrix; FFT route)")
    ab = calibrate_fk(C, int(time_samples), 0, int(band), table=table, backend=backend,
                      device=dev)
    if ab["winner"] == "matmul":
        return "matmul", f"auto: A/B matmul {ab['matmul_s']:.4g}s < fft {ab['fft_s']:.4g}s"
    return "fft", f"auto: A/B fft {ab['fft_s']:.4g}s <= matmul {ab['matmul_s']:.4g}s"


def requested_stft_engine(requested) -> str:
    """A spectro detector's STFT engine request with the default applied:
    the caller's, else ``DAS4WHALES_STFT_ENGINE``, else ``"fused"`` (the
    ``fused_stft`` kernel)."""
    return requested or os.environ.get("DAS4WHALES_STFT_ENGINE", "") or "fused"


def resolve_stft_engine_ab(requested, n_channels, time_samples, nfft, hop, *,
                           table: CalibrationTable | None = None, backend: str | None = None,
                           device=None) -> Tuple[str, str]:
    """The STFT-magnitude engine at the spectro sweep's shape: ``"rfft"``/
    ``"matmul"``/``"fused"`` forced, ``"auto"``, or None
    (:func:`requested_stft_engine`). ``"auto"``: the rFFT route off a CUDA
    device; on the card the fastest of rfft, matmul and fused by the A/B."""
    req = requested_stft_engine(requested)
    if req in spectral.STFT_ENGINES:
        return req, "forced"
    if req != "auto":
        raise ValueError(f"unknown stft engine {req!r}; expected one of "
                         f"{spectral.STFT_ENGINES + ('auto',)}")
    backend, dev = _resolve(backend, device)
    if not _on_card(backend):
        return "rfft", _no_mxu(backend, "rFFT")
    ab = calibrate_stft(int(n_channels), int(time_samples), int(nfft), int(hop), table=table,
                        backend=backend, device=dev)
    win = ab["winner"]
    detail = ", ".join(f"{e} {ab[f'{e}_s']:.4g}s" for e in ("rfft", "matmul", "fused")
                       if f"{e}_s" in ab)
    return win, f"auto: A/B {win} wins ({detail})"


def requested_gabor_engine(requested) -> str:
    """The Gabor family's engine request with the default applied: the
    caller's, else ``DAS_GABOR_ENGINE``, else ``"fft"``."""
    return requested or os.environ.get("DAS_GABOR_ENGINE", "") or "fft"


def resolve_gabor_engine(requested, image_shape, kernel_shape, *,
                         table: CalibrationTable | None = None, backend: str | None = None,
                         device=None) -> Tuple[str, str]:
    """The Gabor family's 2-D same-correlation engine at the binned image
    its oriented pair sweeps: ``"fft"``/``"conv"`` forced, ``"auto"``, or
    None (:func:`requested_gabor_engine`). ``"auto"``: FFT off a CUDA
    device; on the card the A/B decides."""
    from . import image as image_ops

    req = requested_gabor_engine(requested)
    if req in image_ops.FILTER2D_ENGINES:
        return req, "forced"
    if req != "auto":
        raise ValueError(f"unknown gabor engine {req!r}; expected one of "
                         f"{image_ops.FILTER2D_ENGINES + ('auto',)}")
    backend, dev = _resolve(backend, device)
    if not _on_card(backend):
        return "fft", _no_mxu(backend)
    H, W = int(image_shape[0]), int(image_shape[1])
    m1, m2 = int(kernel_shape[0]), int(kernel_shape[1])
    ab = calibrate_gabor(H, W, m1, m2, table=table, backend=backend, device=dev)
    if ab["winner"] == "conv":
        return "conv", f"auto: A/B conv {ab['conv_s']:.4g}s < fft {ab['fft_s']:.4g}s"
    return "fft", f"auto: A/B fft {ab['fft_s']:.4g}s <= conv {ab['conv_s']:.4g}s"


def engine_labels(detector) -> Dict[str, str]:
    """The resolved engine labels a detector rides (empty for families
    without engine routing), for the ladder's downshift events and the
    cost cards."""
    out = {}
    for attr in ("mf_engine", "fk_engine", "pick_engine", "stft_engine", "gabor_engine"):
        val = getattr(detector, attr, None)
        if val:
            out[attr] = str(val)
    return out
