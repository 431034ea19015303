"""Fused envelope -> threshold -> prominence -> slot pick kernel: wrapper.

The counterpart of ``das4whales_tpu.ops.pallas_picks``. The kernel is
CUDA C++ for Hopper (``csrc/fused_picks.cu``, built by
``utils.build`` at first use); its plain version is this package's
``envelope`` + ``ops.peaks.find_peaks_sparse_batched`` route. Both give
the same five outputs, bit for bit.

Routing is by the tensor's device and nothing else: a CUDA tensor
launches the kernel (or the call raises), a CPU tensor runs the plain
version. There is no fallback from the kernel to the plain version and
no switch that sends a CUDA tensor to it. The Hilbert transform stays
outside the kernel, on ``torch.fft``, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import peaks as peak_ops
from . import spectral

#: Launches of the CUDA kernel in this process: the wrapper adds one per
#: launch and nowhere else. ``chip_smoke.py`` zeroes and reads it to show
#: that a run went through the kernel.
launches = 0

_METHODS = {"pack": 0, "topk": 1}

#: The kernel's phases, in order, as the timed instantiation stamps them.
PHASES = ("load", "tables+maxima", "candidates", "slots", "prominences", "outputs")


@functools.lru_cache(maxsize=None)
def _lib():
    from ..utils import build

    lib = build.load("fused_picks")
    lib.fused_picks_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.fused_picks_launch.restype = ctypes.c_int
    lib.fused_picks_launch_timed.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2)
    lib.fused_picks_launch_timed.restype = ctypes.c_int
    lib.fused_picks_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.fused_picks_smem_bytes.restype = ctypes.c_longlong
    lib.fused_picks_smem_limit.argtypes = []
    lib.fused_picks_smem_limit.restype = ctypes.c_int
    lib.fused_picks_ctas_per_sm.argtypes = [ctypes.c_int] * 4
    lib.fused_picks_ctas_per_sm.restype = ctypes.c_int
    lib.fused_picks_error_string.argtypes = [ctypes.c_int]
    lib.fused_picks_error_string.restype = ctypes.c_char_p
    return lib


def picks_cuda(X: torch.Tensor, thr: torch.Tensor, max_peaks: int,
               method: str, nb: int = 128) -> peak_ops.SparsePicks:
    """Launch the CUDA kernel on ``X [rows, T]`` complex64 (read in place
    as float2) with per-row thresholds
    ``thr [rows]``, on the current stream. Raises on what the kernel does
    not take and on a refused launch."""
    return _launch(X, thr, max_peaks, method, nb, timed=False)[0]


def picks_cuda_timed(X: torch.Tensor, thr: torch.Tensor, max_peaks: int,
                     method: str, nb: int = 128):
    """:func:`picks_cuda` through the kernel's phase-timed instantiation:
    the same outputs, and ``stamps [rows, 2, len(PHASES) + 1]`` int64 —
    per CTA, thread 0's ``%globaltimer`` (ns) and then ``clock64``
    (cycles) at the start and after each phase of :data:`PHASES`. For
    measurement only; the detectors never call it."""
    return _launch(X, thr, max_peaks, method, nb, timed=True)


def ctas_per_sm(T: int, max_peaks: int, method: str, nb: int = 128) -> int:
    """CTAs of the kernel that fit on one SM at once for rows of ``T``
    samples (CUDA's occupancy calculator: registers, threads, shared
    memory)."""
    n = _lib().fused_picks_ctas_per_sm(T, min(int(max_peaks), T), _METHODS[method], nb)
    if n < 0:
        raise RuntimeError("fused_picks: the occupancy query failed")
    return n


def smem_bytes(T: int, max_peaks: int, method: str, nb: int = 128) -> int:
    """Shared memory of one CTA for rows of ``T`` samples, in the layout
    its method launches with (what bounds :func:`ctas_per_sm` at long
    rows: the envelope alone takes ``4 T`` bytes)."""
    return int(_lib().fused_picks_smem_bytes(T, min(int(max_peaks), T), _METHODS[method], nb))


@functools.lru_cache(maxsize=None)
def _check_fits(T: int, K: int, method: str, nb: int, device_index: int) -> None:
    """Raise unless one CTA's shared memory for this shape, in the layout
    its method launches with, fits the device's opt-in limit; a shape is
    checked once a device."""
    lib = _lib()
    with torch.cuda.device(device_index):
        need = lib.fused_picks_smem_bytes(T, K, _METHODS[method], nb)
        limit = lib.fused_picks_smem_limit()
    if need > limit:
        raise ValueError(
            f"a row of T={T} samples at K={K} ({method}) needs {need} bytes of "
            f"shared memory; this device allows {limit} per block. Longer "
            "records come with a later slice of the port"
        )


def _launch(X, thr, max_peaks, method, nb, timed):
    global launches
    if not X.is_cuda:
        raise ValueError(f"the CUDA pick kernel needs a CUDA tensor, got one on {X.device}")
    if X.dtype != torch.complex64 or X.ndim != 2:
        raise ValueError(f"X must be a [rows, T] complex64 tensor, got {X.dtype} {tuple(X.shape)}")
    if method not in _METHODS:
        raise ValueError(f"unknown method {method!r}")
    idx = X.get_device()
    if idx != torch.cuda.current_device():  # a launch goes to the current device
        with torch.cuda.device(idx):
            return _launch(X, thr, max_peaks, method, nb, timed)
    # A launch at the main path's shape takes less time on the card than
    # this function on the host, so it keeps to the calls it needs: the fit
    # check is cached, the stream is read raw, and the five outputs are
    # views of two allocations (an allocation costs the host about what the
    # launch does).
    rows, T = X.shape
    K = min(int(max_peaks), T)
    _check_fits(T, K, method, nb, idx)
    X = X.contiguous()  # complex64 is interleaved (re, im): the kernel's float2
    thr = thr.to(device=X.device, dtype=torch.float32).contiguous()
    dev = X.device
    pos, heights, prom = torch.empty((3, rows, K), dtype=torch.int32, device=dev).unbind(0)
    heights, prom = heights.view(torch.float32), prom.view(torch.float32)
    sel, sat = torch.empty((rows * K + rows,), dtype=torch.bool, device=dev).split(
        [rows * K, rows])
    sel = sel.view(rows, K)
    stamps = (torch.empty((rows, 2, len(PHASES) + 1), dtype=torch.int64, device=dev)
              if timed else None)
    args = (X.data_ptr(), thr.data_ptr(), pos.data_ptr(), heights.data_ptr(),
            prom.data_ptr(), sel.data_ptr(), sat.data_ptr(),
            rows, T, K, _METHODS[method], nb)
    stream = torch._C._cuda_getCurrentRawStream(idx)
    lib = _lib()
    rc = (lib.fused_picks_launch_timed(*args, stamps.data_ptr(), stream) if timed
          else lib.fused_picks_launch(*args, stream))
    if rc != 0:
        raise RuntimeError(
            f"fused_picks kernel launch failed: {lib.fused_picks_error_string(rc).decode()}"
        )
    launches += 1
    return peak_ops.SparsePicks(pos, heights, prom, sel, sat), stamps


def picks_plain(X: torch.Tensor, thr: torch.Tensor, max_peaks: int,
                method: str, nb: int = 128) -> peak_ops.SparsePicks:
    """The kernel's plain PyTorch version, on any device: the envelope
    ``sqrt(re*re + im*im)`` and ``find_peaks_sparse_batched``."""
    env = spectral.magnitude_sqrt(X)
    return peak_ops.find_peaks_sparse_batched(
        env, thr.to(env.dtype), max_peaks=max_peaks, nb=nb, method=method
    )


def _envelope_peaks(X: torch.Tensor, threshold, max_peaks: int, nb: int,
                    method: str) -> peak_ops.SparsePicks:
    """Route ``X [..., T]`` complex by its device: CUDA -> kernel, CPU ->
    plain version. Leading axes flatten into rows and come back."""
    lead = tuple(X.shape[:-1])
    T = X.shape[-1]
    rows = int(np.prod(lead)) if lead else 1
    thr = torch.as_tensor(threshold, dtype=torch.float32, device=X.device)
    thr = thr.expand(lead).reshape(rows)
    X2 = X.reshape(rows, T)
    if X.is_cuda:
        sp = picks_cuda(X2, thr, max_peaks, method, nb)
    elif X.device.type == "cpu":
        sp = picks_plain(X2, thr, max_peaks, method, nb)
    else:
        raise ValueError(f"no pick route for device {X.device}")
    K = sp.positions.shape[-1]
    return peak_ops.SparsePicks(
        sp.positions.reshape(lead + (K,)), sp.heights.reshape(lead + (K,)),
        sp.prominences.reshape(lead + (K,)), sp.selected.reshape(lead + (K,)),
        sp.saturated.reshape(lead),
    )


def envelope_peaks_sparse(re: torch.Tensor, im: torch.Tensor, threshold,
                          max_peaks: int = 256, nb: int = 128,
                          method: str = "topk") -> peak_ops.SparsePicks:
    """Fused envelope + picks over the analytic signal's ``(re, im)``
    parts, ``[..., T]`` float32; ``threshold`` broadcasts to
    ``re.shape[:-1]``. Identical to ``find_peaks_sparse_batched(
    sqrt(re² + im²), threshold, ...)``."""
    if re.shape != im.shape:
        raise ValueError(f"re/im shape mismatch: {tuple(re.shape)} vs {tuple(im.shape)}")
    X = torch.complex(re.to(torch.float32), im.to(torch.float32))
    return _envelope_peaks(X, threshold, max_peaks, nb, method)


def analytic_envelope_peaks(corr: torch.Tensor, threshold, max_peaks: int = 256,
                            nb: int = 128, method: str = "topk") -> peak_ops.SparsePicks:
    """The detection route's pick stage: the Hilbert analytic signal of
    real ``corr [..., T]`` on ``torch.fft``, then the fused kernel (or its
    plain version on the CPU)."""
    X = spectral.analytic_signal(corr, dim=-1)
    return _envelope_peaks(X, threshold, max_peaks, nb, method)
