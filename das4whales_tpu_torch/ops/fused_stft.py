"""|STFT|² kernel: wrapper, plain version and the windowed DFT matrix.

The counterpart of ``das4whales_tpu.ops.pallas_stft``. The kernel is
CUDA C++ for Hopper (``csrc/fused_stft.cu``, built by ``utils.build`` at
first use): every frame's windowed real DFT against ``_dft_matrix``,
folded by the real DFT's two symmetries (it reads rows n <= nfft/2 and
columns k <= nfft/4 of the matrix), the frames built in shared memory
from the span they cover, the power ``re² + im²`` fused before the
write. Its plain version, :func:`stft_power_plain`, is ``F.pad`` +
``unfold`` + ``torch.matmul`` against the same matrix (all of it,
unfolded). Both compute librosa's
conventions (periodic Hann, centred zero padding,
``n_frames = 1 + T // hop``) and return ``[C, nfft//2 + 1, n_frames]``
float32 power.

Routing is by the tensor's device and nothing else: a CUDA tensor
launches the kernel (or the call raises), a CPU tensor runs the plain
version. There is no fallback from the kernel to the plain version and
no switch that sends a CUDA tensor to it.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

#: Launches of the CUDA kernel in this process: the wrapper adds one per
#: launch and nowhere else. ``chip_smoke.py`` zeroes and reads it to show
#: that a run went through the kernel.
launches = 0


def _dft_matrix(nfft: int, window: np.ndarray) -> np.ndarray:
    """Windowed real-DFT matrix ``[nfft, 2F]`` with cos|sin halves,
    ``F = nfft//2 + 1``: float64 angles on the host, cast to float32
    once, so that the kernel and its plain version share the
    coefficients. ``x @ M`` gives (re | -im) of ``rfft(x * win)`` — the
    sign of im cancels in the power."""
    k = np.arange(nfft)[:, None]
    f = np.arange(nfft // 2 + 1)[None, :]
    ang = 2.0 * np.pi * k * f / nfft
    cos = np.cos(ang) * window[:, None]
    sin = np.sin(ang) * window[:, None]
    return np.concatenate([cos, sin], axis=1).astype(np.float32)


def _window(nfft: int, window: str) -> np.ndarray:
    if window == "hann":
        # periodic Hann, librosa/stft parity
        return 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(nfft) / nfft))
    if window == "ones":
        return np.ones(nfft)
    raise ValueError(f"unknown window {window!r}")


@functools.lru_cache(maxsize=16)
def dft_tensor(nfft: int, window: str, device: torch.device) -> torch.Tensor:
    """:func:`_dft_matrix` on ``device``, made once per (nfft, window,
    device): a host-to-device copy per call would stall the stream."""
    return torch.as_tensor(_dft_matrix(nfft, _window(nfft, window)), device=device)


def n_frames(n: int, nfft: int, hop: int, center: bool = True) -> int:
    """Frames of an ``n``-sample signal: ``1 + n//hop`` centred, else
    ``1 + (n - nfft)//hop``."""
    return 1 + (n // hop if center else (n - nfft) // hop)


def _check_args(x: torch.Tensor, nfft: int, hop: int, window: str, center: bool) -> None:
    """The argument checks of the JAX kernel's ``stft_power``."""
    if x.ndim != 2:
        raise ValueError(f"expected [channel x time], got shape {tuple(x.shape)}")
    if hop < 1 or hop > nfft:
        raise ValueError(f"need 1 <= hop <= nfft, got hop={hop}, nfft={nfft}")
    if not center and x.shape[-1] < nfft:
        raise ValueError(
            f"center=False needs at least nfft={nfft} samples, got {x.shape[-1]}"
        )
    _window(nfft, window)


def _lib():
    from ..utils import build

    lib = build.load("fused_stft")
    lib.fused_stft_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.fused_stft_launch.restype = ctypes.c_int
    lib.fused_stft_error_string.argtypes = [ctypes.c_int]
    lib.fused_stft_error_string.restype = ctypes.c_char_p
    return lib


def stft_power_cuda(x: torch.Tensor, nfft: int, hop: int, *, window: str = "hann",
                    center: bool = True) -> torch.Tensor:
    """Launch the CUDA kernel on ``x [C, T]`` float32 (contiguous, on a
    CUDA device), on the current stream. Raises on what the kernel does
    not take and on a refused launch."""
    global launches
    if not x.is_cuda:
        raise ValueError(f"the CUDA STFT kernel needs a CUDA tensor, got one on {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous float32 tensor, got {x.dtype} "
                         f"(contiguous: {x.is_contiguous()})")
    _check_args(x, nfft, hop, window, center)
    C, T = x.shape
    M = dft_tensor(nfft, window, x.device)
    out = torch.empty((C, nfft // 2 + 1, n_frames(T, nfft, hop, center)),
                      dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.fused_stft_launch(x.data_ptr(), M.data_ptr(), out.data_ptr(),
                                   C, T, nfft, hop, int(center), stream)
    if rc != 0:
        raise RuntimeError(
            f"fused_stft kernel launch failed at C={C}, T={T}, nfft={nfft}, hop={hop}: "
            f"{lib.fused_stft_error_string(rc).decode()}"
        )
    launches += 1
    return out


def stft_power_plain(x: torch.Tensor, nfft: int, hop: int, *, window: str = "hann",
                     center: bool = True) -> torch.Tensor:
    """The kernel's plain PyTorch version, on any device: ``F.pad`` for
    the centring, ``unfold`` for the frames, ``torch.matmul`` with the
    same DFT matrix, ``re² + im²`` moved to ``[C, F, n_frames]``."""
    _check_args(x, nfft, hop, window, center)
    T = x.shape[-1]
    nf = n_frames(T, nfft, hop, center)
    xp = F.pad(x, (nfft // 2, nfft // 2)) if center else x
    need = (nf - 1) * hop + nfft
    if xp.shape[-1] < need:
        xp = F.pad(xp, (0, need - xp.shape[-1]))
    frames = xp.unfold(-1, nfft, hop)[:, :nf]               # [C, nf, nfft]
    prod = torch.matmul(frames, dft_tensor(nfft, window, x.device))
    F_ = nfft // 2 + 1
    re, im = prod[..., :F_], prod[..., F_:]
    return (re * re + im * im).transpose(1, 2).contiguous()


def stft_power(x: torch.Tensor, nfft: int, hop: int, *, window: str = "hann",
               center: bool = True) -> torch.Tensor:
    """``|STFT|²`` of a ``[channel x time]`` block, float32: the CUDA
    kernel on a CUDA tensor, its plain version on a CPU tensor. Raises
    ``ValueError`` on the JAX kernel's argument errors."""
    x = x.to(torch.float32).contiguous()
    if x.is_cuda:
        return stft_power_cuda(x, nfft, hop, window=window, center=center)
    if x.device.type == "cpu":
        return stft_power_plain(x, nfft, hop, window=window, center=center)
    raise ValueError(f"no STFT route for device {x.device}")
