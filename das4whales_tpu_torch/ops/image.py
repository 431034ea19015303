"""Image operations of the Gabor/image detector family (the port's copy of
the part of ``das4whales_tpu.ops.image`` the Gabor detector runs).

The reference treats the f-k-filtered envelope as an image
(improcess.py): min-max scaling, OpenCV-convention Gabor kernels, 2-D
``cv2.filter2D`` correlation, Gaussian smoothing of a mask, and a
bilinear resize. Here they run on ``torch`` (``torch.fft`` for the FFT
correlation, ``F.conv2d`` for the ``"conv"`` engine, ``F.interpolate``
for the resizes), batched over leading axes.

Differences of procedure from the JAX package, none of result:

* reflect and symmetric borders gather through an index map made by
  ``np.pad`` on the host (:func:`pad2d`): ``jnp.pad`` reflects again
  where a pad is wider than the axis, ``torch.nn.functional.pad``
  refuses such a pad and has no symmetric mode;
* the per-image reductions (:func:`scale_pixels`, the renormalisation of
  :func:`apply_smooth_mask`) run over the last two axes, so a leading
  file axis keeps each file's own scale, as JAX's ``vmap`` of the
  detector does; on one image they are JAX's global reductions.

``jnp.std`` has ``ddof=0``: ``torch.std`` is called with
``correction=0``.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .spectral import analytic_signal
from .xcorr import fftconvolve2d_same

# ---------------------------------------------------------------------------
# Intensity scaling (improcess.py:23-63)
# ---------------------------------------------------------------------------


def scale_pixels(img: torch.Tensor) -> torch.Tensor:
    """Min-max scale each image (the last two axes) to [0, 1]
    (improcess.py:23-41)."""
    lo = img.amin(dim=(-2, -1), keepdim=True)
    hi = img.amax(dim=(-2, -1), keepdim=True)
    return (img - lo) / (hi - lo)


def trace2image(trace: torch.Tensor) -> torch.Tensor:
    """Per-channel std-normalized Hilbert envelope scaled to [0, 255]
    (improcess.py:44-63)."""
    env = torch.abs(analytic_signal(trace, dim=-1))
    img = env / trace.std(dim=-1, keepdim=True, correction=0)
    return scale_pixels(img) * 255.0


def angle_fromspeed(c0: float, fs: float, dx: float, selected_channels,
                    verbose: bool = False) -> float:
    """Orientation (degrees) of a c0-speed wavefront in the decimated t-x
    image (improcess.py:66-95)."""
    step = selected_channels[2] if not np.isscalar(selected_channels) else selected_channels
    ratio = c0 / (fs * dx * step)
    theta = float(np.arctan(ratio) * 180 / np.pi)
    if verbose:
        print("Detection speed ratio: ", ratio)
        print("Angle: ", theta)
    return theta


# ---------------------------------------------------------------------------
# Kernels and convolutions
# ---------------------------------------------------------------------------


def gabor_kernel(ksize: int, sigma: float, theta: float, lambd: float, gamma: float,
                 psi: float = 0.0) -> np.ndarray:
    """Gabor kernel with OpenCV ``getGaborKernel`` conventions, its index
    flip included (improcess.py:116-124): ``2 * (ksize // 2) + 1`` square,
    101 x 101 for the reference's ``ksize=100``. Host float64."""
    xmax = ksize // 2
    n = 2 * xmax + 1
    ii, jj = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    y = xmax - ii
    x = xmax - jj
    xr = x * np.cos(theta) + y * np.sin(theta)
    yr = -x * np.sin(theta) + y * np.cos(theta)
    return np.exp(-(xr**2 + (gamma * yr) ** 2) / (2 * sigma**2)) * np.cos(2 * np.pi * xr / lambd + psi)


def gabor_filt_design(theta_c0: float, ksize: int = 100, sigma: float = 4.0,
                      lambd: float = 20.0, gamma: float = 0.15) -> Tuple[np.ndarray, np.ndarray]:
    """Up/down Gabor pair oriented along the sound-speed slope
    (improcess.py:98-140: theta = pi/2 + theta_c0, down = flipud(up))."""
    theta = np.pi / 2 + np.deg2rad(theta_c0)
    up = gabor_kernel(ksize, sigma, theta, lambd, gamma)
    return up, np.flipud(up)


#: 2-D same-correlation engines: ``fft`` the batched-FFT product, ``conv``
#: ``F.conv2d`` (float32 accumulation, TF32 off: ``utils.device``).
FILTER2D_ENGINES = ("fft", "conv")


@functools.lru_cache(maxsize=64)
def _pad_index(n: int, lo: int, hi: int, mode: str, device: torch.device) -> torch.Tensor:
    """The source index of every sample of an axis of length ``n`` padded
    by ``(lo, hi)`` in numpy's ``mode``, as an int64 tensor on ``device``,
    made once per shape and device (a host-to-device copy would wait for
    the stream at every call). A pad wider than the axis reflects again,
    as numpy and ``jnp.pad`` do."""
    return torch.as_tensor(np.pad(np.arange(n), (lo, hi), mode=mode), device=device)


def pad2d(img: torch.Tensor, pad_h: Tuple[int, int], pad_w: Tuple[int, int],
          mode: str) -> torch.Tensor:
    """``jnp.pad(img, [(0, 0)] * lead + [pad_h, pad_w], mode=mode)`` for the
    index modes (``"reflect"``, ``"symmetric"``, ``"edge"``, ``"wrap"``):
    one gather along each of the last two axes."""
    H, W = img.shape[-2], img.shape[-1]
    x = img.index_select(-2, _pad_index(H, *pad_h, mode, img.device))
    return x.index_select(-1, _pad_index(W, *pad_w, mode, img.device))


def _conv2d_corr(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Valid cross-correlation of ``img``'s trailing [H, W] plane with one
    [m1, m2] kernel by ``F.conv2d`` (the ML convention does not flip, as
    ``cv2.filter2D``), leading axes folded into the batch."""
    lead = tuple(img.shape[:-2])
    lhs = img.reshape((-1, 1) + tuple(img.shape[-2:]))
    out = F.conv2d(lhs, kernel.reshape((1, 1) + tuple(kernel.shape)))
    return out.reshape(lead + tuple(out.shape[-2:]))


def filter2d_same(img: torch.Tensor, kernel, border: str = "reflect",
                  engine: str = "fft") -> torch.Tensor:
    """Correlation (``cv2.filter2D`` semantics: the kernel is not flipped)
    in 'same' geometry, batched over leading axes.

    ``border="reflect"`` (numpy reflect, cv2's BORDER_REFLECT_101) pads the
    image by ``(a, b) = ((m - 1) // 2, m - 1 - a)`` on each axis and crops
    from ``b``; ``border="constant"`` zero-pads like scipy's fftconvolve,
    with its same-mode anchor. ``engine="fft"`` runs the batched-FFT
    product, ``engine="conv"`` ``F.conv2d`` on the same geometry. The two
    agree to FFT-against-direct-sum rounding."""
    if isinstance(kernel, np.ndarray):
        kernel = np.ascontiguousarray(kernel)   # a flipud view has negative strides
    kernel = torch.as_tensor(kernel, dtype=img.dtype, device=img.device)
    m1, m2 = kernel.shape[-2], kernel.shape[-1]
    a1, a2 = (m1 - 1) // 2, (m2 - 1) // 2
    b1, b2 = m1 - 1 - a1, m2 - 1 - a2
    if engine == "conv":
        if border == "constant":
            # zero-pad low by b (the FFT route's same-crop anchor for even
            # kernels), so both engines share one alignment
            return _conv2d_corr(F.pad(img, (b2, a2, b1, a1)), kernel)
        return _conv2d_corr(pad2d(img, (a1, b1), (a2, b2), border), kernel)
    if engine != "fft":
        raise ValueError(
            f"unknown filter2d engine {engine!r}; expected one of {FILTER2D_ENGINES}"
        )
    flipped = torch.flip(kernel, (-2, -1))
    if border == "constant":
        return fftconvolve2d_same(img, flipped)
    x = pad2d(img, (a1, b1), (a2, b2), border)
    out = fftconvolve2d_same(x, flipped)
    return out[..., b1 : b1 + img.shape[-2], b2 : b2 + img.shape[-1]]


def _gaussian_1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


@functools.lru_cache(maxsize=16)
def _gaussian_taps(sigma: float, radius: int, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_gaussian_1d(sigma, radius), dtype=dtype, device=device)


def gaussian_filter2d(img: torch.Tensor, sigma: float, truncate: float = 4.0,
                      mode: str = "symmetric") -> torch.Tensor:
    """Separable Gaussian smoothing of the last two axes, matching
    ``scipy.ndimage.gaussian_filter`` (radius ``int(truncate * sigma +
    0.5)``, numpy's ``symmetric`` border = scipy's ``reflect``) — the
    smoother the reference applies to image masks (improcess.py:446)."""
    radius = int(truncate * float(sigma) + 0.5)
    k = _gaussian_taps(float(sigma), radius, img.dtype, img.device)
    x = pad2d(img, (radius, radius), (radius, radius), mode)
    # two separable valid-mode passes over the padded block
    x = _conv1d_last(x, k)
    x = _conv1d_last(x.transpose(-1, -2).contiguous(), k)
    return x.transpose(-1, -2)


def _conv1d_last(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Valid-mode 1-D convolution along the last axis (symmetric kernel),
    tap by tap in JAX's order: each tap's product rounded, then added."""
    n = k.shape[0]
    m = x.shape[-1] - n + 1
    out = torch.zeros(tuple(x.shape[:-1]) + (m,), dtype=x.dtype, device=x.device)
    for i in range(n):
        out = out + k[i] * x[..., i : i + m]
    return out


# ---------------------------------------------------------------------------
# Binning / resize + masking (improcess.py:395-454)
# ---------------------------------------------------------------------------


def resize_linear(image: torch.Tensor, shape: Tuple[int, int],
                  antialias: bool) -> torch.Tensor:
    """``jax.image.resize(image, lead + shape, "linear", antialias=...)`` of
    the last two axes: half-pixel centres (``align_corners=False``); with
    ``antialias`` a downsample widens the triangle kernel by the scale,
    as JAX's does."""
    lead = tuple(image.shape[:-2])
    x = image.reshape((-1, 1) + tuple(image.shape[-2:]))
    out = F.interpolate(x, size=tuple(int(s) for s in shape), mode="bilinear",
                        align_corners=False, antialias=antialias)
    return out.reshape(lead + tuple(out.shape[-2:]))


def binning(image: torch.Tensor, ft: float, fx: float) -> torch.Tensor:
    """Resize by factors (``ft`` along time, ``fx`` along channels) with
    bilinear antialiased interpolation (torchvision ``Resize`` in the
    reference, improcess.py:395-421)."""
    h = int(image.shape[-2] * fx)
    w = int(image.shape[-1] * ft)
    return resize_linear(image, (h, w), antialias=True)


def apply_smooth_mask(array: torch.Tensor, mask: torch.Tensor, sigma: float = 1.5,
                      compat: bool = False) -> torch.Tensor:
    """Multiply by a Gaussian-smoothed mask renormalized to [0, 1] per image.

    The reference computes the smoothed mask but then multiplies by the
    RAW mask (improcess.py:452, a documented bug); the default applies the
    smoothed mask as documented, ``compat=True`` the raw one. A uniform
    smoothed mask (no detection: all zeros) passes through unscaled."""
    smoothed = gaussian_filter2d(mask.to(array.dtype), sigma)
    lo = smoothed.amin(dim=(-2, -1), keepdim=True)
    hi = smoothed.amax(dim=(-2, -1), keepdim=True)
    span = hi - lo
    smoothed = torch.where(span > 0, (smoothed - lo) / torch.where(span > 0, span, 1.0),
                           smoothed)
    return array * (mask if compat else smoothed)
