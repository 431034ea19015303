"""Image operations of the t-x-plane detector family (the port's copy of
``das4whales_tpu.ops.image``): what the Gabor detector runs, and the
edge, line and Radon operations of the reference's improcess.py that no
detector calls.

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
    k = _gaussian_1d(sigma, radius)
    if dtype == torch.float32:
        # rounded on the host (as torch would round it), so no float64
        # tensor enters the program
        k = k.astype(np.float32)
    return torch.as_tensor(k, dtype=dtype, device=device)


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


def gaussian_blur_cv(img: torch.Tensor, size: int, sigma: float) -> torch.Tensor:
    """``cv2.GaussianBlur`` semantics: odd ``size`` x ``size`` kernel,
    BORDER_REFLECT_101 (improcess.py:370-392), over the last two axes."""
    if sigma <= 0:
        sigma = 0.3 * ((size - 1) * 0.5 - 1) + 0.8
    radius = size // 2
    k = _gaussian_taps(float(sigma), radius, img.dtype, img.device)
    x = pad2d(img, (radius, radius), (radius, radius), "reflect")
    x = _conv1d_last(x, k)
    x = _conv1d_last(x.transpose(-1, -2).contiguous(), k)
    return x.transpose(-1, -2)


# ---------------------------------------------------------------------------
# Edge detectors (improcess.py:143-266)
# ---------------------------------------------------------------------------


def gradient_oriented(image: torch.Tensor, direction: Tuple[int, int]) -> torch.Tensor:
    """Directional finite-difference gradient (improcess.py:143-169)."""
    dft, dfx = direction
    if dfx == 0:
        return -(image[:, :-dft] - image[:, dft:])
    if dft == 0:
        return -(image[dfx:, :] - image[:-dfx, :])
    return -(image[dfx:-dfx, :-dft] - 0.5 * image[2 * dfx :, dft:]
             - 0.5 * image[: -2 * dfx, dft:])


#: the 5x5 anti-diagonal edge kernel of improcess.py:172-226, host float32
#: (small integers, exact in any float width; cast to the image's dtype
#: at use)
_DIAG5 = np.array(
    [[0, 1, 1, 1, 1],
     [-1, 0, 1, 1, 1],
     [-1, -1, 0, 1, 1],
     [-1, -1, -1, 0, 1],
     [-1, -1, -1, -1, 0]],
    dtype=np.float32,
)
#: the 3x3 diagonal-enhance kernel of improcess.py:229-266
_DIAG3 = np.array([[2.0, -1.0, -1.0], [-1.0, 2.0, -1.0], [-1.0, -1.0, 2.0]])


def _kernel_on(k: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(k), dtype=like.dtype, device=like.device)


def detect_diagonal_edges(matrix: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    """Sum of both-orientation 5x5 anti/diagonal convolution responses
    (improcess.py:172-226; the reference's threshold argument is likewise
    unused in its active code path)."""
    return (fftconvolve2d_same(matrix, _kernel_on(_DIAG5, matrix))
            + fftconvolve2d_same(matrix, _kernel_on(np.fliplr(_DIAG5), matrix)))


def diagonal_edge_detection(img: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    """3x3 diagonal-enhance convolution pair (the reference's ``F.conv2d``
    with zero padding, improcess.py:229-266, which cross-correlates): a
    same-mode convolution with each flipped kernel, summed."""
    out_l = fftconvolve2d_same(img, _kernel_on(_DIAG3[::-1, ::-1], img))
    out_r = fftconvolve2d_same(img, _kernel_on(np.flipud(_DIAG3)[::-1, ::-1], img))
    return out_l + out_r


# ---------------------------------------------------------------------------
# Bilateral filter (improcess.py:319-344)
# ---------------------------------------------------------------------------


def bilateral_filter(img: torch.Tensor, diameter: int, sigma_color: float,
                     sigma_space: float) -> torch.Tensor:
    """Edge-preserving bilateral smoothing (cv2.bilateralFilter capability,
    improcess.py:319-344): Gaussian weights in space x intensity over a
    circular window of ``diameter``, by shifted adds of an edge-padded
    image, in the JAX package's order."""
    r = diameter // 2
    xp = pad2d(img, (r, r), (r, r), "edge")
    h, w = img.shape[-2], img.shape[-1]
    num = torch.zeros_like(img)
    den = torch.zeros_like(img)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dy * dy + dx * dx > r * r:
                continue  # circular window like OpenCV
            shifted = xp[..., r + dy : r + dy + h, r + dx : r + dx + w]
            ws = float(np.float32(np.exp(-(dy * dy + dx * dx) / (2.0 * sigma_space**2))))
            wc = torch.exp(-((shifted - img) ** 2) / (2.0 * sigma_color**2))
            wgt = ws * wc
            num = num + wgt * shifted
            den = den + wgt
    return num / den


# ---------------------------------------------------------------------------
# Canny + Hough (improcess.py:269-316)
# ---------------------------------------------------------------------------

_SOBEL_X = np.array([[-1.0, 0, 1], [-2, 0, 2], [-1, 0, 1]])
_SOBEL_Y = np.array([[-1.0, -2, -1], [0, 0, 0], [1, 2, 1]])


def canny_edges(img: torch.Tensor, low: float, high: float,
                hysteresis_iters: int = 32) -> torch.Tensor:
    """Canny edge map of a 2-D image: 3x3 Sobel gradients on an
    edge-replicated border, the L1 magnitude, 4-direction non-maximum
    suppression, a double threshold and hysteresis as ``hysteresis_iters``
    dilations of the strong edges through the weak ones (a fixed number of
    iterations, as the JAX package's ``fori_loop``). Capability parity with
    cv2.Canny (improcess.py:291). Returns a bool map."""
    imgp = pad2d(img, (1, 1), (1, 1), "edge")
    gx = fftconvolve2d_same(imgp, _kernel_on(_SOBEL_X[::-1, ::-1], img))[1:-1, 1:-1]
    gy = fftconvolve2d_same(imgp, _kernel_on(_SOBEL_Y[::-1, ::-1], img))[1:-1, 1:-1]
    mag = torch.abs(gx) + torch.abs(gy)  # L1, cv2 default

    # quantize the gradient direction into 4 bins
    ang = torch.atan2(gy, gx)
    ang = torch.where(ang < 0, ang + np.pi, ang)
    bins = torch.remainder(torch.floor((ang + np.pi / 8) / (np.pi / 4)).to(torch.int32), 4)

    mp = F.pad(mag, (1, 1, 1, 1))
    h, w = img.shape

    def shift(dy, dx):
        return mp[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]

    # per bin the two neighbours across the edge: horizontal, 45 deg,
    # vertical, 135 deg (the first bin that matches, as jnp.select)
    pairs = (((0, 1), (0, -1)), ((1, 1), (-1, -1)), ((1, 0), (-1, 0)), ((1, -1), (-1, 1)))
    na = torch.zeros_like(mag)
    nb = torch.zeros_like(mag)
    for b in reversed(range(4)):
        (ay, ax), (by, bx) = pairs[b]
        na = torch.where(bins == b, shift(ay, ax), na)
        nb = torch.where(bins == b, shift(by, bx), nb)
    nms = torch.where((mag >= na) & (mag >= nb), mag, torch.zeros_like(mag))

    strong = nms >= high
    weak = nms >= low
    s = strong
    for _ in range(hysteresis_iters):
        sp = F.pad(s.to(torch.uint8), (1, 1, 1, 1)).bool()
        grown = torch.zeros_like(s)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                grown = grown | sp[1 + dy : 1 + dy + h, 1 + dx : 1 + dx + w]
        s = (grown & weak) | s
    return s


def hough_accumulator(edges: torch.Tensor, thetas: np.ndarray, diag: int,
                      n_rhos: int, rho_res: float = 1.0) -> torch.Tensor:
    """The ``[n_thetas, n_rhos]`` vote count of every edge pixel of a bool
    map, on its device: ``rho = x cos(theta) + y sin(theta)`` in float32
    (each product rounded, then the sum; no TF32), its bin
    ``round((rho + diag) / rho_res)`` (half to even, as ``jnp.round``),
    then exact int32 scatter-adds. A bin outside the range is dropped, as
    an out-of-bounds scatter is in the JAX package."""
    dev = edges.device
    ys, xs = torch.nonzero(edges, as_tuple=True)
    cs = torch.as_tensor(np.stack([np.cos(thetas), np.sin(thetas)]).astype(np.float32),
                         device=dev)
    rho_v = (xs.to(torch.float32)[:, None] * cs[0][None, :]
             + ys.to(torch.float32)[:, None] * cs[1][None, :])    # [n_points, n_thetas]
    rho_idx = torch.round((rho_v + diag) / rho_res).to(torch.int64)
    t_idx = torch.arange(len(thetas), device=dev).expand_as(rho_idx)
    keep = (rho_idx >= 0) & (rho_idx < n_rhos)
    flat = (t_idx * n_rhos + rho_idx)[keep]
    acc = torch.zeros(len(thetas) * n_rhos, dtype=torch.int32, device=dev)
    acc.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
    return acc.reshape(len(thetas), n_rhos)


def hough_lines(edges, rho_res: float = 1.0, theta_res: float = np.pi / 180,
                threshold: int = 100, min_line_length: int = 10, max_line_gap: int = 10):
    """Deterministic line-segment extraction through a full Hough
    accumulator (capability parity with cv2.HoughLinesP,
    improcess.py:300-307, without its randomized sampling): the votes on
    the edge map's device (:func:`hough_accumulator`), then on the host
    each accumulator peak at or over ``threshold`` walked through the edge
    map, emitting runs of at least ``min_line_length`` with gaps of at
    most ``max_line_gap`` merged. Returns ``[(x1, y1, x2, y2), ...]``."""
    if not isinstance(edges, torch.Tensor):
        edges = torch.as_tensor(np.asarray(edges))
    edges = edges.bool()
    h, w = edges.shape
    if not bool(edges.any()):
        return []
    thetas = np.arange(0, np.pi, theta_res)
    diag = int(np.ceil(np.hypot(h, w)))
    rhos = np.arange(-diag, diag + rho_res, rho_res)
    acc = hough_accumulator(edges, thetas, diag, len(rhos), rho_res).cpu().numpy()
    edges = edges.cpu().numpy()

    lines = []
    for ti, ri in zip(*np.nonzero(acc >= threshold)):
        theta, rho = thetas[ti], rhos[ri]
        c, s = np.cos(theta), np.sin(theta)
        # walk the line across the image
        if abs(s) > abs(c):  # mostly horizontal in x
            xs_l = np.arange(w)
            ys_l = np.round((rho - xs_l * c) / s).astype(int)
            valid = (ys_l >= 0) & (ys_l < h)
            on = np.zeros(w, bool)
        else:
            ys_l = np.arange(h)
            xs_l = np.round((rho - ys_l * s) / c).astype(int)
            valid = (xs_l >= 0) & (xs_l < w)
            on = np.zeros(h, bool)
        on[valid] = edges[ys_l[valid], xs_l[valid]]
        coords = np.stack([xs_l, ys_l], 1)
        # merge runs separated by <= max_line_gap
        idx = np.nonzero(on)[0]
        if len(idx) == 0:
            continue
        splits = np.nonzero(np.diff(idx) > max_line_gap)[0]
        for seg in np.split(idx, splits + 1):
            if len(seg) and seg[-1] - seg[0] + 1 >= min_line_length:
                x1, y1 = coords[seg[0]]
                x2, y2 = coords[seg[-1]]
                lines.append((int(x1), int(y1), int(x2), int(y2)))
    return lines


def detect_long_lines(img: torch.Tensor, canny_low: float = 50.0, canny_high: float = 150.0,
                      threshold: int = 100, min_line_length: int = 50, max_line_gap: int = 10,
                      bilateral_diameter: int = 9, sigma_color: float = 75.0,
                      sigma_space: float = 75.0):
    """Long-line extraction: bilateral smoothing -> Canny -> Hough segment
    walk (cv2.bilateralFilter + cv2.Canny + cv2.HoughLinesP in the
    reference, improcess.py:269-316), on the image's device but the walk.
    Returns ``(lines, edges)`` with lines as (x1, y1, x2, y2)."""
    img = img.to(torch.float32)
    smooth = bilateral_filter(img, bilateral_diameter, sigma_color, sigma_space)
    edges = canny_edges(smooth, canny_low, canny_high)
    lines = hough_lines(edges, threshold=threshold, min_line_length=min_line_length,
                        max_line_gap=max_line_gap)
    return lines, edges


# ---------------------------------------------------------------------------
# Radon transform (improcess.py:347-367)
# ---------------------------------------------------------------------------

#: angles of :func:`radon_transform` sampled in one pass (bounds the
#: ``[angles, n, n]`` sampling grid: 16 x 4 bytes x n^2 x 2)
RADON_ANGLE_CHUNK = 16


def radon_transform(image: torch.Tensor, theta: np.ndarray | None = None) -> torch.Tensor:
    """Radon transform (circle=False): pad to the diagonal, rotate by each
    angle with bilinear interpolation (``F.grid_sample``, zeros outside,
    the corners of ``align_corners=True``: JAX's ``map_coordinates(order=1)``
    with cval 0), sum along rows. Capability parity with
    ``skimage.transform.radon`` (improcess.py:347-367). The angles run in
    chunks of :data:`RADON_ANGLE_CHUNK`. Returns ``[position, angle]``."""
    if theta is None:
        theta = np.arange(180.0)
    img = torch.as_tensor(image)
    h, w = img.shape
    diag = int(np.ceil(np.sqrt(h * h + w * w)))
    pad_h, pad_w = diag - h, diag - w
    img_p = F.pad(img, (pad_w // 2, pad_w - pad_w // 2, pad_h // 2, pad_h - pad_h // 2))
    n = img_p.shape[0]
    center = (n - 1) / 2.0
    ax = torch.arange(n, device=img.device, dtype=img.dtype) - center
    yy, xx = torch.meshgrid(ax, ax, indexing="ij")
    coords = torch.stack([yy.reshape(-1), xx.reshape(-1)])        # [2, n*n]
    deg = torch.as_tensor(np.asarray(theta), dtype=img.dtype, device=img.device)
    src_img = img_p[None, None]
    out = []
    for lo in range(0, deg.shape[0], RADON_ANGLE_CHUNK):
        a = torch.deg2rad(deg[lo : lo + RADON_ANGLE_CHUNK])
        c, s = torch.cos(a), torch.sin(a)
        rot = torch.stack([torch.stack([c, s], -1), torch.stack([-s, c], -1)], -2)  # [k, 2, 2]
        src = rot @ coords + center                                  # [k, 2, n*n]
        # grid_sample's grid is (x, y) = (column, row), normalised to [-1, 1]
        grid = torch.stack([src[:, 1], src[:, 0]], -1) * (2.0 / (n - 1)) - 1.0
        vals = F.grid_sample(src_img.expand(a.shape[0], 1, n, n),
                             grid.reshape(a.shape[0], n, n, 2), mode="bilinear",
                             padding_mode="zeros", align_corners=True)
        out.append(vals[:, 0].sum(dim=1))                            # [k, n]
    return torch.cat(out).T  # [projection position, angle] like skimage


def compute_radon_transform(image, theta=None):
    """Reference-named alias of :func:`radon_transform`
    (improcess.py:347-367)."""
    return radon_transform(image, theta)


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
