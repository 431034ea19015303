"""Port parity, the image ops no detector runs: ``gaussian_blur_cv``,
``gradient_oriented``, ``detect_diagonal_edges``,
``diagonal_edge_detection``, ``bilateral_filter``, ``canny_edges``,
``hough_lines``, ``detect_long_lines``, ``radon_transform`` and
``compute_radon_transform`` of das4whales_tpu_torch (on the CPU) against
das4whales_tpu's (float32, x64 off) on seeded numpy images.

Contract: the float32 ops within ``REL * max|ref|`` (pocketfft and XLA's
FFT, or two sums, round differently); ``gradient_oriented`` bitwise (the
same elementwise operations in the same order); the Radon transform
within ``RADON_REL * max|ref|`` (``F.grid_sample``'s normalised
coordinates round otherwise than ``map_coordinates``' pixel ones); the
Canny map equal up to counted knife edges — a flipped pixel must be
8-connected, through the weak pixels of either map, to a pixel whose
direction bin, non-maximum suppression or threshold decision lies within
``KNIFE_REL`` of its edge in a float64 recomputation; the Hough segments
equal on the same edge map (exact integer votes).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from das4whales_tpu.ops import image as jimg
from das4whales_tpu_torch.ops import image as timg
from tests.torch_threads import one_torch_thread  # noqa: F401

REL = 1e-5
RADON_REL = 1e-4
KNIFE_REL = 1e-5


def _j32(fn, *args, **kw):
    with jax.enable_x64(False):
        out = fn(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args], **kw)
        return np.array(out)


def _t(fn, *args, **kw):
    out = fn(*[torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args], **kw)
    return out.numpy()


def _assert_near(ref, got, rel=REL):
    assert ref.shape == got.shape, (ref.shape, got.shape)
    scale = float(np.abs(ref).max())
    assert scale > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * scale)


def _line_image(h=64, w=96, seed=0):
    """A [0, 255] float32 image: smoothed noise with three bright lines
    (two diagonals and a near-horizontal one)."""
    rng = np.random.default_rng(seed)
    img = ndimage.gaussian_filter(rng.standard_normal((h, w)), 1.0) * 20.0 + 60.0
    for x0, slope in ((5, 0.6), (30, -0.5)):
        xs = np.arange(w)
        ys = np.round(x0 + slope * xs).astype(int)
        ok = (ys >= 0) & (ys < h)
        img[ys[ok], xs[ok]] += 150.0
    img[h // 2, 10: w - 10] += 150.0
    return np.clip(img, 0, 255).astype(np.float32)


@pytest.mark.parametrize("size, sigma", [(5, 1.2), (7, 0.0), (3, 2.0)])
def test_gaussian_blur_cv_matches_jax(size, sigma):
    img = _line_image(seed=1)
    _assert_near(_j32(jimg.gaussian_blur_cv, img, size, sigma),
                 _t(timg.gaussian_blur_cv, img, size, sigma))


@pytest.mark.parametrize("direction", [(3, 0), (0, 2), (2, 1)])
def test_gradient_oriented_is_bitwise_jax(direction):
    img = _line_image(seed=2)
    np.testing.assert_array_equal(_t(timg.gradient_oriented, img, direction),
                                  _j32(jimg.gradient_oriented, img, direction))


@pytest.mark.parametrize("name", ["detect_diagonal_edges", "diagonal_edge_detection"])
def test_diagonal_edge_ops_match_jax(name):
    img = _line_image(seed=3)
    _assert_near(_j32(getattr(jimg, name), img), _t(getattr(timg, name), img))


@pytest.mark.parametrize("diameter, sc, ss", [(9, 75.0, 75.0), (5, 20.0, 3.0)])
def test_bilateral_filter_matches_jax(diameter, sc, ss):
    img = _line_image(seed=4)
    _assert_near(_j32(jimg.bilateral_filter, img, diameter, sc, ss),
                 _t(timg.bilateral_filter, img, diameter, sc, ss))


def _canny_knife_seeds(img, low, high, rel=KNIFE_REL):
    """Pixels of a float64 recomputation of the Canny stages whose
    direction bin, suppression or threshold decision lies within ``rel``
    of its edge (angles within ``rel`` rad of a bin boundary)."""
    x = np.pad(img.astype(np.float64), 1, mode="edge")
    sx = np.array([[-1.0, 0, 1], [-2, 0, 2], [-1, 0, 1]])
    sy = sx.T
    gx = ndimage.correlate(x, sx, mode="constant")[1:-1, 1:-1]
    gy = ndimage.correlate(x, sy, mode="constant")[1:-1, 1:-1]
    mag = np.abs(gx) + np.abs(gy)
    tol = rel * max(float(mag.max()), high)
    ang = np.arctan2(gy, gx)
    ang = np.where(ang < 0, ang + np.pi, ang)
    q = (ang + np.pi / 8) / (np.pi / 4)
    near_bin = np.abs(q - np.round(q)) * (np.pi / 4) <= rel
    mp = np.pad(mag, 1)
    h, w = img.shape
    near_nms = np.zeros_like(near_bin)
    for dy, dx in ((0, 1), (1, 1), (1, 0), (1, -1)):
        for sgn in (1, -1):
            nb = mp[1 + sgn * dy: 1 + sgn * dy + h, 1 + sgn * dx: 1 + sgn * dx + w]
            near_nms |= np.abs(mag - nb) <= tol
    near_thr = (np.abs(mag - low) <= tol) | (np.abs(mag - high) <= tol)
    return near_bin | near_nms | near_thr


def _canny_flips(img, low, high, ref, got):
    """(flips, unexplained flips) of ``got`` against ``ref``."""
    diff = ref != got
    if not diff.any():
        return 0, 0
    seeds = _canny_knife_seeds(img, low, high)
    comp, _ = ndimage.label(ref | got | seeds, structure=np.ones((3, 3)))
    explained = np.isin(comp, np.unique(comp[seeds & (comp > 0)]))
    return int(diff.sum()), int((diff & ~explained).sum())


@pytest.mark.parametrize("low, high, iters", [(50.0, 150.0, 32), (20.0, 60.0, 8)])
def test_canny_edges_match_jax_up_to_knife_edges(low, high, iters):
    img = _j32(jimg.bilateral_filter, _line_image(seed=5), 9, 75.0, 75.0)
    ref = _j32(jimg.canny_edges, img, low, high, hysteresis_iters=iters)
    got = _t(timg.canny_edges, img, low, high, hysteresis_iters=iters)
    assert got.dtype == np.bool_ and ref.any()
    n, bad = _canny_flips(img, low, high, ref, got)
    assert bad == 0, f"{bad} of {n} flipped Canny pixels are not on a knife edge"
    assert n <= 0.01 * ref.sum()


@pytest.mark.parametrize("kw", [dict(threshold=30, min_line_length=20, max_line_gap=5),
                                dict(threshold=15, min_line_length=10, max_line_gap=2,
                                     theta_res=np.pi / 90, rho_res=2.0)])
def test_hough_lines_on_the_same_edge_map_equal_jax(kw):
    img = _j32(jimg.bilateral_filter, _line_image(seed=6), 9, 75.0, 75.0)
    edges = _j32(jimg.canny_edges, img, 50.0, 150.0)
    ref = jimg.hough_lines(edges, **kw)
    got = timg.hough_lines(torch.from_numpy(edges), **kw)
    assert ref and got == ref
    assert timg.hough_lines(edges, **kw) == ref          # a host array is taken too
    assert timg.hough_lines(np.zeros((8, 8), bool)) == jimg.hough_lines(np.zeros((8, 8), bool)) == []


def test_hough_accumulator_counts_every_vote_exactly():
    edges = torch.zeros(20, 30, dtype=torch.bool)
    edges[5, :] = True
    edges[:, 7] = True
    thetas = np.arange(0, np.pi, np.pi / 180)
    diag = int(np.ceil(np.hypot(20, 30)))
    acc = timg.hough_accumulator(edges, thetas, diag, 2 * diag + 1)
    assert acc.dtype == torch.int32
    assert int(acc.sum()) == int(edges.sum()) * len(thetas)   # no vote lost or doubled
    assert int(acc[0, 7 + diag]) == 20                        # the column at theta 0
    assert int(acc[90, 5 + diag]) == 30                       # the row at theta 90 deg


def test_detect_long_lines_matches_jax():
    img = _line_image(seed=7)
    kw = dict(threshold=30, min_line_length=25, max_line_gap=5)
    with jax.enable_x64(False):
        ref_lines, ref_edges = jimg.detect_long_lines(img, **kw)
        ref_edges = np.array(ref_edges)
    got_lines, got_edges = timg.detect_long_lines(torch.from_numpy(img), **kw)
    got_edges = got_edges.numpy()
    smooth = _j32(jimg.bilateral_filter, img, 9, 75.0, 75.0)
    n, bad = _canny_flips(smooth, 50.0, 150.0, ref_edges, got_edges)
    assert bad == 0
    if n == 0:
        assert got_lines == ref_lines and ref_lines


@pytest.mark.parametrize("shape, theta", [((64, 96), None), ((31, 20), np.arange(0.0, 180.0, 7.5)),
                                          ((40, 40), np.array([0.0, 45.0, 90.0, 137.3]))])
def test_radon_transform_matches_jax(shape, theta):
    img = _line_image(*shape, seed=8)
    ref = _j32(jimg.radon_transform, img, theta)
    got = _t(timg.radon_transform, img, theta)
    _assert_near(ref, got, RADON_REL)
    np.testing.assert_array_equal(_t(timg.compute_radon_transform, img, theta), got)
