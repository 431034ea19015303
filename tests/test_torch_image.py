"""Port parity, the image ops the Gabor detector runs: ``ops.image`` of
das4whales_tpu_torch (on the CPU) against das4whales_tpu's (float32, x64
off) on seeded numpy inputs.

Contract: the host-side designs (``angle_fromspeed``, ``gabor_kernel``,
``gabor_filt_design``, the pad index maps) equal exactly; the float32 ops
within ``REL * max|ref|`` (pocketfft and XLA's FFT, or two direct sums,
round differently; the 101 x 101 direct correlation sums 10201 products,
hence ``REL_CONV``); the resizes within ``RESIZE_ABS`` of the [0, 255]
image JAX gives (``F.interpolate`` and ``jax.image.resize`` weigh the same
taps in another order). Every 2-D correlation runs with even and odd
kernels, both borders, both engines, and pads wider than the axis.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from das4whales_tpu.ops import image as jimg
from das4whales_tpu_torch.ops import image as timg

REL = 2e-6
REL_CONV = 1e-5
RESIZE_ABS = 2e-4


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


def test_scale_pixels_and_trace2image_match_jax():
    rng = np.random.default_rng(1)
    img = rng.standard_normal((40, 300)).astype(np.float32)
    _assert_near(_j32(jimg.scale_pixels, img), _t(timg.scale_pixels, img))
    tr = (rng.standard_normal((24, 1000)) * np.linspace(0.5, 3.0, 24)[:, None]).astype(np.float32)
    _assert_near(_j32(jimg.trace2image, tr), _t(timg.trace2image, tr))


def test_scale_pixels_keeps_each_image_of_a_stack_its_own_scale():
    rng = np.random.default_rng(2)
    stack = rng.standard_normal((3, 16, 50)).astype(np.float32) * np.array([1, 10, 100],
                                                                           np.float32)[:, None, None]
    got = _t(timg.scale_pixels, stack)
    for b in range(3):
        np.testing.assert_array_equal(got[b], _t(timg.scale_pixels, stack[b]))
        assert got[b].min() == 0.0 and got[b].max() == 1.0


@pytest.mark.parametrize("selected", [[0, 128, 1], [10, 500, 3], 2])
def test_angle_and_gabor_design_equal_jax(selected):
    theta = jimg.angle_fromspeed(1500.0, 200.0, 2.042, selected)
    assert timg.angle_fromspeed(1500.0, 200.0, 2.042, selected) == theta
    for ksize in (100, 7, 8):
        up_j, down_j = jimg.gabor_filt_design(theta, ksize=ksize)
        up_t, down_t = timg.gabor_filt_design(theta, ksize=ksize)
        np.testing.assert_array_equal(up_t, up_j)
        np.testing.assert_array_equal(down_t, down_j)
        assert up_t.shape == (2 * (ksize // 2) + 1,) * 2
    k = timg.gabor_kernel(10, 3.0, 0.7, 12.0, 0.4, psi=0.3)
    np.testing.assert_array_equal(k, jimg.gabor_kernel(10, 3.0, 0.7, 12.0, 0.4, psi=0.3))


@pytest.mark.parametrize("mode", ["reflect", "symmetric"])
@pytest.mark.parametrize("n, lo, hi", [(1, 3, 2), (2, 49, 50), (5, 2, 1), (32, 50, 50),
                                       (7, 0, 0)])
def test_pad2d_equals_jnp_pad_also_past_the_axis(mode, n, lo, hi):
    """``jnp.pad`` reflects again where a pad is wider than the axis; the
    index map does the same (``F.pad`` would raise)."""
    rng = np.random.default_rng(n + lo)
    x = rng.standard_normal((2, n, n + 3)).astype(np.float32)
    want = _j32(lambda a: jnp.pad(a, [(0, 0), (lo, hi), (hi, lo)], mode=mode), x)
    got = _t(timg.pad2d, x, (lo, hi), (hi, lo), mode)
    np.testing.assert_array_equal(got, want)


KERNEL_SHAPES = [(5, 4), (4, 6), (7, 7), (2, 3), (1, 1), (101, 101)]


@pytest.mark.parametrize("engine", ["fft", "conv"])
@pytest.mark.parametrize("border", ["reflect", "constant"])
@pytest.mark.parametrize("kshape", KERNEL_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_filter2d_same_matches_jax(kshape, border, engine):
    """Even kernels (a != b: an off-by-one in an anchor shows) and odd ones,
    both borders, both engines; the 101 x 101 kernel pads past the 2 x 200
    and 32 x 40 images' axes."""
    rng = np.random.default_rng(sum(kshape))
    kernel = rng.standard_normal(kshape).astype(np.float32)
    for shape in ((3, 40, 70), (2, 200), (32, 40)):
        img = rng.random(shape).astype(np.float32)
        want = _j32(jimg.filter2d_same, img, kernel, border=border, engine=engine)
        got = _t(timg.filter2d_same, img, kernel, border=border, engine=engine)
        _assert_near(want, got, REL_CONV if engine == "conv" and kernel.size > 100 else REL)


def test_filter2d_engines_agree_and_unknown_engine_raises():
    rng = np.random.default_rng(4)
    img = torch.from_numpy(rng.random((30, 90)).astype(np.float32))
    up, _ = timg.gabor_filt_design(74.7, ksize=20)
    a = timg.filter2d_same(img, up, engine="fft").numpy()
    b = timg.filter2d_same(img, up, engine="conv").numpy()
    _assert_near(a, b, REL_CONV)
    with pytest.raises(ValueError, match="filter2d engine"):
        timg.filter2d_same(img, up, engine="matmul")


@pytest.mark.parametrize("sigma", [1.5, 0.7, 3.0])
def test_gaussian_filter2d_matches_jax(sigma):
    rng = np.random.default_rng(5)
    for shape in ((40, 120), (2, 5, 9), (3, 60)):
        img = rng.random(shape).astype(np.float32)
        _assert_near(_j32(jimg.gaussian_filter2d, img, sigma),
                     _t(timg.gaussian_filter2d, img, sigma))


def test_conv1d_last_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 50)).astype(np.float32)
    k = timg._gaussian_1d(1.5, 6).astype(np.float32)
    np.testing.assert_array_equal(timg._gaussian_1d(1.5, 6), jimg._gaussian_1d(1.5, 6))
    _assert_near(_j32(jimg._conv1d_last, x, k), _t(timg._conv1d_last, x, k))


@pytest.mark.parametrize("shape, factor", [((128, 3000), 0.25), ((220, 1200), 0.1),
                                           ((24, 2000), 0.1), ((33, 77), 0.3),
                                           ((2, 64, 400), 0.25)])
def test_binning_and_upsample_match_jax_resize(shape, factor):
    rng = np.random.default_rng(shape[-1])
    img = (rng.random(shape) * 255).astype(np.float32)
    want = _j32(jimg.binning, img, factor, factor)
    got = _t(timg.binning, img, factor, factor)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_ABS)
    mask = (rng.random(want.shape) > 0.6).astype(np.float32)
    up = _j32(lambda m: jax.image.resize(m, shape, method="linear", antialias=False), mask)
    np.testing.assert_allclose(_t(timg.resize_linear, mask, shape[-2:], antialias=False),
                               up, rtol=0, atol=1e-6)


@pytest.mark.parametrize("compat", [False, True])
def test_apply_smooth_mask_matches_jax(compat):
    rng = np.random.default_rng(7)
    arr = rng.standard_normal((48, 300)).astype(np.float32)
    mask = np.zeros((48, 300), np.float32)
    mask[10:30, 100:220] = 1.0
    mask[40:, :20] = 0.5
    _assert_near(_j32(jimg.apply_smooth_mask, arr, mask, compat=compat),
                 _t(timg.apply_smooth_mask, arr, mask, compat=compat))


def test_apply_smooth_mask_passes_a_uniform_mask_through():
    rng = np.random.default_rng(8)
    arr = rng.standard_normal((20, 50)).astype(np.float32)
    zero = np.zeros((20, 50), np.float32)
    assert not _t(timg.apply_smooth_mask, arr, zero).any()
    assert not _j32(jimg.apply_smooth_mask, arr, zero).any()
    one = np.ones((20, 50), np.float32)     # smoothed: the taps' float32 sum, about 1
    _assert_near(_j32(jimg.apply_smooth_mask, arr, one), _t(timg.apply_smooth_mask, arr, one))
