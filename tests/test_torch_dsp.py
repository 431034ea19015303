"""Port parity, the reference DSP API (ROADMAP item 16): the port's
``ops.filters``, ``ops.fk``, ``ops.spectral``, ``ops.xcorr``,
``ops.conditioning.condition_segmented`` and
``ops.peaks.find_peaks_sparse_tiled`` on the CPU against the JAX
package's, on the same numpy inputs made from a seed.

Tolerances:
- host designers (Butterworth, f-k masks, the speed fan, the FIR):
  bitwise;
- the exact IIR in float64: against scipy at ``tests/test_filters.py``'s
  atol per case (1e-10 lfilter/sosfilt, 1e-9 filtfilt/sosfiltfilt, 5e-6
  for the ill-conditioned order-16 ``(b, a)`` of ``bp_filt(mode=
  "exact")``), and against JAX to 1e-12 (the same recurrence);
- FFT ops in float32 (JAX with x64 off): ``1e-5 * max|ref|``;
- the tiled picker and the segmented conditioning: bitwise.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sp
import torch

from das4whales_tpu.ops import conditioning as jcond
from das4whales_tpu.ops import filters as jfilt
from das4whales_tpu.ops import fk as jfk
from das4whales_tpu.ops import peaks as jpeaks
from das4whales_tpu.ops import spectral as jspec
from das4whales_tpu.ops import xcorr as jxcorr
from das4whales_tpu_torch.ops import conditioning as tcond
from das4whales_tpu_torch.ops import filters as tfilt
from das4whales_tpu_torch.ops import fk as tfk
from das4whales_tpu_torch.ops import peaks as tpeaks
from das4whales_tpu_torch.ops import spectral as tspec
from das4whales_tpu_torch.ops import xcorr as txcorr

REL = 1e-5
FS = 200.0


def _rng(seed=1234):
    return np.random.default_rng(seed)


def _j32(fn, *args, **kw):
    """A JAX function in float32 (x64 off); host numpy copies."""
    with jax.enable_x64(False):
        out = fn(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args], **kw)
        return jax.tree_util.tree_map(np.array, out)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_near(ref, got, rel=REL):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    scale = float(np.abs(ref).max())
    assert scale > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * scale)


# ---------------------------------------------------------------------------
# ops/filters.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [(4, [10, 30], "bandpass"), (8, [14, 30], "bp"),
                                  (6, 20, "lowpass")])
def test_butterworth_designs_are_bitwise(spec):
    np.testing.assert_array_equal(tfilt.butterworth_filter(spec, FS),
                                  jfilt.butterworth_filter(spec, FS))
    b, a = tfilt.butter_bandpass_ba(8, 14.0, 30.0, FS)
    jb, ja = jfilt.butter_bandpass_ba(8, 14.0, 30.0, FS)
    np.testing.assert_array_equal(b, jb)
    np.testing.assert_array_equal(a, ja)


@pytest.mark.parametrize("nns", [1000, 1001, 4096])
def test_zero_phase_gain_full_is_bitwise(nns):
    got = tfilt.butter_zero_phase_gain_full(nns, FS, (14.0, 30.0))
    np.testing.assert_array_equal(got, jfilt.butter_zero_phase_gain_full(nns, FS, (14.0, 30.0)))
    assert got.dtype == np.float32


@pytest.mark.parametrize("band,tol", [((14.0, 30.0), 1e-7), ((10.0, 40.0), 1e-5)])
def test_zero_phase_fir_is_bitwise_and_cached(band, tol):
    h, L = tfilt.butter_zero_phase_fir(FS, band, tol=tol)
    jh, jL = jfilt.butter_zero_phase_fir(FS, band, tol=tol)
    assert L == jL
    np.testing.assert_array_equal(h, jh)
    np.testing.assert_array_equal(h, h[::-1])
    assert not h.flags.writeable
    assert tfilt.butter_zero_phase_fir(FS, band, tol=tol)[0] is h


def _lfilter_cases():
    b4, a4 = sp.butter(4, 0.2)
    b3, a3 = sp.butter(3, [0.1, 0.4], "bp")
    return {"order4": (b4, a4, None), "bp3_zi": (b3, a3, sp.lfilter_zi(b3, a3))}


@pytest.mark.parametrize("case", ["order4", "bp3_zi"])
def test_lfilter_matches_scipy_and_jax(case):
    b, a, zi = _lfilter_cases()[case]
    x = _rng().standard_normal((3, 300))
    if zi is None:
        got, zf = tfilt.lfilter(b, a, _t(x))
        want, _ = sp.lfilter(b, a, x, axis=-1, zi=np.zeros((3, len(a) - 1)))
        jy, jzf = jfilt.lfilter(b, a, x)
    else:
        zi3 = np.broadcast_to(zi, (3, len(zi))).copy()
        got, zf = tfilt.lfilter(b, a, _t(x), zi=_t(zi3))
        want, want_zf = sp.lfilter(b, a, x, axis=-1, zi=zi3)
        np.testing.assert_allclose(zf.numpy(), want_zf, atol=1e-10)
        jy, jzf = jfilt.lfilter(b, a, x, zi=zi3)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, atol=1e-10)
    np.testing.assert_allclose(got.numpy(), np.asarray(jy), rtol=0, atol=1e-12)
    np.testing.assert_allclose(zf.numpy(), np.asarray(jzf), rtol=0, atol=1e-12)


def test_filtfilt_matches_scipy_and_jax():
    b, a = sp.butter(4, [0.1, 0.4], "bp")
    x = _rng().standard_normal((4, 400))
    got = tfilt.filtfilt(b, a, _t(x)).numpy()
    np.testing.assert_allclose(got, sp.filtfilt(b, a, x, axis=-1), atol=1e-9)
    np.testing.assert_allclose(got, np.asarray(jfilt.filtfilt(b, a, x)), rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="padlen"):
        tfilt.filtfilt(b, a, _t(x[:, :20]))


@pytest.mark.parametrize("zi", [False, True])
def test_sosfilt_matches_scipy_and_jax(zi):
    sos = sp.butter(8, [0.14, 0.3], "bp", output="sos")
    x = _rng().standard_normal((2, 600))
    z0 = np.broadcast_to(sp.sosfilt_zi(sos)[None] * x[:, :1, None], (2, len(sos), 2)).copy()
    if zi:
        got, zf = tfilt.sosfilt(sos, _t(x), zi=_t(z0))
        want, want_zf = sp.sosfilt(sos, x, axis=-1, zi=np.moveaxis(z0, 1, 0))
        jy, jzf = jfilt.sosfilt(sos, x, zi=z0)
        np.testing.assert_allclose(zf.numpy(), np.moveaxis(want_zf, 0, 1), atol=1e-10)
    else:
        got, zf = tfilt.sosfilt(sos, _t(x))
        want = sp.sosfilt(sos, x, axis=-1)
        jy, jzf = jfilt.sosfilt(sos, x)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-10)
    np.testing.assert_allclose(got.numpy(), np.asarray(jy), rtol=0, atol=1e-12)
    np.testing.assert_allclose(zf.numpy(), np.asarray(jzf), rtol=0, atol=1e-12)


@pytest.mark.parametrize("shape", [(3, 500), (500,)])
def test_sosfiltfilt_matches_scipy_and_jax(shape):
    sos = sp.butter(8, [0.14, 0.3], "bp", output="sos")
    x = _rng().standard_normal(shape)
    got = tfilt.sosfiltfilt(sos, _t(x)).numpy()
    assert got.shape == shape
    np.testing.assert_allclose(got, sp.sosfiltfilt(sos, x, axis=-1), atol=1e-9)
    np.testing.assert_allclose(got, np.asarray(jfilt.sosfiltfilt(sos, x)), rtol=0, atol=1e-12)


def test_bp_filt_exact_matches_the_reference_and_jax():
    x = _rng().standard_normal((5, 1200))
    got = tfilt.bp_filt(_t(x), FS, 14.0, 30.0, mode="exact").numpy()
    b, a = sp.butter(8, [14 / (FS / 2), 30 / (FS / 2)], "bp")
    # the order-16 (b, a) direct form: tests/test_filters.py's 5e-6
    np.testing.assert_allclose(got, sp.filtfilt(b, a, x, axis=1), atol=5e-6)
    # XLA may fuse the recurrence's multiply-adds; the order-16 direct form
    # amplifies that rounding, so JAX is held to the same 5e-6
    np.testing.assert_allclose(got, np.asarray(jfilt.bp_filt(x, FS, 14.0, 30.0, mode="exact")),
                               rtol=0, atol=5e-6)


def test_bp_filt_fft_and_fft_zero_phase_match_jax():
    x = _rng().standard_normal((6, 2000)).astype(np.float32)
    _assert_near(_j32(jfilt.bp_filt, x, FS, 14.0, 30.0), tfilt.bp_filt(_t(x), FS, 14.0, 30.0))
    sos = sp.butter(8, [14 / (FS / 2), 30 / (FS / 2)], "bp", output="sos")
    for padlen in (0, 100):
        _assert_near(_j32(jfilt.fft_zero_phase, x, sos, padlen),
                     tfilt.fft_zero_phase(_t(x), sos, padlen=padlen))
    with pytest.raises(ValueError, match="mode"):
        tfilt.bp_filt(_t(x), FS, 14.0, 30.0, mode="fast")


# ---------------------------------------------------------------------------
# ops/fk.py
# ---------------------------------------------------------------------------

DESIGNERS = ("fk_filter_design", "hybrid_filter_design", "hybrid_ninf_filter_design",
             "hybrid_gs_filter_design", "hybrid_ninf_gs_filter_design")


@pytest.mark.parametrize("name", DESIGNERS)
@pytest.mark.parametrize("shape,sel", [((64, 600), [0, 64, 1]), ((41, 999), [10, 92, 2])])
def test_fk_designers_are_bitwise(name, shape, sel):
    got = getattr(tfk, name)(shape, sel, 2.042, FS)
    want = getattr(jfk, name)(shape, sel, 2.042, FS)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sigma,tint", [(20.0, 1.0), (40.0, 2.0)])
def test_speed_fan_mask_is_bitwise(sigma, tint):
    args = ((48, 512), FS, 2.042, 1400.0, 3500.0)
    np.testing.assert_array_equal(tfk.speed_fan_mask(*args, tint=tint, sigma=sigma),
                                  jfk.speed_fan_mask(*args, tint=tint, sigma=sigma))


@pytest.fixture(scope="module")
def fk_block():
    x = _rng(7).standard_normal((48, 700)).astype(np.float32)
    mask = jfk.hybrid_ninf_filter_design((48, 700), [0, 48, 1], 2.042, FS)
    return x, mask


def test_fk_filter_apply_and_rfft_match_jax(fk_block):
    x, mask = fk_block
    ref = _j32(jfk.fk_filter_apply, x, mask.astype(np.float32))
    got = tfk.fk_filter_apply(_t(x), mask)
    assert got.dtype == torch.float32
    _assert_near(ref, got)
    _assert_near(_j32(jfk.fk_filter_apply_rfft, x, mask.astype(np.float32)),
                 tfk.fk_filter_apply_rfft(_t(x), mask))
    # the half-spectrum route equals the full one (the mask's Hermitian part)
    _assert_near(got.numpy(), tfk.fk_filter_apply_rfft(_t(x), _t(mask)))


def test_fk_filter_apply_stacks_blocks(fk_block):
    x, mask = fk_block
    stack = np.stack([x, 2 * x])
    got = tfk.fk_filter_apply(_t(stack), mask)
    one = tfk.fk_filter_apply(_t(x), mask)
    _assert_near(one.numpy(), got[0])
    _assert_near(2 * one.numpy(), got[1])


def test_fk_filt_matches_jax(fk_block):
    x, _ = fk_block
    _assert_near(_j32(jfk.fk_filt, x, 1.0, FS, 1.0, 2.042, 1400.0, 3500.0),
                 tfk.fk_filt(_t(x), 1.0, FS, 1.0, 2.042, 1400.0, 3500.0))


def test_point_reflect_matches_jax():
    m = _rng(3).standard_normal((6, 9))
    with jax.enable_x64(True):
        want = np.array(jfk._point_reflect(jnp.asarray(m)))
    np.testing.assert_array_equal(tfk._point_reflect(_t(m)).numpy(), want)


# ---------------------------------------------------------------------------
# ops/spectral.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,alpha", [(500, 0.03), (501, 0.5), (64, 0.0), (64, 1.0)])
def test_tukey_window_matches_jax_and_scipy(n, alpha):
    """float32 within 2 ulp of 1.0 of JAX's (the cosines of two libraries
    round apart), within 1e-6 of scipy's float64 window."""
    got = tspec.tukey_window(n, alpha).numpy()
    np.testing.assert_allclose(got, _j32(jspec.tukey_window, n, alpha), rtol=0, atol=2 ** -22)
    np.testing.assert_allclose(got, sp.windows.tukey(n, alpha), atol=1e-6)


def _chirps(nx=6, ns=1000, seed=5):
    t = np.arange(ns) / FS
    rng = _rng(seed)
    f0 = rng.uniform(10, 40, size=(nx, 1))
    x = np.cos(2 * np.pi * (f0 * t + 3.0 * t ** 2)) * np.hanning(ns)
    return (x + 0.01 * rng.standard_normal((nx, ns))).astype(np.float32)


@pytest.mark.parametrize("nfft", [1000, 1024, 1500])
def test_fx_transform_matches_jax(nfft):
    x = _chirps()
    _assert_near(_j32(jspec.fx_transform, x, nfft), tspec.fx_transform(_t(x), nfft))


@pytest.mark.parametrize("nfft,overlap", [(128, 0.8), (64, 0.5)])
def test_spectrogram_matches_jax(nfft, overlap):
    x = _chirps()[0]
    jp, jtt, jff = _j32(jspec.spectrogram, x, FS, nfft, overlap)
    p, tt, ff = tspec.spectrogram(_t(x), FS, nfft, overlap)
    np.testing.assert_array_equal(tt, jtt)
    np.testing.assert_array_equal(ff, jff)
    # dB re the max: hold it where the bins lie within 60 dB of the max
    keep = jp > -60
    np.testing.assert_allclose(p.numpy()[keep], jp[keep], rtol=0, atol=1e-3)


def test_instant_freq_matches_jax():
    """float64: within 1e-9 of the max. float32: the unwrapped phase grows
    to hundreds of radians and its running sum rounds by library, so the
    bound is 8 float32 ulps of the largest phase, in Hz (``* fs / 2pi``).
    Held away from the window's quiet ends, where the phase is defined."""
    x = _chirps()
    x64 = x.astype(np.float64)
    with jax.enable_x64(True):
        ref64 = np.array(jspec.instant_freq(jnp.asarray(x64), FS))
    _assert_near(ref64[:, 100:-100], tspec.instant_freq(_t(x64), FS)[:, 100:-100], rel=1e-9)
    ref = _j32(jspec.instant_freq, x, FS)
    got = tspec.instant_freq(_t(x), FS).numpy()
    phase = np.unwrap(np.angle(sp.hilbert(x64)), axis=-1)
    bound = 8 * np.finfo(np.float32).eps * np.abs(phase).max() * FS / (2 * np.pi)
    np.testing.assert_allclose(got[:, 100:-100], ref[:, 100:-100], rtol=0, atol=bound)


def test_unwrap_matches_numpy_on_a_wrapping_phase():
    rng = _rng(11)
    phase = np.cumsum(rng.uniform(0.0, 3.0, size=(3, 400)), axis=-1)
    wrapped = np.angle(np.exp(1j * phase))
    got = tspec.unwrap(_t(wrapped)).numpy()
    np.testing.assert_array_equal(got, np.unwrap(wrapped))
    np.testing.assert_allclose(got, phase, atol=1e-9)
    # float32, against jnp.unwrap (which sums its corrections in another order)
    w32 = wrapped.astype(np.float32)
    _assert_near(_j32(jnp.unwrap, w32), tspec.unwrap(_t(w32)))


def test_taper_data_matches_jax():
    """The window's 2 ulps (above) times the data."""
    x = _chirps()
    np.testing.assert_allclose(tspec.taper_data(_t(x)).numpy(), _j32(jspec.taper_data, x),
                               rtol=0, atol=2 ** -22 * np.abs(x).max())


def test_taper_data_takes_an_alpha_where_jax_raises():
    """JAX's ``taper_data`` is jitted with ``alpha`` traced, so any alpha
    passed to it reaches ``tukey_window``'s Python branch as a tracer and
    raises (a reference fault the port does not reproduce: ROADMAP §3).
    The port's equals the taper JAX's own window gives."""
    x = _chirps()
    with pytest.raises(jax.errors.TracerBoolConversionError):
        _j32(jspec.taper_data, x, 0.2)
    want = x * _j32(jspec.tukey_window, x.shape[-1], 0.2)
    np.testing.assert_allclose(tspec.taper_data(_t(x), 0.2).numpy(), want, rtol=0,
                               atol=2 ** -22 * np.abs(x).max())


# ---------------------------------------------------------------------------
# ops/xcorr.py
# ---------------------------------------------------------------------------

def test_shift_xcorr_and_nxcorr_match_jax_and_scipy():
    rng = _rng(2)
    x = rng.standard_normal(700).astype(np.float32)
    y = rng.standard_normal(700).astype(np.float32)
    got = txcorr.shift_xcorr(_t(x), _t(y))
    _assert_near(_j32(jxcorr.shift_xcorr, x, y), got)
    _assert_near(sp.correlate(x.astype(np.float64), y, "full")[len(x) - 1:], got)
    _assert_near(_j32(jxcorr.shift_nxcorr, x, y), txcorr.shift_nxcorr(_t(x), _t(y)))


def test_compute_cross_correlogram_matches_jax():
    rng = _rng(4)
    data = rng.standard_normal((12, 800)).astype(np.float32)
    template = np.zeros(800, np.float32)
    template[:137] = np.hanning(137) * np.cos(np.linspace(0, 60, 137))
    got = txcorr.compute_cross_correlogram(_t(data), _t(template))
    assert got.dtype == torch.float32
    _assert_near(_j32(jxcorr.compute_cross_correlogram, data, template), got)


# ---------------------------------------------------------------------------
# ops/conditioning.py, ops/peaks.py
# ---------------------------------------------------------------------------

def test_condition_segmented_matches_jax_and_pads_to_zero():
    rng = _rng(8)
    segs = [300, 250]
    raw = rng.integers(-5000, 5000, size=(6, 560)).astype(np.int32)
    raw[:, 550:] = 0                                  # divisibility padding
    means = np.stack([raw[:, :300].mean(axis=1, dtype=np.float32),
                      raw[:, 300:550].mean(axis=1, dtype=np.float32),
                      np.zeros(6, np.float32)], axis=1)
    ids = np.full(560, 2, np.int32)
    ids[:550] = np.repeat(np.arange(2), segs)
    scale = 1.234e-9
    want = _j32(jcond.condition_segmented, raw, scale, ids, means)
    got = tcond.condition_segmented(_t(raw), scale, ids, means)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.all(got.numpy()[:, 550:] == 0)
    # per file it is the host route's demean-and-scale
    host = (raw[:, :300].astype(np.float32) - means[:, :1]) * np.float32(scale)
    np.testing.assert_array_equal(got.numpy()[:, :300], host)


@pytest.mark.parametrize("tile,method", [(4, "topk"), (5, "pack"), (64, "topk")])
def test_find_peaks_sparse_tiled_is_bitwise_jax(tile, method):
    rng = _rng(9)
    env = np.abs(rng.standard_normal((2, 13, 400))).astype(np.float32)
    thr = np.array([[1.5], [2.0]], np.float32)
    want = _j32(jpeaks.find_peaks_sparse_tiled, env, thr, max_peaks=16, tile=tile,
                method=method)
    got = tpeaks.find_peaks_sparse_tiled(_t(env), _t(thr), max_peaks=16, tile=tile,
                                         method=method)
    for field in tpeaks.SparsePicks._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(), getattr(want, field),
                                      err_msg=field)
    untiled = tpeaks.find_peaks_sparse_batched(_t(env), _t(thr), max_peaks=16, method=method)
    for field in tpeaks.SparsePicks._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      getattr(untiled, field).numpy())
