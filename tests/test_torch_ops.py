"""Port parity, device ops: das4whales_tpu_torch (on the CPU) against
das4whales_tpu (float32, x64 off — the JAX package's production mode).

Same numpy inputs to both. Tolerance: ``atol = 1e-5 * max|ref|``,
because pocketfft (torch on the CPU) and XLA's FFT round differently and
reductions run in another order.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from das4whales_tpu.io.synth import SyntheticScene
from das4whales_tpu.models import matched_filter as jmf
from das4whales_tpu.ops import conditioning as jcond
from das4whales_tpu.ops import fk as jfk
from das4whales_tpu.ops import spectral as jspec
from das4whales_tpu.ops import xcorr as jxcorr
from das4whales_tpu_torch.models import matched_filter as tmf
from das4whales_tpu_torch.ops import conditioning as tcond
from das4whales_tpu_torch.ops import fk as tfk
from das4whales_tpu_torch.ops import spectral as tspec
from das4whales_tpu_torch.ops import xcorr as txcorr
from tests.torch_threads import one_torch_thread  # noqa: F401

REL = 1e-5


def _j32(fn, *args, **kw):
    """Run a JAX function in float32 mode; return host numpy."""
    with jax.enable_x64(False):
        out = fn(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args], **kw)
        return jax.tree_util.tree_map(np.array, out)  # copies: never alias a JAX buffer


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_near(ref, got):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    scale = float(np.abs(ref).max())
    assert scale > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=REL * scale)


@pytest.fixture(scope="module")
def block():
    rng = np.random.default_rng(7)
    return rng.normal(size=(48, 1000)).astype(np.float32)


@pytest.fixture(scope="module")
def design():
    shape = (48, 1000)
    d = jmf.design_matched_filter(shape, [0, 48, 1], SyntheticScene(nx=48, ns=1000).metadata)
    mask_band, lo, hi = jfk.banded_mask_half(d.fk_mask)
    return d, mask_band, lo, hi


@pytest.mark.parametrize("dtype", [np.int32, np.int16])
def test_condition_matches(dtype):
    rng = np.random.default_rng(1)
    raw = rng.integers(-3000, 3000, size=(16, 777)).astype(dtype)
    scale = 1.234e-9
    _assert_near(_j32(jcond.condition, raw, scale), tcond.condition(_t(raw), scale).numpy())


def test_condition_padded_matches():
    rng = np.random.default_rng(2)
    raw = np.zeros((16, 1024), np.int32)
    raw[:, :900] = rng.integers(-3000, 3000, size=(16, 900))
    ref = _j32(jcond.condition_padded, raw, 2.5e-9, 900)
    got = tcond.condition_padded(_t(raw), 2.5e-9, 900).numpy()
    _assert_near(ref, got)
    assert np.all(got[:, 900:] == 0)


@pytest.mark.parametrize("n_real", [np.int64(900), np.int32(900), np.asarray(900),
                                    torch.tensor(900)])
def test_condition_padded_takes_any_scalar_length(n_real):
    rng = np.random.default_rng(2)
    raw = np.zeros((16, 1024), np.int32)
    raw[:, :900] = rng.integers(-3000, 3000, size=(16, 900))
    want = tcond.condition_padded(_t(raw), 2.5e-9, 900)
    got = tcond.condition_padded(_t(raw), 2.5e-9, n_real)
    assert got.shape == (16, 1024)
    assert torch.equal(got, want)


def test_fk_apply_banded_matches(block, design):
    _, mask_band, lo, hi = design
    ref = _j32(jfk.fk_filter_apply_rfft_banded, block, mask_band, lo=lo, hi=hi)
    got = tfk.fk_filter_apply_rfft_banded(_t(block), _t(mask_band), lo, hi).numpy()
    _assert_near(ref, got)


def test_mf_filter_fused_matches(block, design):
    d, mask_band, lo, hi = design
    from das4whales_tpu.ops.filters import butter_zero_phase_gain

    fused = mask_band * butter_zero_phase_gain(1000, 200.0, (14.0, 30.0))[lo:hi][None, :]
    ref = _j32(jmf.mf_filter_fused, block, fused, band_lo=lo, band_hi=hi)
    got = tmf.mf_filter_fused(_t(block), _t(fused), lo, hi).numpy()
    _assert_near(ref, got)


def _template_triple(d):
    return jxcorr.padded_template_stats(d.templates)


def test_corrected_correlograms_match(block, design):
    d = design[0]
    tt, mu, sc = _template_triple(d)
    ref = _j32(jxcorr.compute_cross_correlograms_corrected, block, tt, mu, sc)
    got = txcorr.compute_cross_correlograms_corrected(_t(block), _t(tt), _t(mu), _t(sc)).numpy()
    assert got.shape == (2, 48, 1000)
    _assert_near(ref, got)


def test_correlate_tiled_matches(block, design):
    d = design[0]
    tt, mu, sc = _template_triple(d)
    corr_j, gmax_j = _j32(jmf.mf_correlate_tiled, block, tt, mu, sc, tile=20)
    n_tiles, nT, tile, n = corr_j.shape
    corr_j = np.swapaxes(corr_j, 0, 1).reshape(nT, n_tiles * tile, n)[:, :48]
    tiles, gmax_t = tmf.mf_correlate_tiled(_t(block), _t(tt), _t(mu), _t(sc), 20)
    assert [t.shape[1] for t in tiles] == [20, 20, 8]
    _assert_near(corr_j, torch.cat(tiles, dim=1).numpy())
    np.testing.assert_allclose(gmax_t.numpy(), gmax_j, rtol=REL)


@pytest.mark.parametrize("n", [1000, 777])
def test_analytic_signal_and_envelope_match(n):
    rng = np.random.default_rng(n)
    x = rng.normal(size=(3, 5, n)).astype(np.float32)
    ref = _j32(jspec.analytic_signal, x)
    got = tspec.analytic_signal(_t(x)).numpy()
    assert got.dtype == np.complex64
    _assert_near(ref.real, got.real)
    _assert_near(ref.imag, got.imag)
    _assert_near(_j32(jspec.envelope_sqrt, x), tspec.envelope_sqrt(_t(x)).numpy())


def test_envelope_is_sqrt_of_squares_not_abs():
    # complex abs is a scaled hypot; the envelope the pick kernel computes
    # is sqrt(re*re + im*im) with each operation rounded — they part where
    # the squares leave the float32 range
    z = torch.complex(torch.tensor([3e-20, 1e20, 0.6]), torch.tensor([4e-20, 1e20, 0.8]))
    mag = tspec.magnitude_sqrt(z).numpy()
    hyp = torch.abs(z).numpy()
    assert np.isinf(mag[1]) and np.isfinite(hyp[1])
    assert mag[0] != hyp[0]
    np.testing.assert_allclose(mag[2], 1.0, rtol=1e-7)


@pytest.mark.parametrize("periodic", [False, True])
def test_hann_window_matches(periodic):
    np.testing.assert_allclose(
        tspec.hann_window(33, periodic=periodic).numpy(),
        _j32(jspec.hann_window, 33, periodic=periodic), rtol=0, atol=1e-7)
