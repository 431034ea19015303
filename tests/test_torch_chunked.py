"""Port parity, the chunked ops: ``das4whales_tpu_torch.ops.chunked`` on
the CPU against ``das4whales_tpu.ops.chunked`` and scipy.

Tolerances: float64 on both sides (JAX with x64 on, as its own chunked
tests run): ``detrend_linear``, ``welch_psd``, ``spec`` and
``energy_time_domain`` rtol 1e-10 against JAX (``tests/test_chunked.py``
holds JAX to scipy at rtol 1e-8); the halo-chunked IIR filters 1e-12
against JAX (the same recurrence on the same windows; 1e-10 for the
order-8 ``(b, a)`` form, which amplifies XLA's fused multiply-adds) and
scipy's
unchunked filter at ``tests/test_chunked.py``'s 1e-8 / 1e-7;
``fk_filt_chunked`` in float32 within 1e-5 of the max against JAX.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sp
import torch

from das4whales_tpu.ops import chunked as jch
from das4whales_tpu_torch.ops import chunked as tch
from tests.torch_threads import one_torch_thread  # noqa: F401

FS = 200.0


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


def _rng(seed=1234):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, rtol=1e-10, atol=0.0):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


def test_detrend_linear_matches_jax_and_scipy():
    x = _rng().standard_normal((4, 300)) + np.linspace(0, 5, 300) + 2.0
    got = tch.detrend_linear(_t(x))
    _close(got, jch.detrend_linear(x), atol=1e-12)
    np.testing.assert_allclose(got.numpy(), sp.detrend(x, axis=-1), atol=1e-10)


@pytest.mark.parametrize("nperseg,noverlap,scaling", [(256, None, "density"),
                                                     (255, 100, "spectrum"),
                                                     (4096, None, "density")])
def test_welch_psd_matches_jax_and_scipy(nperseg, noverlap, scaling):
    x = _rng().standard_normal((3, 3000))
    got = tch.welch_psd(_t(x), FS, nperseg=nperseg, noverlap=noverlap, scaling=scaling)
    _close(got, jch.welch_psd(jnp.asarray(x), FS, nperseg=nperseg, noverlap=noverlap,
                              scaling=scaling), atol=1e-15)
    _, want = sp.welch(x, fs=FS, nperseg=min(nperseg, 3000), noverlap=noverlap, scaling=scaling)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8, atol=1e-12)
    np.testing.assert_array_equal(tch.welch_freqs(FS, nperseg), jch.welch_freqs(FS, nperseg))
    with pytest.raises(ValueError, match="noverlap"):
        tch.welch_psd(_t(x), FS, nperseg=64, noverlap=64)


def test_spec_and_energy_match_jax():
    x = _rng().standard_normal((2, 9100))
    got = tch.spec(_t(x), FS, chunk=3000, nperseg=1024)
    assert tuple(got.shape) == (2, 3, 513)
    _close(got, jch.spec(jnp.asarray(x), FS, chunk=3000, nperseg=1024), atol=1e-15)
    e = tch.energy_time_domain(_t(x), chunk=250)
    assert tuple(e.shape) == (2, 36)
    _close(e, jch.energy_time_domain(jnp.asarray(x), chunk=250))


@pytest.mark.parametrize("chunk", [500, 700, 5000])
def test_filtfilt_chunked_matches_jax_and_scipy(chunk):
    b, a = sp.butter(4, [14 / (FS / 2), 30 / (FS / 2)], "bp")
    x = _rng().standard_normal((3, 2000))
    got = tch.filtfilt_chunked(b, a, _t(x), chunk=chunk)
    # the order-8 (b, a) direct form amplifies XLA's fused multiply-adds
    _close(got, jch.filtfilt_chunked(b, a, jnp.asarray(x), chunk=chunk), rtol=0, atol=1e-10)
    np.testing.assert_allclose(got.numpy(), sp.filtfilt(b, a, x, axis=-1), atol=1e-8)


@pytest.mark.parametrize("chunk,halo", [(600, None), (800, 400)])
def test_sosfiltfilt_chunked_matches_jax_and_scipy(chunk, halo):
    sos = sp.butter(8, [14 / (FS / 2), 30 / (FS / 2)], "bp", output="sos")
    x = _rng().standard_normal((2, 2400))
    got = tch.sosfiltfilt_chunked(sos, _t(x), chunk=chunk, halo=halo)
    _close(got, jch.sosfiltfilt_chunked(sos, jnp.asarray(x), chunk=chunk, halo=halo),
           rtol=0, atol=1e-12)
    if halo is None:
        np.testing.assert_allclose(got.numpy(), sp.sosfiltfilt(sos, x, axis=-1), atol=1e-7)


def test_fk_filt_chunked_matches_jax():
    x = _rng().standard_normal((24, 600)).astype(np.float32)
    with jax.enable_x64(False):
        want = np.array(jch.fk_filt_chunked(jnp.asarray(x), 256, 1.0, FS, 1.0, 8.0, 1400.0,
                                            3500.0))
    got = tch.fk_filt_chunked(_t(x), 256, 1.0, FS, 1.0, 8.0, 1400.0, 3500.0)
    assert tuple(got.shape) == (24, 512) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_disp_comprate_is_the_compression_report():
    mask = np.zeros((10, 10))
    mask[4:6, 4:6] = 1.0
    assert tch.disp_comprate(mask, verbose=False) == jch.disp_comprate(mask, verbose=False)
    assert tch.disp_comprate(mask, verbose=False)["ratio"] == 25.0
