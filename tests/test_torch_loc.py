"""Port parity, localization: ``das4whales_tpu_torch.loc`` on the CPU
against ``das4whales_tpu.loc``, both in float64 (JAX runs ``loc`` with
x64 on, as its own tests do: at 40 km positions with ``1/c0²`` columns
float32 normal equations lose the solve).

Tolerances are ``tests/test_loc.py``'s per function: the forward model
and the geometry helpers rtol 1e-12; the solvers rtol 1e-9 (the same
iteration, ``torch.linalg.solve`` against XLA's); variance,
uncertainty and residuals rtol 1e-9 with an absolute floor of 1e-12 of
their scale (residuals of an exact forward model are rounding).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from das4whales_tpu import loc as jloc
from das4whales_tpu_torch import loc as tloc

C0 = 1480.0
RTOL = 1e-9


def make_cable(nch=220):
    """``tests/test_loc.py``'s OOI-like cable: a gently curving line."""
    s = np.linspace(0.0, 45000.0, nch)
    x = 20000.0 + s
    y = 20000.0 + 4000.0 * np.sin(s / 30000.0)
    z = -500.0 - 100.0 * np.cos(s / 15000.0)
    return np.stack([x, y, z], axis=1)


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


@pytest.fixture(scope="module")
def cable():
    return make_cable()


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, rtol=RTOL):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float64
    floor = 1e-12 * max(float(np.nanmax(np.abs(want))), 1e-300)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=floor)


def _times(cable, events, noise=0.0, seed=7):
    rng = np.random.default_rng(seed)
    return np.stack([np.asarray(jloc.calc_arrival_times(e[3], cable, e[:3], C0))
                     + noise * rng.standard_normal(len(cable)) for e in events])


EVENTS = np.array([[41000.0, 24500.0, -40.0, 1.5], [38000.0, 21000.0, -25.0, 0.2],
                   [52000.0, 26000.0, -80.0, 3.0], [43000.0, 22000.0, -50.0, 0.7]])


def test_forward_model_and_geometry_helpers(cable):
    pos = np.array([41000.0, 24000.0, -30.0, 1.0])
    _close(tloc.calc_arrival_times(2.0, cable, pos[:3], C0, device="cpu"),
           jloc.calc_arrival_times(2.0, cable, pos[:3], C0), rtol=1e-12)
    for name in ("calc_distance_matrix", "calc_radii_matrix", "calc_theta_vector",
                 "calc_phi_vector"):
        _close(getattr(tloc, name)(cable, pos, device="cpu"), getattr(jloc, name)(cable, pos),
               rtol=1e-12)


@pytest.mark.parametrize("fix_z", [False, True])
@pytest.mark.parametrize("n_iter", [10, 30])
def test_solve_lq_matches_jax(cable, fix_z, n_iter):
    Ti = _times(cable, EVENTS[3:], noise=1e-3)[0]
    guess = np.array([40000.0, 23000.0, -50.0, float(np.min(Ti))])
    _close(tloc.solve_lq(Ti, cable, C0, n_iter=n_iter, fix_z=fix_z, device="cpu"),
           jloc.solve_lq(Ti, cable, C0, n_iter=n_iter, fix_z=fix_z))
    got = tloc.solve_lq(Ti, cable, C0, n_iter=n_iter, fix_z=fix_z, initial_guess=guess,
                        device="cpu")
    _close(got, jloc.solve_lq(Ti, cable, C0, n_iter=n_iter, fix_z=fix_z, initial_guess=guess))
    if fix_z:
        assert float(got[2]) == -50.0


def test_solver_reference_parity(cable):
    """The free-z branch hand-written in numpy (``tests/test_loc.py``)."""
    true_pos = np.array([43000.0, 22000.0, -50.0, 0.7])
    Ti = _times(cable, [true_pos])[0]
    n = np.array([40000.0, 23000.0, -60.0, np.min(Ti)])
    lam = tloc.LAMBDA_REG * np.eye(4)
    for j in range(10):
        rj = np.sqrt(((cable[:, :2] - n[:2]) ** 2).sum(axis=1))
        thj = np.arctan2(abs(n[2] - cable[:, 2]), rj)
        phij = np.arctan2(n[1] - cable[:, 1], n[0] - cable[:, 0])
        dt = Ti - (n[3] + np.sqrt(((cable - n[:3]) ** 2).sum(axis=1)) / C0)
        G = np.array([np.cos(thj) * np.cos(phij) / C0, np.cos(thj) * np.sin(phij) / C0,
                      np.sin(thj) / C0, np.ones_like(thj)]).T
        n += (0.7 if j < 4 else 1.0) * (np.linalg.inv(G.T @ G + lam) @ G.T @ dt)
    np.testing.assert_allclose(_np(tloc.solve_lq(Ti, cable, C0, device="cpu")), n,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("fix_z", [False, True])
def test_solve_lq_batch_matches_jax_and_singles(cable, fix_z):
    Ti = _times(cable, EVENTS, noise=1e-4)
    Ti[1, 30:60] = np.nan                        # unpicked channels: zero weight
    got = tloc.solve_lq_batch(Ti, cable, C0, n_iter=20, fix_z=fix_z, device="cpu")
    _close(got, jloc.solve_lq_batch(Ti, cable, C0, n_iter=20, fix_z=fix_z))
    singles = torch.stack([tloc.solve_lq(t, cable, C0, n_iter=20, fix_z=fix_z, device="cpu")
                           for t in Ti])
    np.testing.assert_allclose(_np(got), _np(singles), rtol=1e-8, atol=1e-8)


def test_multistart_matches_jax_and_picks_the_true_basin(cable):
    rng = np.random.default_rng(3)
    true_pos = np.array([36000.0, 24500.0, -40.0, 0.9])
    Ti = _times(cable, [true_pos])[0] + 2e-3 * rng.standard_normal(len(cable))
    guesses = tloc.mirror_guesses(cable, Ti, C0, z0=-40.0)
    np.testing.assert_array_equal(guesses, jloc.mirror_guesses(cable, Ti, C0, z0=-40.0))
    got = tloc.solve_lq_multistart(Ti, cable, C0, guesses, n_iter=50, fix_z=True, device="cpu")
    _close(got, jloc.solve_lq_multistart(Ti, cable, C0, guesses, n_iter=50, fix_z=True))
    assert abs(float(got[1]) - true_pos[1]) < 100.0


@pytest.mark.parametrize("fix_z", [False, True])
def test_variance_covariance_uncertainty_match_jax(cable, fix_z):
    pos = np.array([41000.0, 24500.0, -40.0, 1.5])
    Ti = _times(cable, [pos], noise=5e-3, seed=11)[0]
    pred = np.asarray(jloc.calc_arrival_times(pos[3], cable, pos[:3], C0))
    var = jloc.cal_variance_residuals(Ti, pred, fix_z=fix_z)
    _close(tloc.cal_variance_residuals(Ti, pred, fix_z=fix_z, device="cpu"), var)
    w = np.ones(len(cable))
    w[::7] = 0.0
    _close(tloc.calc_covariance_matrix(cable, pos, C0, float(var), fix_z=fix_z, weights=w,
                                       device="cpu"),
           jloc.calc_covariance_matrix(cable, pos, C0, var, fix_z=fix_z, weights=w))
    unc = tloc.calc_uncertainty_position(cable, pos, C0, float(var), fix_z=fix_z, device="cpu")
    assert unc.shape == ((3,) if fix_z else (4,))
    _close(unc, jloc.calc_uncertainty_position(cable, pos, C0, var, fix_z=fix_z))


def test_near_singular_normal_matrix_regularises_as_jax():
    """A cable of two channels: ``G^T G`` is singular, and the Tikhonov
    term joins in both packages."""
    cable = make_cable(2)
    pos = np.array([41000.0, 24500.0, -40.0, 1.5])
    _close(tloc.calc_covariance_matrix(cable, pos, C0, 1e-6, device="cpu"),
           jloc.calc_covariance_matrix(cable, pos, C0, 1e-6))


@pytest.mark.parametrize("fix_z", [False, True])
def test_localize_matches_jax(cable, fix_z):
    rng = np.random.default_rng(5)
    true_pos = np.array([41000.0, 24500.0, -40.0, 1.5])
    Ti = _times(cable, [true_pos], noise=1e-3)[0]
    picked = rng.choice(len(cable), size=len(cable) // 2, replace=False)
    ti = tloc.picks_to_arrival_times(picked, Ti[picked], len(cable))
    np.testing.assert_array_equal(ti, jloc.picks_to_arrival_times(picked, Ti[picked],
                                                                   len(cable)))
    guess = np.array([40000.0, 23000.0, -40.0, float(np.nanmin(ti))])
    got = tloc.localize(ti, cable, C0, n_iter=30, fix_z=fix_z, initial_guess=guess,
                        device="cpu")
    want = jloc.localize(ti, cable, C0, n_iter=30, fix_z=fix_z, initial_guess=guess)
    assert isinstance(got, tloc.LocalizationResult)
    for g, w in zip(got, want):
        _close(g, w)
    assert np.isnan(_np(got.residuals)).sum() == np.isnan(ti).sum()


def test_localize_batch_matches_jax(cable):
    Ti = _times(cable, EVENTS, noise=1e-3)
    got = tloc.localize_batch(Ti, cable, C0, n_iter=25, device="cpu")
    want = jloc.localize_batch(Ti, cable, C0, n_iter=25)
    assert got.position.shape == (4, 4) and got.variance.shape == (4,)
    for g, w in zip(got, want):
        _close(g, w)


def test_tensor_inputs_stay_on_their_device(cable):
    Ti = torch.from_numpy(_times(cable, EVENTS[:1])[0])
    res = tloc.localize(Ti, torch.from_numpy(cable), C0)     # no device=: the tensors'
    assert res.position.device.type == "cpu"
    assert res.position.dtype == torch.float64
    f32 = tloc.solve_lq(Ti.float(), cable, C0)
    assert f32.dtype == torch.float64
