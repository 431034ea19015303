"""Port parity, pick stage: das4whales_tpu_torch.ops.peaks /
ops.fused_picks (plain PyTorch, on the CPU) against das4whales_tpu.ops.peaks
and the Pallas pick kernel (interpret mode), float32.

Contract: positions, selected and saturated bitwise equal; heights to
rtol 1e-6 (the JAX routes may fuse the envelope's multiply-adds into an
FMA; the port rounds each operation), and prominences — a difference of
two such heights — to 1e-6 of the heights they are taken from. The cases cover both slot
methods, the shapes of tests/test_pallas_picks.py, plateaus, tied
heights, saturated rows and +inf-threshold rows — and the three JAX
idioms the port spells out (stable argsort, ``lax.top_k`` ties toward the
lower index, ``.at[].set(mode="drop")``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sps
import torch

from das4whales_tpu.ops import pallas_picks as jpallas
from das4whales_tpu.ops import peaks as jpeaks
from das4whales_tpu.ops import spectral as jspec
from das4whales_tpu_torch.ops import fused_picks as tfused
from das4whales_tpu_torch.ops import peaks as tpeaks
from das4whales_tpu_torch.ops import spectral as tspec

SHAPES = [(3, 10, 777), (2, 8, 512), (1, 3, 1000)]


def _j32(fn, *args, **kw):
    with jax.enable_x64(False):
        out = fn(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args], **kw)
        return jax.tree_util.tree_map(np.array, out)  # copies: never alias a JAX buffer


def _assert_same_picks(t, j):
    """positions/selected/saturated bitwise; heights/prominences rtol 1e-6."""
    for f in ("positions", "selected", "saturated"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)), err_msg=f)
    h = t.heights.numpy()
    np.testing.assert_allclose(h, np.asarray(j.heights), rtol=1e-6, err_msg="heights")
    h_scale = float(np.abs(h[np.isfinite(h)]).max(initial=0.0))
    np.testing.assert_allclose(t.prominences.numpy(), np.asarray(j.prominences),
                               rtol=1e-6, atol=1e-6 * h_scale, err_msg="prominences")
    assert t.positions.dtype == torch.int32 and t.selected.dtype == torch.bool


def _envelope(shape, seed):
    rng = np.random.default_rng(seed)
    corr = (2.0 * rng.normal(size=shape)).astype(np.float32)
    return _j32(jspec.envelope_sqrt, corr)


def _special_rows(T=1000, seed=5):
    """(env [6, T], thr [6]): plateaus, ties, saturation, +inf threshold."""
    rng = np.random.default_rng(seed)
    smooth = np.convolve(rng.normal(size=T + 8), np.ones(8) / 8, "same")[:T]
    quant = np.abs(np.round(smooth * 3) / 3)                 # plateaus + ties
    tri = np.tile(np.r_[np.arange(10), np.arange(10, 0, -1)] / 10.0, T // 20 + 1)[:T]
    edge = 0.1 * np.abs(rng.normal(size=T))
    edge[:30] = edge[-30:] = 5.0                             # edge plateaus
    edge[T // 3 : T // 3 + 200] = 4.0                        # long plateau
    noise = np.abs(rng.normal(size=T))
    env = np.stack([quant, tri, edge, noise, noise, np.zeros(T)]).astype(np.float32)
    thr = np.asarray([0.2, 0.5, 1.0, 0.05, np.inf, np.inf], np.float32)
    return env, thr


@pytest.mark.parametrize("method", ["pack", "topk"])
@pytest.mark.parametrize("shape", SHAPES)
def test_find_peaks_sparse_batched_matches(method, shape):
    env = _envelope(shape, seed=shape[-1])
    thr = np.linspace(0.8, 1.2, shape[0]).astype(np.float32)[:, None]
    j = _j32(jpeaks.find_peaks_sparse_batched, env, thr, max_peaks=32, method=method)
    t = tpeaks.find_peaks_sparse_batched(torch.from_numpy(env), torch.from_numpy(thr),
                                         max_peaks=32, method=method)
    _assert_same_picks(t, j)
    assert int(t.selected.sum()) > 0


@pytest.mark.parametrize("K", [4, 64])
@pytest.mark.parametrize("method", ["pack", "topk"])
def test_special_rows_match(method, K):
    env, thr = _special_rows()
    j = _j32(jpeaks.find_peaks_sparse, env, thr, max_peaks=K, method=method)
    t = tpeaks.find_peaks_sparse(torch.from_numpy(env), torch.from_numpy(thr),
                                 max_peaks=K, method=method)
    _assert_same_picks(t, j)
    sat = t.saturated.numpy()
    assert sat[3] and (sat[1] or K > 50)          # low threshold; 50 tied peaks
    assert not t.selected.numpy()[4:].any()       # +inf thresholds select nothing
    assert int(t.selected.sum()) > 0


def test_topk_ties_break_toward_lower_index():
    # 50 identical peaks, K = 8: top_k keeps the 8 lowest-index ones
    env = np.tile(np.r_[0.0, 1.0], 50).astype(np.float32)[None, :]
    env = np.concatenate([env, [[0.0]]], axis=1)
    t = tpeaks.find_peaks_sparse(torch.from_numpy(env), 0.5, max_peaks=8, method="topk")
    j = _j32(jpeaks.find_peaks_sparse, env, 0.5, max_peaks=8, method="topk")
    _assert_same_picks(t, j)
    np.testing.assert_array_equal(t.positions.numpy()[0], np.arange(1, 17, 2))


@pytest.mark.parametrize("method", ["pack", "topk"])
@pytest.mark.parametrize("shape", SHAPES)
def test_envelope_peaks_matches_pallas_kernel(method, shape):
    rng = np.random.default_rng(shape[-1])
    re = (2.0 * rng.normal(size=shape)).astype(np.float32)
    im = (2.0 * rng.normal(size=shape)).astype(np.float32)
    thr = np.linspace(2.0, 3.0, shape[0]).astype(np.float32)[:, None]
    j = _j32(jpallas.envelope_peaks_sparse, re, im, thr, max_peaks=32, method=method,
             interpret=True)
    launches = tfused.launches
    t = tfused.envelope_peaks_sparse(torch.from_numpy(re), torch.from_numpy(im),
                                     torch.from_numpy(thr), max_peaks=32, method=method)
    assert tfused.launches == launches            # the CPU runs the plain version
    _assert_same_picks(t, j)
    assert int(t.selected.sum()) > 0


@pytest.mark.parametrize("method", ["pack", "topk"])
def test_envelope_peaks_special_rows_match_pallas_kernel(method):
    env, thr = _special_rows(T=600)
    im = np.zeros_like(env)
    j = _j32(jpallas.envelope_peaks_sparse, env, im, thr, max_peaks=16, method=method,
             interpret=True)
    t = tfused.envelope_peaks_sparse(torch.from_numpy(env), torch.from_numpy(im),
                                     torch.from_numpy(thr), max_peaks=16, method=method)
    _assert_same_picks(t, j)


def test_analytic_envelope_peaks_matches_jnp_route():
    rng = np.random.default_rng(11)
    corr = (2.0 * rng.normal(size=(2, 6, 800))).astype(np.float32)
    thr = np.asarray([[2.2], [2.6]], np.float32)
    env = _j32(jspec.envelope_sqrt, corr)
    j = _j32(jpeaks.find_peaks_sparse_batched, env, thr, max_peaks=16, method="pack")
    t = tfused.analytic_envelope_peaks(torch.from_numpy(corr), torch.from_numpy(thr),
                                       max_peaks=16, method="pack")
    for f in ("positions", "selected", "saturated"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), getattr(j, f))


@pytest.mark.parametrize("capacity", [500, 7])
def test_compact_picks_rowmajor_matches(capacity):
    rng = np.random.default_rng(capacity)
    pos = rng.integers(0, 1000, size=(2, 30, 8)).astype(np.int32)
    sel = rng.random((2, 30, 8)) < 0.2
    j = _j32(jpeaks.compact_picks_rowmajor, pos, sel, capacity=capacity)
    t = tpeaks.compact_picks_rowmajor(torch.from_numpy(pos), torch.from_numpy(sel), capacity)
    for a, b in zip(t, j):
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), b)
    if capacity == 7:
        assert int(t[2].max()) > capacity         # overflow reported, not hidden


def test_local_maxima_matches():
    env, _ = _special_rows()
    np.testing.assert_array_equal(tpeaks.local_maxima(torch.from_numpy(env)).numpy(),
                                  _j32(jpeaks.local_maxima, env))


def test_sparse_picks_equal_scipy_find_peaks():
    env = _envelope((6, 900), seed=3)
    thr = 2.5
    t = tpeaks.find_peaks_sparse(torch.from_numpy(env), thr, max_peaks=256, method="topk")
    assert not t.saturated.any()
    got = tpeaks.sparse_to_pick_times(t.positions.numpy(), t.selected.numpy())
    chan, time = [], []
    for i, row in enumerate(env):
        pk = sps.find_peaks(row, prominence=thr)[0]
        chan += [i] * len(pk)
        time += pk.tolist()
    assert len(time) > 0
    np.testing.assert_array_equal(got, np.asarray([chan, time]))


def test_escalation_policy_and_kernel_needs_cuda():
    assert tpeaks.escalation_method(64, 256) == "pack"
    assert tpeaks.escalation_method(256, 256) == "topk"
    X = torch.zeros((2, 100), dtype=torch.complex64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfused.picks_cuda(X, torch.zeros(2), 8, "pack")
    with pytest.warns(UserWarning, match="saturated"):
        assert tpeaks.warn_saturated(np.asarray([1, 0]), "template HF", 8)
    assert not tpeaks.warn_saturated(np.asarray([0, 0]), "template HF", 8)


def test_magnitude_is_the_kernel_envelope():
    rng = np.random.default_rng(4)
    z = torch.complex(torch.from_numpy(rng.normal(size=50).astype(np.float32)),
                      torch.from_numpy(rng.normal(size=50).astype(np.float32)))
    np.testing.assert_array_equal(tspec.magnitude_sqrt(z).numpy(),
                                  np.sqrt(z.real.numpy() ** 2 + z.imag.numpy() ** 2))
