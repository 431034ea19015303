"""Port parity, evaluation: the port's ``eval`` (scoring, sweeps and the
detect -> localize loop) on the CPU against ``das4whales_tpu.eval``.

The detectors on both sides are the matched filter at its defaults on
the CPU (``pick_mode="auto"`` is scipy on the CPU in both packages); JAX
runs in float32 (x64 off), ``loc`` in float64 on both sides.

Tolerances: ``PickMatch``, ``match_picks``, the call association, the
scenes and ``sharded_picks_to_dict``: exact. The detector-driven metrics
(``evaluate_detector``, ``amplitude_sweep``, ``threshold_sweep``): the
counts exact wherever both packages' picks are equal, which the tests
check first (picks differing only on knife edges would move a count by
one; none does on these scenes); NaN (no picks) equals NaN. ``localize_scene_call``: on JAX's own
picks, the positions rtol 1e-9 (float64 ``loc``); on the port's picks,
``tests/test_detect_localize.py``'s bounds.
"""

from __future__ import annotations

from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from das4whales_tpu import eval as jeval
from das4whales_tpu.config import SPECTRO_HF_KERNEL, SPECTRO_LF_KERNEL
from das4whales_tpu.io.synth import SyntheticCall as JCall
from das4whales_tpu.io.synth import SyntheticScene as JScene
from das4whales_tpu.io.synth import synthesize_scene as jsynthesize_scene
from das4whales_tpu.models.matched_filter import MatchedFilterDetector as JMF
from das4whales_tpu.ops.peaks import SparsePicks as JSparse
from das4whales_tpu_torch import eval as teval
from das4whales_tpu_torch.io.synth import SyntheticCall, SyntheticScene, synthesize_scene
from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector
from das4whales_tpu_torch.ops.peaks import SparsePicks
from tests.torch_threads import one_torch_thread  # noqa: F401

TRUTH = dict(t0=3.0, x0_m=500.0, y0_m=300.0, z0_m=-20.0)


def _scenes(nx=64, ns=2000, amplitude=1.0, extra=()):
    """The same scene in both packages (the port's ``io.synth`` renders
    JAX's block)."""
    kw = [dict(t0=2.0, x0_m=nx / 2 * 2.042, amplitude=amplitude), *extra]
    return (SyntheticScene(nx=nx, ns=ns, noise_rms=0.05, calls=[SyntheticCall(**c) for c in kw]),
            JScene(nx=nx, ns=ns, noise_rms=0.05, calls=[JCall(**c) for c in kw]))


def _pm_equal(a: teval.PickMatch, b) -> None:
    np.testing.assert_array_equal(a.hits, b.hits)
    np.testing.assert_array_equal(a.covered, b.covered)
    assert (a.n_false, a.n_picks) == (b.n_false, b.n_picks)
    np.testing.assert_equal(a.recall, b.recall)
    np.testing.assert_equal(a.precision, b.precision)


def test_scene_geometry_matches_jax():
    ts, js = _scenes(extra=[dict(t0=5.0, x0_m=40.0, y0_m=700.0, z0_m=-30.0)])
    for tc, jc in zip(ts.calls, js.calls):
        np.testing.assert_array_equal(teval.arrival_times(tc, ts), jeval.arrival_times(jc, js))
    np.testing.assert_array_equal(teval.scene_cable_positions(ts),
                                  jeval.scene_cable_positions(js))
    np.testing.assert_array_equal(synthesize_scene(ts), jsynthesize_scene(js))


def test_default_eval_scene_matches_jax():
    for kw in ({}, {"nx": 48, "ns": 3000}):
        a, b = teval.default_eval_scene(**kw), jeval.default_eval_scene(**kw)
        assert (a.nx, a.ns, a.dx, a.noise_rms, a.seed) == (b.nx, b.ns, b.dx, b.noise_rms, b.seed)
        assert [asdict(c) for c in a.calls] == [asdict(c) for c in b.calls]


@pytest.mark.parametrize("case", ["perfect_plus_false", "empty", "restricted", "near_edge"])
def test_match_picks_matches_jax(case):
    extra = [dict(t0=6.0, x0_m=8.0, fmin=14.7, fmax=21.8, duration=0.78)]
    ts, js = _scenes(nx=8, extra=extra if case == "restricted" else ())
    on0 = np.round(jeval.arrival_times(js.calls[0], js) * js.fs).astype(int)
    kw = {}
    if case == "perfect_plus_false":
        picks = np.asarray([np.append(np.arange(8), 0), np.append(on0, 1900)])
    elif case == "empty":
        picks = np.zeros((2, 0), dtype=int)
    elif case == "restricted":
        on1 = np.round(jeval.arrival_times(js.calls[1], js) * js.fs).astype(int)
        picks = np.asarray([[3, 4], [on1[3], on0[4]]])
        kw = {"call_indices": [0]}
    else:   # picks exactly at, and just past, the tolerance
        tol = int(0.3 * js.fs)
        picks = np.asarray([[1, 2, 5], [on0[1] + tol, on0[2] - tol - 1, on0[5] + tol + 1]])
    got = teval.match_picks(picks, ts, **kw)
    assert isinstance(got, teval.PickMatch)
    _pm_equal(got, jeval.match_picks(picks, js, **kw))
    if case == "perfect_plus_false":
        assert got.recall == 1.0 and got.n_false == 1 and got.precision == pytest.approx(8 / 9)


def test_call_association_matches_jax():
    scene = teval.default_eval_scene()
    jscene = jeval.default_eval_scene()
    assert teval._call_groups(scene) == jeval._call_groups(jscene)
    from das4whales_tpu_torch.config import FIN_HF_NOTE, FIN_LF_NOTE
    from das4whales_tpu_torch.config import SPECTRO_HF_KERNEL as T_HF
    from das4whales_tpu_torch.config import SPECTRO_LF_KERNEL as T_LF

    for cfg, jcfg in ((T_HF, SPECTRO_HF_KERNEL), (T_LF, SPECTRO_LF_KERNEL),
                      (FIN_HF_NOTE, FIN_HF_NOTE), (FIN_LF_NOTE, FIN_LF_NOTE),
                      ({"f0": 27.0, "f1": 17.0, "dur": 0.7}, {"f0": 27.0, "f1": 17.0, "dur": 0.7})):
        assert teval._calls_for_template(cfg, scene) == jeval._calls_for_template(jcfg, jscene)
    assert teval._calls_for_template(FIN_HF_NOTE, SyntheticScene()) == []


def test_sharded_picks_to_dict_matches_jax():
    rng = np.random.default_rng(3)
    pos = rng.integers(0, 500, size=(2, 3, 6, 8)).astype(np.int32)
    sel = rng.random((2, 3, 6, 8)) < 0.4
    zeros = np.zeros_like(pos, np.float32)
    jsp = JSparse(pos, zeros, zeros, sel, np.zeros((2, 3, 6), bool))
    tsp = SparsePicks(*(torch.from_numpy(np.asarray(a)) for a in jsp))
    for fi, ns in ((0, None), (2, 300)):
        got = teval.sharded_picks_to_dict(tsp, ("HF", "LF"), fi, n_samples=ns)
        want = jeval.sharded_picks_to_dict(jsp, ("HF", "LF"), fi, n_samples=ns)
        assert set(got) == set(want)
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])


@pytest.fixture(scope="module")
def eval_pair():
    """The port's and JAX's matched filters on ``default_eval_scene(64,
    4000)`` (JAX's eval tests' scene)."""
    scene = teval.default_eval_scene(nx=64, ns=4000)
    jscene = jeval.default_eval_scene(nx=64, ns=4000)
    tdet = MatchedFilterDetector(scene.metadata, [0, 64, 1], (64, 4000), device="cpu")
    with jax.enable_x64(False):
        jdet = JMF(jscene.metadata, [0, 64, 1], (64, 4000))
    return scene, jscene, tdet, jdet


def _jax_call(fn, *args, **kw):
    with jax.enable_x64(False):
        return fn(*args, **kw)


def test_both_detectors_pick_the_same_on_the_scene(eval_pair):
    scene, jscene, tdet, jdet = eval_pair
    block = synthesize_scene(scene).astype(np.float32)
    tres = tdet(torch.from_numpy(block))
    jres = _jax_call(jdet, jnp.asarray(block))
    for name in ("HF", "LF"):
        np.testing.assert_array_equal(tres.picks[name], np.asarray(jres.picks[name]))
    for thr in (2.0, 20.0, 80.0):
        a = tdet(torch.from_numpy(block), threshold=thr)
        b = _jax_call(jdet, jnp.asarray(block), threshold=thr)
        for name in ("HF", "LF"):
            np.testing.assert_array_equal(a.picks[name], np.asarray(b.picks[name]))


def test_evaluate_detector_matches_jax(eval_pair):
    scene, jscene, tdet, jdet = eval_pair
    got = teval.evaluate_detector(tdet, scene)
    np.testing.assert_equal(got, _jax_call(jeval.evaluate_detector, jdet, jscene))
    assert set(got) == {"HF", "LF"} and got["HF"]["recall"] > 0.5


def test_amplitude_sweep_matches_jax(eval_pair):
    scene, jscene, tdet, jdet = eval_pair
    got = teval.amplitude_sweep(tdet, scene, [0.001, 1.0], seeds=(0, 1))
    np.testing.assert_equal(
        got, _jax_call(jeval.amplitude_sweep, jdet, jscene, [0.001, 1.0], seeds=(0, 1)))
    assert got[0]["snr_db"] < got[1]["snr_db"]
    assert got[0]["HF"]["recall"] < got[1]["HF"]["recall"]


def test_threshold_sweep_matches_jax(eval_pair):
    scene, jscene, tdet, jdet = eval_pair
    got = teval.threshold_sweep(tdet, scene, [2.0, 20.0, 80.0])
    np.testing.assert_equal(got, _jax_call(jeval.threshold_sweep, jdet, jscene, [2.0, 20.0, 80.0]))
    recalls = [r["HF"]["recall"] for r in got]
    assert recalls[0] >= recalls[1] >= recalls[2]


def test_evaluate_hands_the_block_to_the_detector_on_its_device(eval_pair):
    scene, _, _, _ = eval_pair
    seen = []

    class Probe:
        device = torch.device("cpu")
        template_configs = None

        def __call__(self, block, threshold=None):
            seen.append((block.dtype, block.device, tuple(block.shape)))
            return teval._EvalResult(picks={"X": np.zeros((2, 0), dtype=int)})

    assert teval.evaluate_detector(Probe(), scene)["X"]["n_picks"] == 0
    assert seen == [(torch.float32, torch.device("cpu"), (scene.nx, scene.ns))]


@pytest.fixture(scope="module")
def localize_pair():
    """``tests/test_detect_localize.py``'s off-cable source, detected by
    both packages."""
    call = dict(amplitude=2.0, **TRUTH)
    scene = SyntheticScene(nx=512, ns=4000, noise_rms=0.05, calls=[SyntheticCall(**call)])
    jscene = JScene(nx=512, ns=4000, noise_rms=0.05, calls=[JCall(**call)])
    block = synthesize_scene(scene).astype(np.float32)
    tdet = MatchedFilterDetector(scene.metadata, [0, 512, 1], (512, 4000), device="cpu")
    tpicks = tdet(torch.from_numpy(block)).picks["HF"]
    with jax.enable_x64(False):
        jdet = JMF(jscene.metadata, [0, 512, 1], (512, 4000))
        jpicks = np.asarray(jdet(jnp.asarray(block)).picks["HF"])
    return scene, jscene, tpicks, jpicks


def test_localize_scene_call_matches_jax_on_the_same_picks(localize_pair):
    scene, jscene, _, jpicks = localize_pair
    got = teval.localize_scene_call(jpicks, scene, device="cpu")
    with jax.enable_x64(True):
        want = jeval.localize_scene_call(jpicks, jscene)
        for g, w in zip(got, want):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-9,
                                       atol=1e-12 * float(np.nanmax(np.abs(w))))


def test_detect_then_localize_recovers_the_source(localize_pair):
    scene, _, tpicks, jpicks = localize_pair
    np.testing.assert_array_equal(tpicks, jpicks)
    assert len(set(tpicks[0].tolist())) > 0.9 * scene.nx
    lr = teval.localize_scene_call(tpicks, scene, device="cpu")
    x, y, z, t0 = lr.position.numpy()
    assert x == pytest.approx(TRUTH["x0_m"], abs=20.0)
    assert abs(y) == pytest.approx(abs(TRUTH["y0_m"]), abs=100.0)
    assert z == TRUTH["z0_m"]
    assert t0 == pytest.approx(TRUTH["t0"], abs=0.05)
    assert float(np.sqrt(np.nanmean(lr.residuals.numpy() ** 2))) < 0.02
    assert np.all(np.isfinite(lr.uncertainty.numpy()))
