"""Port parity, the data-health stats: ``ops.health`` of
das4whales_tpu_torch (torch on the CPU, and numpy on the host path)
against das4whales_tpu's (float32, x64 off), on seeded blocks holding
NaN, +-inf, clipped samples, a dead channel and an ``n_real`` pad; the
quarantine gate ``DataHealthConfig.breach``; and
``detect_picks(with_health=True)`` against JAX's. Contract: counts
exact, rms within rtol 1e-6 (float32 sums in another order).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from das4whales_tpu import config as jcfg
from das4whales_tpu.io.synth import SyntheticCall, SyntheticScene, synthesize_scene, to_raw_counts
from das4whales_tpu.models.matched_filter import MatchedFilterDetector as JaxDetector
from das4whales_tpu.ops import health as jh
from das4whales_tpu_torch import convert
from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector
from das4whales_tpu_torch.ops import health as th
from das4whales_tpu_torch.utils.parity import envelopes, unexplained_differences
from tests.torch_threads import one_torch_thread  # noqa: F401


def _block(shape, seed=0):
    """A float32 block with NaN, +inf, -inf, clipped samples and an
    all-zero channel."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x[..., 1, 5] = np.nan
    x[..., 2, 7] = np.inf
    x[..., 3, shape[-1] - 1] = -np.inf      # in the pad when n_real < T
    x[..., 4, :] = 0.0
    x[..., 5, 3] = 5.0
    x[..., 6, shape[-1] - 2] = -7.0         # clipped, in the pad
    return x


def _jax(fn, *args, **kw):
    with jax.enable_x64(False):
        return [np.array(v) for v in fn(*args, **kw)]


CASES = [((37, 100), None), ((37, 100), 90), ((3, 37, 100), None), ((3, 37, 100), 90)]


@pytest.mark.parametrize("shape,n_real", CASES)
@pytest.mark.parametrize("clip", [2.0, float("inf")])
@pytest.mark.parametrize("n_bins", [None, 8])
def test_stats_and_profile_match_jax(shape, n_real, clip, n_bins):
    x = _block(shape)
    want = _jax(jh.health_stats_profiled, x, clip, n_real=n_real, n_bins=n_bins)
    got = [v.numpy() for v in th.health_stats_profiled(torch.from_numpy(x), clip,
                                                       n_real=n_real, n_bins=n_bins)]
    for w, g, kind in zip(want, got, ("counts", "rms", "bin_counts", "bin_rms")):
        assert g.shape == w.shape, kind
        if kind.endswith("counts"):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, w)
        else:
            assert g.dtype == np.float32
            np.testing.assert_allclose(g, w, rtol=1e-6)
    assert got[0][..., 0].min() >= (1 if n_real is None else 0) + 2


@pytest.mark.parametrize("shape,n_real", CASES)
@pytest.mark.parametrize("clip", [2.0, float("inf")])
def test_scalar_stats_match_jax(shape, n_real, clip):
    x = _block(shape)
    want = _jax(jh.health_stats, x, clip, n_real=n_real)
    got = [v.numpy() for v in th.health_stats(torch.from_numpy(x), clip, n_real=n_real)]
    assert got[0].dtype == np.int32 and got[1].dtype == np.float32
    assert got[0].shape == want[0].shape and got[1].shape == want[1].shape
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)


@pytest.mark.parametrize("n_real", [[90, 100, 50], np.asarray([90, 100, 50])])
def test_scalar_stats_per_record_lengths_match_jax(n_real):
    x = _block((3, 37, 100), seed=1)
    counts, rms = (v.numpy() for v in th.health_stats(torch.from_numpy(x), 2.0, n_real=n_real))
    assert counts.shape == (3, 2) and rms.shape == (3,)
    for b, nr in enumerate(n_real):
        want = _jax(jh.health_stats, x[b], 2.0, n_real=int(nr))
        np.testing.assert_array_equal(counts[b], want[0])
        np.testing.assert_allclose(rms[b], want[1], rtol=1e-6)


def test_per_record_lengths_match_jax_record_by_record():
    x = _block((3, 37, 100), seed=1)
    n_real = [90, 100, 50]
    got = [v.numpy() for v in th.health_stats_profiled(torch.from_numpy(x), 2.0, n_real=n_real)]
    for b, nr in enumerate(n_real):
        want = _jax(jh.health_stats_profiled, x[b], 2.0, n_real=nr)
        for w, g in zip(want, got):
            np.testing.assert_allclose(g[b], w, rtol=1e-6)
            if g.dtype == np.int32:
                np.testing.assert_array_equal(g[b], w)


def test_integer_counts_on_the_raw_wire_match_jax():
    rng = np.random.default_rng(2)
    raw = rng.integers(-3000, 3000, size=(40, 64)).astype(np.int32)
    raw[7] = 0
    want = _jax(jh.health_stats_profiled, raw, 2500.0, n_real=60)
    got = [v.numpy() for v in th.health_stats_profiled(torch.from_numpy(raw), 2500.0, n_real=60)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-6)


@pytest.mark.parametrize("n_channels,n_bins", [(0, None), (1, None), (37, 8), (22050, None),
                                               (22050, 256), (100, 1000)])
def test_channel_bins_match_jax(n_channels, n_bins):
    assert th.channel_bins(n_channels, n_bins) == jh.channel_bins(n_channels, n_bins)


def test_stats_to_dict_matches_jax():
    x = _block((37, 100))
    counts, rms, binc, binr = _jax(jh.health_stats_profiled, x, 2.0, n_real=90, n_bins=8)
    args = (counts, rms, 37 * 90)
    kw = dict(bin_counts=binc, bin_rms=binr, n_channels=37)
    want, got = jh.stats_to_dict(*args, **kw), th.stats_to_dict(*args, **kw)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    want, got = jh.stats_to_dict(counts, rms, 0), th.stats_to_dict(counts, rms, 0)
    assert list(got) == list(want) and np.isnan(got["rms"]) and np.isnan(want["rms"])
    assert {k: v for k, v in got.items() if k != "rms"} == {
        k: v for k, v in want.items() if k != "rms"}


@pytest.mark.parametrize("shape", [(37, 100), (0, 0), (100,)])
@pytest.mark.parametrize("clip", [None, 2.0])
def test_host_stats_match_jax(shape, clip):
    x = _block(shape) if len(shape) == 2 and shape[0] else np.zeros(shape, np.float32)
    want, got = jh.host_health_stats(x, clip), th.host_health_stats(x, clip)
    assert list(got) == list(want)
    for k in want:
        w, g = want[k], got[k]
        if isinstance(w, list):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        else:
            assert g == w or (g != g and w != w), k


CONFIGS = [
    jcfg.DataHealthConfig(),
    jcfg.DataHealthConfig(max_nonfinite=5),
    jcfg.DataHealthConfig(max_nonfinite=10, clip_abs=2.0, max_clip_frac=1e-4),
    jcfg.DataHealthConfig(max_nonfinite=10, max_rms=0.5),
    jcfg.DataHealthConfig(max_nonfinite=10, min_rms=2.0),
    jcfg.DataHealthConfig(max_nonfinite=10, clip_abs=3.0, max_rms=10.0, min_rms=0.1),
]


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: repr(c)[17:80])
@pytest.mark.parametrize("poison", [True, False])
def test_breach_matches_jax(cfg, poison):
    x = _block((37, 100)) if poison else np.random.default_rng(3).standard_normal(
        (37, 100)).astype(np.float32)
    stats = jh.host_health_stats(x, cfg.clip_abs)
    port_cfg = convert.health_config_from_fields({f: getattr(cfg, f)
                                                  for f in convert.HEALTH_FIELDS})
    assert port_cfg.breach(stats) == cfg.breach(stats)
    assert port_cfg.breach(th.host_health_stats(x, cfg.clip_abs)) == cfg.breach(stats)


def test_as_health_config_matches_jax():
    from das4whales_tpu_torch.config import DataHealthConfig, as_health_config

    assert as_health_config(None) == DataHealthConfig() and as_health_config(True) == DataHealthConfig()
    assert as_health_config(False) is None
    cfg = DataHealthConfig(clip_abs=3.0)
    assert as_health_config(cfg) is cfg
    with pytest.raises(TypeError):
        as_health_config("yes")


# --- the fused stats in detect_picks ---------------------------------------

NX, NS, N_REAL = 24, 1024, 900


@pytest.fixture(scope="module")
def padded_scene():
    scene = SyntheticScene(nx=NX, ns=NS, noise_rms=0.05, seed=11,
                           calls=[SyntheticCall(t0=1.2, x0_m=12 * 2.042, amplitude=2.0)])
    raw = to_raw_counts(synthesize_scene(scene), scene.metadata)
    raw[:, N_REAL:] = 0
    real = raw[:, :N_REAL].astype(np.float64)
    cond = np.zeros(raw.shape, np.float32)
    cond[:, :N_REAL] = (real - real.mean(axis=1, keepdims=True)) * scene.metadata.scale_factor
    return scene.metadata, {"raw": raw, "conditioned": cond}


@pytest.mark.parametrize("wire,clip,n_real", [
    ("raw", 1500.0, N_REAL), ("raw", None, None), ("conditioned", 3e-10, N_REAL),
    ("conditioned", None, N_REAL),
])
def test_detect_picks_with_health_matches_jax(padded_scene, wire, clip, n_real):
    meta, blocks = padded_scene
    x = blocks[wire]
    with jax.enable_x64(False):
        jd = JaxDetector(meta, [0, NX, 1], (NX, NS), wire=wire, pick_mode="sparse",
                         keep_correlograms=False, mf_engine="fft", fk_engine="fft")
        jr = jd.detect_picks(x, n_real=n_real, with_health=True, health_clip=clip)
    design = convert.design_from_arrays({f: getattr(jd.design, f) for f in convert.DESIGN_FIELDS})
    td = MatchedFilterDetector.from_design(design, meta, wire=wire, device="cpu")
    tr = td.detect_picks(x, n_real=n_real, with_health=True, health_clip=clip)
    assert td.syncs == td.dispatches == 1       # the stats ride the one packed read
    assert list(tr.health) == list(jr.health)
    for k, w in jr.health.items():
        if k in ("rms", "bin_rms"):
            np.testing.assert_allclose(tr.health[k], w, rtol=1e-6)
        else:
            assert tr.health[k] == w, k
    assert tr.health["n_samples"] == NX * (n_real or NS)
    if clip is not None:
        assert tr.health["clipped"] > 0
    env = None
    for i, name in enumerate(jr.picks):
        np.testing.assert_allclose(tr.thresholds[name], jr.thresholds[name], rtol=1e-5)
        a = np.asarray(jr.picks[name])
        if not np.array_equal(a, tr.picks[name]):
            if env is None:
                cd = MatchedFilterDetector.from_design(design, meta, wire="conditioned",
                                                       device="cpu")
                env = envelopes(cd, blocks["conditioned"] if n_real else _cond(x, meta, wire))
            bad = unexplained_differences(a, tr.picks[name], env[i], tr.thresholds[name])
            assert not bad, f"{name}: picks differ beyond rounding at {bad[:10]}"


def _cond(x, meta, wire):
    if wire != "raw":
        return x
    r = x.astype(np.float64)
    return ((r - r.mean(axis=1, keepdims=True)) * meta.scale_factor).astype(np.float32)


def test_health_off_leaves_the_packed_read_as_it_was(padded_scene):
    meta, blocks = padded_scene
    det = MatchedFilterDetector(meta, [0, NX, 1], (NX, NS), wire="raw", device="cpu")
    plain = det.detect_picks(blocks["raw"], n_real=N_REAL)
    with_h = det.detect_picks(blocks["raw"], n_real=N_REAL, with_health=True)
    assert plain.health == {} and with_h.health["nonfinite"] == 0
    for name in plain.picks:
        np.testing.assert_array_equal(plain.picks[name], with_h.picks[name])
        assert plain.thresholds[name] == with_h.thresholds[name]


def test_capacity_overflow_keeps_the_attempts_health(padded_scene):
    meta, blocks = padded_scene
    roomy = MatchedFilterDetector(meta, [0, NX, 1], (NX, NS), wire="raw", device="cpu")
    tight = MatchedFilterDetector.from_design(roomy.design, meta, wire="raw", pick_pack_cap=2,
                                              device="cpu")
    a = roomy.detect_picks(blocks["raw"], n_real=N_REAL, with_health=True, health_clip=1500.0)
    b = tight.detect_picks(blocks["raw"], n_real=N_REAL, with_health=True, health_clip=1500.0)
    assert tight.syncs == tight.dispatches + 1         # the full transfer
    assert a.health == b.health
    for name in a.picks:
        np.testing.assert_array_equal(a.picks[name], b.picks[name])
