"""Port parity, the staged bandpass and the prefilter: ``odd_ext``, the FFT
zero-phase apply, ``mf_filter_only``, ``MatchedFilterDetector.filter_block``
in both bandpass modes and ``detect_picks`` with ``fused_bandpass=False``,
das4whales_tpu_torch (on the CPU) against das4whales_tpu (float32, x64 off).

Tolerances: filter outputs ``atol = 1e-5 * max|ref|`` (pocketfft and XLA's
FFT round differently); picks under PR 1's contract — thresholds to rtol
1e-5, pick sets equal or differing only on rounding knife edges.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from das4whales_tpu import config as jcfg
from das4whales_tpu.io.synth import SyntheticCall, SyntheticScene, synthesize_scene, to_raw_counts
from das4whales_tpu.models import matched_filter as jmf
from das4whales_tpu.ops import filters as jfilt
from das4whales_tpu_torch import config as tcfg
from das4whales_tpu_torch import convert
from das4whales_tpu_torch.models import matched_filter as tmf
from das4whales_tpu_torch.ops import filters as tfilt
from das4whales_tpu_torch.ops import peaks as tpeaks
from das4whales_tpu_torch.utils.parity import envelopes, unexplained_differences
from das4whales_tpu_torch.workflows.common import mf_prefilter
from das4whales_tpu_torch.workflows.spectrodetect import campaign_detector

REL = 1e-5


def _assert_near(ref, got, rel=REL):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    scale = float(np.abs(ref).max())
    assert scale > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * scale)


def _scene(nx, ns, seed):
    calls = [SyntheticCall(t0=1.2, x0_m=nx / 2 * 2.042, amplitude=2.0),
             SyntheticCall(t0=8.0, x0_m=nx / 4 * 2.042, amplitude=1.5,
                           fmin=14.7, fmax=21.8, duration=0.78)]
    scene = SyntheticScene(nx=nx, ns=ns, noise_rms=0.05, seed=seed,
                           calls=[c for c in calls if c.t0 + 1.0 < ns / 200.0])
    raw = to_raw_counts(synthesize_scene(scene), scene.metadata)
    cond = ((raw - raw.mean(axis=1, keepdims=True)) * scene.metadata.scale_factor).astype(np.float32)
    return scene, {"raw": raw, "conditioned": cond}


@pytest.fixture(scope="module")
def scenes():
    return {"small": _scene(24, 900, 0), "med": _scene(48, 2400, 1)}


def _jax_detector(scene, wire, fused, **kw):
    with jax.enable_x64(False):
        return jmf.MatchedFilterDetector(
            scene.metadata, [0, scene.nx, 1], (scene.nx, scene.ns), wire=wire,
            fused_bandpass=fused, pick_mode="sparse", keep_correlograms=False,
            mf_engine="fft", fk_engine="fft", **kw)


def _torch_detector(jd, scene, wire, fused, **kw):
    design = convert.design_from_arrays({f: getattr(jd.design, f) for f in convert.DESIGN_FIELDS})
    return tmf.MatchedFilterDetector.from_design(design, scene.metadata, wire=wire,
                                                 fused_bandpass=fused, device="cpu", **kw)


@pytest.mark.parametrize("n,pad", [(100, 21), (64, 63), (500, 1)])
def test_odd_ext_matches(n, pad):
    x = np.random.default_rng(n).normal(size=(3, n)).astype(np.float32)
    with jax.enable_x64(False):
        ref = np.array(jfilt._odd_ext(jnp.asarray(x), pad))
    got = tfilt.odd_ext(torch.from_numpy(x), pad).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("padlen", [0, 51])
def test_fft_zero_phase_apply_matches(padlen):
    x = np.random.default_rng(3).normal(size=(6, 777)).astype(np.float32)
    gain = tfilt.butter_zero_phase_gain(777 + 2 * padlen, 200.0, (14.0, 30.0))
    with jax.enable_x64(False):
        ref = np.array(jfilt._fft_zero_phase_jit(jnp.asarray(x), jnp.asarray(gain), padlen))
    got = tfilt.fft_zero_phase_apply(torch.from_numpy(x), torch.from_numpy(gain), padlen)
    assert got.dtype == torch.float32
    _assert_near(ref, got.numpy())


def test_mf_filter_only_matches(scenes):
    scene, blocks = scenes["med"]
    jd = _jax_detector(scene, "conditioned", False)
    x = blocks["conditioned"]
    with jax.enable_x64(False):
        ref = np.array(jmf.mf_filter_only(
            jnp.asarray(x), jd._mask_band_dev, jd._gain_dev, jd._band_lo, jd._band_hi,
            jd.design.bp_padlen))
    td = _torch_detector(jd, scene, "conditioned", False)
    np.testing.assert_array_equal(td._mask_band.numpy(), np.array(jd._mask_band_dev))
    got = tmf.mf_filter_only(torch.from_numpy(x), td._mask_band, td._bp_gain, td._band_lo,
                             td._band_hi, td.design.bp_padlen)
    _assert_near(ref, got.numpy())


@pytest.mark.parametrize("wire", ["raw", "conditioned"])
@pytest.mark.parametrize("fused", [True, False])
def test_filter_block_matches(scenes, wire, fused):
    scene, blocks = scenes["small"]
    jd = _jax_detector(scene, wire, fused)
    with jax.enable_x64(False):
        ref = np.array(jd.filter_block(blocks[wire]))
    td = _torch_detector(jd, scene, wire, fused)
    assert td.fused_bandpass is fused
    got = td.filter_block(blocks[wire])
    assert got.dtype == torch.float32
    _assert_near(ref, got.numpy())


@pytest.mark.parametrize("size,wire,tile", [
    ("small", "raw", None), ("small", "conditioned", 16), ("med", "raw", 16),
])
def test_detect_picks_staged_bandpass_matches_jax(scenes, size, wire, tile):
    scene, blocks = scenes[size]
    jd = _jax_detector(scene, wire, False, channel_tile=tile)
    with jax.enable_x64(False):
        jr = jd.detect_picks(blocks[wire])
    td = _torch_detector(jd, scene, wire, False, channel_tile=tile)
    tr = td.detect_picks(blocks[wire])
    assert td.syncs == td.dispatches == 1
    env = envelopes(td, blocks[wire])
    total = 0
    for i, name in enumerate(jr.picks):
        np.testing.assert_allclose(tr.thresholds[name], jr.thresholds[name], rtol=1e-5)
        a, b = np.asarray(jr.picks[name]), tr.picks[name]
        bad = unexplained_differences(a, b, env[i], tr.thresholds[name])
        assert not bad, f"{name}: picks differ beyond rounding at {bad[:10]}"
        total += b.shape[1]
    assert total > 0, "parity over an empty pick set proves nothing"


def test_envelopes_follow_the_detectors_bandpass_mode(scenes):
    """``parity.envelopes`` runs the detector's own filter: a staged
    detector's picks are exactly the plain pick chain on its envelopes
    (untiled, so the same arithmetic), and those envelopes are not the
    fused detector's."""
    scene, blocks = scenes["med"]
    x = blocks["raw"]
    staged = tmf.MatchedFilterDetector(scene.metadata, [0, scene.nx, 1], (scene.nx, scene.ns),
                                       wire="raw", fused_bandpass=False, channel_tile=None,
                                       device="cpu")
    fused = tmf.MatchedFilterDetector.from_design(staged.design, scene.metadata, wire="raw",
                                                  channel_tile=None, device="cpu")
    res = staged.detect_picks(x)
    env = envelopes(staged, x)
    assert np.abs(env - envelopes(fused, x)).max() > 1e-3 * np.abs(env).max()
    for i, name in enumerate(res.picks):
        sp = tpeaks.find_peaks_sparse(torch.from_numpy(env[i]), res.thresholds[name],
                                      max_peaks=staged.pick_k0, method="pack")
        assert not bool(sp.saturated.any())
        want = tpeaks.sparse_to_pick_times(sp.positions.numpy(), sp.selected.numpy())
        np.testing.assert_array_equal(res.picks[name], want)
        assert want.shape[1] > 0


def test_prefilter_from_a_carried_design_equals_campaign_detectors(scenes):
    """The chip run's spectro prefilter, ``from_design`` on the matched
    filter's own design (raw wire, fin bank), equals the prefilter
    ``campaign_detector`` designs itself, bit for bit."""
    scene, blocks = scenes["small"]
    shape = (scene.nx, scene.ns)
    mf = tmf.MatchedFilterDetector(scene.metadata, [0, scene.nx, 1], shape, wire="raw",
                                   templates="fin", device="cpu")
    pre = tmf.MatchedFilterDetector.from_design(mf.design, scene.metadata, wire="conditioned",
                                                device="cpu")
    ad = campaign_detector(scene.metadata, [0, scene.nx, 1], shape, device="cpu")
    x = blocks["conditioned"]
    assert torch.equal(pre.filter_block(x), ad.prefilter.filter_block(x))


def test_mf_prefilter_derives_the_shape_from_metadata():
    meta = tcfg.AcquisitionMetadata(fs=200.0, dx=2.042, nx=50, ns=600)
    pre = mf_prefilter(meta, [4, 50, 2], device="cpu", fused_bandpass=False)
    assert pre.design.trace_shape == (23, 600) and not pre.fused_bandpass
    jsel = jcfg.ChannelSelection(4, 50, 2)
    tsel = tcfg.ChannelSelection(4, 50, 2)
    for nx in (None, 10, 49, 50, 200):
        assert tsel.n_channels(nx) == jsel.n_channels(nx)
    jmeta = jcfg.AcquisitionMetadata(fs=200.0, dx=2.042, nx=50, ns=600)
    assert tcfg.as_metadata(jmeta.with_shape(7, 300)) == meta.with_shape(7, 300)
