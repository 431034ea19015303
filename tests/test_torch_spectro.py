"""Port parity, the spectrogram-correlation family: the design helpers,
the correlation ops, ``SpectroCorrDetector`` and the ``SpectroEvalAdapter``
chain of das4whales_tpu_torch (on the CPU) against das4whales_tpu
(float32, x64 off).

Both detectors run on one configuration (``convert.spectro_from_jax_config``).
Contract: the axes, the hat kernels and the widened band equal exactly;
correlation ops and correlograms to ``atol = 1e-5 * max|ref|`` (pocketfft
and XLA's FFT, a DFT product and an FFT, round differently);
``spectro_fs`` equal; picks equal, or every pick in the symmetric
difference on a rounding knife edge of the correlogram
(``utils.parity.unexplained_differences`` at the detector's threshold).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from das4whales_tpu.config import SPECTRO_HF_KERNEL, SPECTRO_LF_KERNEL, AcquisitionMetadata
from das4whales_tpu.io.synth import SyntheticCall, SyntheticScene, synthesize_scene
from das4whales_tpu.models import spectro as js
from das4whales_tpu.models import templates as jtpl
from das4whales_tpu.ops import xcorr as jxcorr
from das4whales_tpu.workflows import spectrodetect as jsd
from das4whales_tpu_torch import config as tcfg
from das4whales_tpu_torch import convert
from das4whales_tpu_torch.eval import SpectroEvalAdapter
from das4whales_tpu_torch.models import spectro as ts
from das4whales_tpu_torch.ops import xcorr as txcorr
from das4whales_tpu_torch.utils.parity import unexplained_differences
from das4whales_tpu_torch.workflows import spectrodetect as tsd
from tests.torch_threads import one_torch_thread  # noqa: F401

REL = 1e-5


def _j32(fn, *args, **kw):
    """Run a JAX function in float32 mode; return host numpy copies."""
    with jax.enable_x64(False):
        out = fn(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args], **kw)
        return jax.tree_util.tree_map(np.array, out)


def _assert_near(ref, got, rel=REL):
    ref, got = np.asarray(ref), np.asarray(got)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    scale = float(np.nanmax(np.abs(ref)))
    assert scale > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * scale)


def _assert_picks(jpicks, tpicks, corr, thr):
    total = 0
    for name in jpicks:
        a, b = np.asarray(jpicks[name]), np.asarray(tpicks[name])
        assert b.dtype == np.int64 and b.shape[0] == 2
        bad = unexplained_differences(a, b, corr[name], thr)
        assert not bad, f"{name}: picks differ beyond rounding at {bad[:10]}"
        total += b.shape[1]
    assert total > 0, "parity over an empty pick set proves nothing"


# ---------------------------------------------------------------- scenes

def _recall_scene():
    """``tests/test_spectro.py::test_spectrocorr_recall``'s block: one
    fin call on channel 17 of 24, 30 s at 200 Hz."""
    rng = np.random.default_rng(5)
    fs, ns, nx = 200.0, 6000, 24
    time = np.arange(ns) / fs
    call = np.asarray(jtpl.gen_template_fincall(time, fs, 17.0, 27.0, 0.8))
    data = 0.05 * rng.standard_normal((nx, ns))
    data[17, 2000:2160] += call[:160]
    return AcquisitionMetadata(fs=fs, dx=2.042, nx=nx, ns=ns), data.astype(np.float32)


def _synth_scene(nx, ns, seed):
    calls = [SyntheticCall(t0=2.0, x0_m=nx / 2 * 2.042, amplitude=1.0),
             SyntheticCall(t0=ns / 200.0 - 4.0, x0_m=nx / 4 * 2.042, amplitude=0.8,
                           fmin=14.7, fmax=21.8, duration=0.78)]
    scene = SyntheticScene(nx=nx, ns=ns, noise_rms=0.05, seed=seed, calls=calls)
    return scene.metadata, np.asarray(synthesize_scene(scene), np.float32)


@pytest.fixture(scope="module")
def scenes():
    return {"recall": _recall_scene(), "synth": _synth_scene(64, 3000, 3),
            "short": _synth_scene(24, 2000, 4)}


# ---------------------------------------------------------------- design

@pytest.mark.parametrize("n,win,overlap", [(6000, 0.8, 0.95), (3000, 0.8, 0.95),
                                           (1999, 0.5, 0.75), (12000, 0.8, 0.95)])
def test_shape_computed_axes_equal_the_jax_probe(n, win, overlap):
    fs = 200.0
    nperseg = int(win * fs)
    nhop = int(np.floor(nperseg * (1 - overlap)))
    x = np.random.default_rng(n).normal(size=(n,)).astype(np.float32)
    for kernel in (SPECTRO_HF_KERNEL, SPECTRO_LF_KERNEL):
        fmin, fmax = js.effective_band((14.0, 30.0), kernel)
        with jax.enable_x64(False):
            _, ff_j, tt_j = js.sliced_spectrogram(jnp.asarray(x), fs, fmin, fmax, nperseg, nhop)
        ff, tt = ts.spectro_axes(n, fs, nperseg, nhop)
        np.testing.assert_array_equal(ff[ts._band(ff, fmin, fmax)], ff_j)
        np.testing.assert_array_equal(tt, tt_j)
        tj = js.buildkernel(kernel["f0"], kernel["f1"], kernel["bdwidth"], kernel["dur"],
                            ff_j, tt_j, fs, fmin, fmax)
        tp = ts.buildkernel(kernel["f0"], kernel["f1"], kernel["bdwidth"], kernel["dur"],
                            ff[ts._band(ff, fmin, fmax)], tt, fs, fmin, fmax)
        for a, b in zip(tj, tp):
            np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("flims", [(14.0, 30.0), (25.0, 18.0), (20.0, 22.0), (0.0, 100.0)])
def test_effective_band_equals_jax(flims):
    for kernel in (SPECTRO_HF_KERNEL, SPECTRO_LF_KERNEL):
        assert ts.effective_band(flims, kernel) == js.effective_band(flims, kernel)
    assert tcfg.SPECTRO_HF_KERNEL == SPECTRO_HF_KERNEL
    assert tcfg.SPECTRO_LF_KERNEL == SPECTRO_LF_KERNEL


def test_buildkernel_from_template_matches():
    with jax.enable_x64(False):
        ref = js.buildkernel_from_template(17.0, 27.0, 0.8, 200.0, 64, 16)
    got = ts.buildkernel_from_template(17.0, 27.0, 0.8, 200.0, 64, 16, device="cpu")
    _assert_near(ref, got)


# ---------------------------------------------------------------- ops

@pytest.mark.parametrize("shape", [(3, 3, 67), (3, 4, 50)])     # odd and even counts
def test_median_midpoint_is_numpys(shape):
    x = np.random.default_rng(shape[-1]).normal(size=shape).astype(np.float32)
    got = ts.median_midpoint(torch.from_numpy(x), 2).numpy()
    np.testing.assert_array_equal(got, np.median(x, axis=(-2, -1)).astype(np.float32))


def test_xcorr2d_matches_with_an_even_count_median():
    # 13 x 50 = 650 samples per signal: the median is the midpoint of two
    # order statistics, which torch.median (the lower one) gets wrong
    rng = np.random.default_rng(11)
    spec = np.abs(rng.normal(size=(5, 13, 50))).astype(np.float32)
    ker = rng.normal(size=(13, 9)).astype(np.float32)
    ref = _j32(js.xcorr2d, spec, ker)
    got = ts.xcorr2d(torch.from_numpy(spec), torch.from_numpy(ker)).numpy()
    _assert_near(ref, got)
    lower = torch.from_numpy(spec).reshape(5, -1).median(dim=-1).values
    assert not torch.equal(lower, ts.median_midpoint(torch.from_numpy(spec), 2))


def test_nxcorr2d_matches_with_per_channel_population_std():
    rng = np.random.default_rng(12)
    spec = np.abs(rng.normal(size=(4, 13, 60))).astype(np.float32)
    spec[1] *= 7.0                       # channels of different spread
    ker = rng.normal(size=(5, 8)).astype(np.float32)
    _assert_near(_j32(js.nxcorr2d, spec, ker),
                 ts.nxcorr2d(torch.from_numpy(spec), torch.from_numpy(ker)).numpy())


def test_xcorr_sliding_matches():
    rng = np.random.default_rng(13)
    Sxx = np.abs(rng.normal(size=(16, 120))).astype(np.float32)
    ker = rng.normal(size=(11, 10)).astype(np.float32)
    t = np.linspace(0.0, 12.0, 120)
    with jax.enable_x64(False):
        ts_j, vals_j = js.xcorr_sliding(t, None, Sxx, None, None, ker)
        vals_j = np.array(vals_j)
    ts_t, vals_t = ts.xcorr_sliding(t, None, torch.from_numpy(Sxx), None, None, ker)
    np.testing.assert_array_equal(ts_t, ts_j)
    _assert_near(vals_j, vals_t.numpy())


@pytest.mark.parametrize("m", [1, 20, 31])
def test_fftconvolve_same_time_matches(m):
    rng = np.random.default_rng(m)
    x = rng.normal(size=(3, 13, 200)).astype(np.float32)
    k = rng.normal(size=(13, m)).astype(np.float32)
    _assert_near(_j32(jxcorr.fftconvolve_same_time, x, k),
                 txcorr.fftconvolve_same_time(torch.from_numpy(x), torch.from_numpy(k)).numpy())


@pytest.mark.parametrize("m1,m2", [(3, 5), (4, 6), (13, 20)])
def test_fftconvolve2d_same_matches(m1, m2):
    rng = np.random.default_rng(m1 * m2)
    x = rng.normal(size=(2, 13, 90)).astype(np.float32)
    k = rng.normal(size=(m1, m2)).astype(np.float32)
    _assert_near(_j32(jxcorr.fftconvolve2d_same, x, k),
                 txcorr.fftconvolve2d_same(torch.from_numpy(x), torch.from_numpy(k)).numpy())


# ---------------------------------------------------------------- family

def _detectors(meta, jax_engine, port_engine, **kw):
    with jax.enable_x64(False):
        jd = js.SpectroCorrDetector(meta, stft_engine=jax_engine, **kw)
    td = convert.spectro_from_jax_config({f: getattr(jd, f) for f in convert.SPECTRO_FIELDS},
                                         meta, stft_engine=port_engine, device="cpu")
    return jd, td


@pytest.mark.parametrize("scene,jax_engine,port_engine,kw", [
    ("recall", "rfft", "rfft", {"threshold": 2.0}),
    ("synth", "rfft", "rfft", {"batch_channels": 24}),
    ("synth", "rfft", "rfft", {"threshold": 3.0}),
    ("short", "pallas", "fused", {"threshold": 3.0}),
])
def test_detector_matches_jax(scenes, scene, jax_engine, port_engine, kw):
    meta, x = scenes[scene]
    jd, td = _detectors(meta, jax_engine, port_engine, **kw)
    with jax.enable_x64(False):
        jc, jp, jfs = jd(jnp.asarray(x))
        jc = {k: np.array(v) for k, v in jc.items()}
        jp = {k: np.array(v) for k, v in jp.items()}
    tc, tp, tfs = td(torch.from_numpy(x))
    assert td.stft_engine == port_engine
    assert tfs == jfs
    assert list(tc) == list(jc) == ["HF", "LF"]
    for name in jc:
        _assert_near(jc[name], tc[name].numpy())
    _assert_picks(jp, tp, {k: v.numpy() for k, v in tc.items()}, td.threshold)
    # a saturation check and a packed fetch per hat kernel
    assert td.syncs == 4 and td.escalations == 0


def test_k0_saturation_escalates_like_jax():
    """Correlograms with far more than K0 = 64 candidates a row: both
    packages rerun at K = 256; fed the same correlograms, the picks are
    the same, bit for bit."""
    rng = np.random.default_rng(21)
    corr = {"HF": np.abs(rng.normal(size=(6, 751))).astype(np.float32),
            "LF": np.abs(rng.normal(size=(6, 751))).astype(np.float32)}
    meta = AcquisitionMetadata(fs=200.0, dx=2.042, nx=6, ns=6000)
    jd, td = _detectors(meta, "rfft", "rfft", threshold=0.05)
    with jax.enable_x64(False):
        jp, jfs = jd.picks_from_correlograms({k: jnp.asarray(v) for k, v in corr.items()})
        jp = {k: np.array(v) for k, v in jp.items()}
    with pytest.warns(UserWarning, match="saturated"):
        tp, tfs = td.picks_from_correlograms({k: torch.from_numpy(v) for k, v in corr.items()})
    assert tfs == jfs
    assert td.escalations == 2
    # per kernel: the K0 check, the saturated count of the K = 256 rerun,
    # the packed fetch
    assert td.syncs == 6
    for name in corr:
        np.testing.assert_array_equal(tp[name], jp[name])
        assert tp[name].shape[1] > 64


def test_engine_resolution():
    meta = tcfg.AcquisitionMetadata(fs=200.0, dx=2.042, nx=4, ns=2000)
    det = ts.SpectroCorrDetector(meta, device="cpu")
    assert det.stft_engine == "fused"
    # "auto" runs the A/B router: the rFFT route off a CUDA device
    auto = ts.SpectroCorrDetector(meta, stft_engine="auto", device="cpu")
    assert auto.stft_engine == "rfft" and "no MXU" in auto.stft_engine_reason
    assert ts.SpectroCorrDetector(meta, stft_engine="matmul", device="cpu").stft_engine == "matmul"
    with pytest.raises(ValueError, match="unknown stft engine"):
        ts.SpectroCorrDetector(meta, stft_engine="nope", device="cpu")
    # "auto" is the detector's word (ops.mxu.resolve_stft_engine_ab); the
    # correlogram function takes the resolved engine only
    with pytest.raises(ValueError, match="unknown stft engine"):
        ts.compute_cross_correlogram_spectrocorr(torch.zeros((2, 2000)), 200.0, (14.0, 30.0),
                                                 tcfg.SPECTRO_HF_KERNEL, 0.8, 0.95,
                                                 stft_engine="auto")
    with pytest.raises(KeyError, match="spectro fields missing"):
        convert.spectro_from_jax_config({"flims": (14.0, 30.0)}, meta, device="cpu")


# ---------------------------------------------------------------- adapter

@pytest.fixture(scope="module")
def adapter_block():
    nx, ns = 32, 2400
    scene = SyntheticScene(nx=nx, ns=ns, noise_rms=0.05, seed=6, calls=[
        SyntheticCall(t0=3.0, x0_m=16 * 2.042, amplitude=1.0),
        SyntheticCall(t0=6.5, x0_m=8 * 2.042, amplitude=0.8, fmin=14.7, fmax=21.8,
                      duration=0.78)])
    return scene.metadata, np.asarray(synthesize_scene(scene), np.float32)


@pytest.mark.parametrize("fused", [True, False])
def test_adapter_chain_matches_jax(adapter_block, fused):
    meta, x = adapter_block
    shape = x.shape
    with jax.enable_x64(False):
        jad = jsd.campaign_detector(meta, [0, shape[0], 1], shape, fused_bandpass=fused,
                                    threshold=4.0, stft_engine="rfft")
        jres = jad(x)
        jsweep = jad(x, threshold=6.0)
    tad = tsd.campaign_detector(meta, [0, shape[0], 1], shape, fused_bandpass=fused,
                                threshold=4.0, stft_engine="rfft", device="cpu")
    assert isinstance(tad, SpectroEvalAdapter) and tad.prefilter.fused_bandpass is fused
    assert tad.template_configs == dict(jad.template_configs)
    tres = tad(x)
    tsweep = tad(x, threshold=6.0)
    assert tad.det.threshold == 4.0                   # the sweep restores it
    assert tres.thresholds == jres.thresholds and tsweep.thresholds == jsweep.thresholds
    corr = {k: v.numpy() for k, v in tad.det.correlograms(tad.prefilter.filter_block(x)).items()}
    spectro_fs = corr["HF"].shape[-1] / (meta.ns / meta.fs)

    def frames(picks):   # sample units back to correlogram frames
        return {k: np.asarray([p[0], np.round(p[1] * spectro_fs / meta.fs)]).astype(np.int64)
                for k, p in picks.items()}

    for thr, jr, tr in ((4.0, jres, tres), (6.0, jsweep, tsweep)):
        for name, p in tr.picks.items():
            # sample units: the frame times the samples per frame, rounded
            assert p.dtype == np.int64
            np.testing.assert_array_equal(
                p[1], np.round(frames(tr.picks)[name][1] * (meta.fs / spectro_fs)))
        _assert_picks(frames(jr.picks), frames(tr.picks), corr, thr)
    assert sum(p.shape[1] for p in tsweep.picks.values()) <= sum(
        p.shape[1] for p in tres.picks.values())
