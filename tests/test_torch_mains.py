"""Port parity, the workflow mains this slice adds or completes:
``fkcomp``, ``plots`` and ``bathynoise``, and the figure branches of
``mfdetect``, ``spectrodetect`` and ``gabordetect`` — das4whales_tpu_torch
(``device="cpu"``) against das4whales_tpu (float32, x64 off) on JAX's
``small_scene`` (tests/test_workflows.py: 96 x 3000, dx 12 m, two calls),
written once as an OptaSense HDF5 file.

Contract: filtered blocks within ``REL * max|ref|``; SNR matrices within
``SNR_DB`` dB where they lie within 60 dB of their max; spectrograms
(dB re their max) within ``SNR_DB`` where within 60 dB of the max, their
axes bitwise; the best channel equal; the compression reports equal; the
noise statistics (mean, std, the window's envelope mean) within ``REL``
relative; the envelope median within the largest difference of the two
packages' envelopes on its row (an order statistic moves no more than
the samples do, and keeps one sample's FFT rounding, which scales with
the row's max, where a mean averages it away; the midpoint rule itself
is held bitwise on equal inputs); ``snr_1d`` and the noise power within
``SNR_1D_DB`` dB,
the depth join within 1e-12 (pandas' parse of the CSV is not correctly
rounded, the port's is); the WAV bitwise ``export_audio`` of either
package on the port's own best channel, and within the PCM step that
``REL`` allows of JAX's WAV; the figure files the same names, each
non-empty; picks up to rounding knife edges (``utils.parity``).
"""

from __future__ import annotations

import os

import matplotlib
from tests.torch_threads import one_torch_thread  # noqa: F401

matplotlib.use("Agg")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from das4whales_tpu import workflows as jwf  # noqa: E402
from das4whales_tpu.io import synth as jsynth  # noqa: E402
from das4whales_tpu.utils import audio as jaudio  # noqa: E402
from das4whales_tpu_torch.ops import spectral  # noqa: E402
from das4whales_tpu_torch.utils import audio as taudio  # noqa: E402
from das4whales_tpu_torch.utils.parity import unexplained_differences  # noqa: E402
from das4whales_tpu_torch.workflows import (  # noqa: E402
    bathynoise, fkcomp, gabordetect, mfdetect, plots, spectrodetect)

REL = 1e-5
SNR_DB = 0.01
SNR_1D_DB = 1e-3


def _small_scene():
    calls = [
        jsynth.SyntheticCall(t0=4.0, x0_m=400.0, fmin=17.8, fmax=28.8, duration=0.68,
                             amplitude=6.0),
        jsynth.SyntheticCall(t0=10.0, x0_m=900.0, fmin=14.7, fmax=21.8, duration=0.78,
                             amplitude=6.0),
    ]
    return jsynth.SyntheticScene(nx=96, ns=3000, dx=12.0, calls=calls, seed=3)


@pytest.fixture(scope="module")
def scene_file(tmp_path_factory):
    scene = _small_scene()
    path = str(tmp_path_factory.mktemp("scene") / "scene.h5")
    return jsynth.write_synthetic_file(path, scene), scene


def _run(main, path, scene, outdir=None, jax_side=False, **kw):
    sel_m = (0.0, scene.nx * scene.dx, scene.dx)
    if jax_side:
        with jax.enable_x64(False):
            return main(path, outdir=outdir, selected_channels_m=sel_m, **kw)
    return main(path, outdir=outdir, selected_channels_m=sel_m, device="cpu", **kw)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.array(x)


def _near(ref, got, rel=REL):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    assert ref.shape == got.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * float(np.abs(ref).max()))


def _db_near(ref, got, tol=SNR_DB, span=60.0):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    keep = np.isfinite(ref) & (ref >= np.nanmax(ref) - span)
    assert keep.any()
    np.testing.assert_allclose(got[keep], ref[keep], rtol=0, atol=tol)


def _same_files(jfigs, tfigs):
    assert set(tfigs) == set(jfigs)
    for key, path in tfigs.items():
        assert os.path.basename(path) == os.path.basename(jfigs[key])
        assert os.path.getsize(path) > 0


def test_fkcomp_matches_jax(scene_file, tmp_path):
    path, scene = scene_file
    jr = _run(jwf.fkcomp.main, path, scene, str(tmp_path / "j"), jax_side=True)
    tr = _run(fkcomp.main, path, scene, str(tmp_path / "t"))
    assert list(tr["filtered"]) == list(jr["filtered"]) == [
        "hybrid", "hybrid_ninf", "hybrid_gs", "hybrid_ninf_gs"]
    for name in jr["filtered"]:
        assert tr["compression"][name] == jr["compression"][name]
        _near(_np(jr["filtered"][name]), _np(tr["filtered"][name]))
        _db_near(_np(jr["snr"][name]), _np(tr["snr"][name]))
    _same_files(jr["figures"], tr["figures"])


def test_plots_matches_jax_and_writes_its_wav(scene_file, tmp_path):
    path, scene = scene_file
    jr = _run(jwf.plots.main, path, scene, str(tmp_path / "j"), jax_side=True)
    tr = _run(plots.main, path, scene, str(tmp_path / "t"))
    jtrf, ttrf = _np(jr["trf_fk"]), _np(tr["trf_fk"])
    _near(jtrf, ttrf)
    assert tr["best_channel"] == jr["best_channel"]
    (jp, jtt, jff), (tp, ttt, tff) = jr["spectrogram"], tr["spectrogram"]
    np.testing.assert_array_equal(ttt, jtt)
    np.testing.assert_array_equal(tff, jff)
    _db_near(_np(jp), _np(tp))
    _same_files(jr["figures"], tr["figures"])
    assert os.path.basename(tr["audio"]) == os.path.basename(jr["audio"])
    # the WAV: bitwise either package's writer on the port's own channel ...
    best = ttrf[tr["best_channel"]]
    with open(tr["audio"], "rb") as fh:
        got = fh.read()
    for mod in (jaudio, taudio):
        ref = mod.export_audio(best, scene.fs, str(tmp_path / f"{mod.__name__}.wav"), speed=5.0)
        with open(ref, "rb") as fh:
            assert fh.read() == got
    # ... and within the PCM step REL allows of JAX's (same header, rate, length)
    with open(jr["audio"], "rb") as fh:
        jwav = fh.read()
    assert got[:44] == jwav[:44]
    y, rate = taudio.read_audio(tr["audio"])
    jy, jrate = jaudio.read_audio(jr["audio"])
    assert rate == jrate == 1000 and y.shape == jy.shape == (scene.ns,)
    peak = float(np.abs(jtrf[jr["best_channel"]]).max())
    step = 2.0 * REL * float(np.abs(jtrf).max()) / peak * 32767.0
    assert float(np.abs(y - jy).max()) * 32767.0 <= np.ceil(step) + 1


def test_audio_module_is_bitwise_jax(tmp_path):
    rng = np.random.default_rng(4)
    x = rng.standard_normal(1000).astype(np.float32)
    for normalize in (True, False):
        np.testing.assert_array_equal(taudio.channel_to_pcm16(x * 0.3, normalize),
                                      jaudio.channel_to_pcm16(x * 0.3, normalize))
    a = taudio.export_audio(x, 200.0, str(tmp_path / "t.wav"), speed=3.0)
    b = jaudio.export_audio(x, 200.0, str(tmp_path / "j.wav"), speed=3.0)
    assert open(a, "rb").read() == open(b, "rb").read()
    for ry, rr in (taudio.read_audio(a), ):
        jy, jr = jaudio.read_audio(b)
        np.testing.assert_array_equal(ry, jy)
        assert rr == jr == 600


def test_median_is_the_midpoint_of_an_even_count():
    rng = np.random.default_rng(5)
    for n in (12, 13):
        x = rng.standard_normal((4, n)).astype(np.float32)
        got = bathynoise.median_last(torch.from_numpy(x)).numpy()
        with jax.enable_x64(False):
            import jax.numpy as jnp

            np.testing.assert_array_equal(got, np.array(jnp.median(jnp.asarray(x), axis=-1)))
    # torch's own median takes the lower middle value of an even count
    x = torch.tensor([[1.0, 2.0, 3.0, 4.0]])
    assert float(torch.median(x, dim=-1).values) == 2.0
    assert float(bathynoise.median_last(x)) == 2.5


def test_bathynoise_matches_jax(scene_file, tmp_path):
    import pandas as pd

    path, scene = scene_file
    assert scene.ns % 2 == 0     # the median of an even count: the midpoint rule shows
    n = 100
    csv = tmp_path / "cable.csv"
    pd.DataFrame({0: np.arange(n), 1: np.linspace(44, 45, n), 2: np.linspace(-126, -125, n),
                  3: -np.linspace(100, 600, n)}).to_csv(csv, header=False, index=False)
    jr = _run(jwf.bathynoise.main, path, scene, str(tmp_path / "j"), jax_side=True,
              cable_depth_csv=str(csv))
    tr = _run(bathynoise.main, path, scene, str(tmp_path / "t"), cable_depth_csv=str(csv))
    js, ts = jr["stats"], tr["stats"]
    assert set(ts) == set(js)
    for key in ("mean", "std", "noise_mean"):
        np.testing.assert_allclose(ts[key], js[key], rtol=REL, atol=0)
    from das4whales_tpu.ops.spectral import envelope as jenvelope

    with jax.enable_x64(False):
        jenv = np.array(jenvelope(jr["trf_fk"]))
    row_diff = np.abs(spectral.envelope(tr["trf_fk"]).numpy() - jenv).max(axis=-1)
    assert np.all(np.abs(ts["med"] - js["med"]) <= row_diff)
    for key in ("snr_1d", "noise_power_db"):
        np.testing.assert_allclose(ts[key], js[key], rtol=0, atol=SNR_1D_DB)
    np.testing.assert_allclose(ts["depth"], js["depth"], rtol=1e-12)
    _same_files(jr["figures"], tr["figures"])


def _assert_picks(jpicks, tpicks, env_of, thr_of):
    total = 0
    for name, b in tpicks.items():
        bad = unexplained_differences(np.asarray(jpicks[name]), np.asarray(b), env_of(name),
                                      thr_of(name))
        assert not bad, f"{name}: picks differ beyond rounding at {bad[:10]}"
        total += np.asarray(b).shape[1]
    assert total > 0


def test_mfdetect_figures_match_jax(scene_file, tmp_path):
    path, scene = scene_file
    jr = _run(jwf.mfdetect.main, path, scene, str(tmp_path / "j"), jax_side=True)
    tr = _run(mfdetect.main, path, scene, str(tmp_path / "t"))
    assert sorted(tr["figures"]) == ["detection", "snr_HF", "snr_LF", "tx"]
    _same_files(jr["figures"], tr["figures"])
    _assert_picks(jr["picks"], tr["picks"],
                  lambda n: spectral.envelope_sqrt(tr["correlograms"][n]).numpy(),
                  lambda n: tr["thresholds"][n])


def test_spectrodetect_figure_matches_jax(scene_file, tmp_path):
    path, scene = scene_file
    jr = _run(jwf.spectrodetect.main, path, scene, str(tmp_path / "j"), jax_side=True,
              threshold=5.0)
    tr = _run(spectrodetect.main, path, scene, str(tmp_path / "t"), threshold=5.0)
    assert list(tr["figures"]) == ["detection"]
    _same_files(jr["figures"], tr["figures"])
    _assert_picks(jr["picks"], tr["picks"], lambda n: _np(tr["correlograms"][n]),
                  lambda n: 5.0)


def test_gabordetect_figure_matches_jax(scene_file, tmp_path):
    path, scene = scene_file
    jr = _run(jwf.gabordetect.main, path, scene, str(tmp_path / "j"), jax_side=True)
    tr = _run(gabordetect.main, path, scene, str(tmp_path / "t"))
    assert list(tr["figures"]) == ["detection"]
    _same_files(jr["figures"], tr["figures"])
    assert list(tr["picks"]) == list(jr["picks"])


@pytest.mark.parametrize("main", [mfdetect.main, spectrodetect.main, gabordetect.main,
                                  fkcomp.main, plots.main, bathynoise.main])
def test_a_main_asked_for_figures_without_matplotlib_stops_before_reading(
        main, tmp_path, monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)
    with pytest.raises(ImportError, match="needs matplotlib"):
        main(str(tmp_path / "absent.h5"), outdir=str(tmp_path / "o"), device="cpu")
    assert not (tmp_path / "o").exists()
