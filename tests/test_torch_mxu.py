"""The matmul engines of das4whales_tpu_torch (``ops/mxu.py``) against
das4whales_tpu's on the CPU (float32, x64 off; ``pick_mode="sparse"``,
engines explicit on both sides): the Toeplitz and tap-folded correlates,
the f-k DFT product and the matmul STFT hold JAX's values within the
stated tolerances, and the port's matmul routes pick what JAX's FFT
route picks up to rounding knife edges (``utils.parity``). JAX's own
matmul routes are not held bitwise to its FFT route: two of its tests of
that fail on this image, so the oracle is its values and its FFT picks.
JAX's ``test_engine_switch_compile_budget`` pair counts XLA compiles;
eager PyTorch compiles nothing, so it has no counterpart here.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _mxu_helpers import fin_template_pair
from das4whales_tpu.io.synth import SyntheticCall, SyntheticScene, synthesize_scene, to_raw_counts
from das4whales_tpu.models.matched_filter import MatchedFilterDetector as JaxDetector
from das4whales_tpu.ops import filters as jfilters
from das4whales_tpu.ops import mxu as jmxu
from das4whales_tpu.ops import spectral as jspectral
from das4whales_tpu_torch import convert
from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector as TorchDetector
from das4whales_tpu_torch.ops import filters as tfilters
from das4whales_tpu_torch.ops import fk as tfk
from das4whales_tpu_torch.ops import mxu as tmxu
from das4whales_tpu_torch.ops import spectral as tspectral
from das4whales_tpu_torch.ops import xcorr as txcorr
from das4whales_tpu_torch.utils import device as tdevice
from das4whales_tpu_torch.utils.parity import envelopes, unexplained_differences
from tests.torch_threads import one_torch_thread  # noqa: F401

FS = 200.0
#: value tolerance against JAX: a fraction of the reference's max |value|
REL = 1e-5


@pytest.fixture(autouse=True)
def _table(tmp_path, monkeypatch):
    # every gate and calibration of a test writes its own table
    monkeypatch.setenv("DAS_CALIBRATION_CACHE", str(tmp_path / "cal.json"))


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(fn, *args, **kw):
    with jax.enable_x64(False):
        return np.array(fn(*(jnp.asarray(a) for a in args), **kw))


def _close(got, ref, rel=REL):
    err = np.abs(np.asarray(got, np.float64) - ref).max() / np.abs(ref).max()
    assert err <= rel, err


def _triple(n):
    return txcorr.padded_template_stats(np.pad(fin_template_pair(), ((0, 0), (0, n - 137))))


def _block(C, n, seed):
    return np.random.default_rng(seed).normal(size=(C, n)).astype(np.float32)


# ---------------------------------------------------------------- ops

def test_correlate_taps_is_exact_toeplitz():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 50)).astype(np.float32)
    tt = rng.normal(size=(2, 7)).astype(np.float32)
    got = tmxu.correlate_taps(_t(x), _t(tt)).numpy()
    want = np.zeros((2, 3, 50), np.float64)
    for t in range(2):
        for c in range(3):
            for k in range(50):
                for j in range(7):
                    if k + j < 50:
                        want[t, c, k] += float(x[c, k + j]) * float(tt[t, j])
    assert got.dtype == np.float32 and got.shape == (2, 3, 50)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    # leading axes fold into the rows and come back
    stack = tmxu.correlate_taps(_t(np.stack([x, x[::-1]])), _t(tt)).numpy()
    np.testing.assert_array_equal(stack[:, 0], got)


@pytest.mark.parametrize("shape", [(24, 900), (32, 2000)])
@pytest.mark.parametrize("bf16", [False, True])
def test_matmul_correlograms_match_jax(shape, bf16):
    C, n = shape
    x = _block(C, n, C)
    tt, mu, sc = _triple(n)
    ref = _j(jmxu.compute_cross_correlograms_matmul, x, tt, mu, sc, bf16=bf16)
    got = tmxu.compute_cross_correlograms_matmul(_t(x), _t(tt), _t(mu), _t(sc), bf16=bf16)
    assert got.dtype == torch.float32 and got.shape == (2, C, n)
    _close(got.numpy(), ref)
    # the float32 matmul against the port's own FFT route
    fft = txcorr.compute_cross_correlograms_corrected(_t(x), _t(tt), _t(mu), _t(sc)).numpy()
    _close(got.numpy(), fft, 2e-2 if bf16 else REL)


def test_fused_taps_and_correlograms_match_jax():
    C, n = 24, 900
    fir, _ = tfilters.butter_zero_phase_fir(FS, (14.0, 30.0))
    jfir, _ = jfilters.butter_zero_phase_fir(FS, (14.0, 30.0))
    np.testing.assert_array_equal(fir, jfir)
    tt = fin_template_pair()
    folded, tcum, L = tmxu.fused_template_taps(tt, fir)
    jf, jt, jL = jmxu.fused_template_taps(tt, jfir)
    assert L == jL and folded.dtype == np.float32
    np.testing.assert_array_equal(folded, jf)
    np.testing.assert_array_equal(tcum, jt)
    x = 0.02 * _block(C, n, 5)
    _, mu, sc = _triple(n)
    ref = _j(lambda *a: jmxu.compute_cross_correlograms_fused(*a, L), x, tt, folded, tcum, mu, sc)
    got = tmxu.compute_cross_correlograms_fused(_t(x), _t(tt), _t(folded), _t(tcum), _t(mu),
                                                _t(sc), L)
    _close(got.numpy(), ref)


def test_fused_fold_exact_vs_linear_staged():
    # the fold is exact against a LINEARLY filtered staged correlate at
    # every lag, the ring-down tail's included
    fir, _ = tfilters.butter_zero_phase_fir(FS, (14.0, 30.0))
    L = (fir.shape[0] - 1) // 2
    C, n = 6, 900
    x = 0.02 * _block(C, n, 0)
    tt = fin_template_pair()
    _, mu, sc = _triple(n)
    g_lin = np.stack([np.convolve(fir.astype(np.float64), x[c].astype(np.float64))[L:L + n]
                      for c in range(C)]).astype(np.float32)
    ref = txcorr.compute_cross_correlograms_corrected(_t(g_lin), _t(tt), _t(mu), _t(sc))
    folded, tcum, _ = tmxu.fused_template_taps(tt, fir)
    got = tmxu.compute_cross_correlograms_fused(_t(x), _t(tt), _t(folded), _t(tcum), _t(mu),
                                                _t(sc), L)
    _close(got.numpy(), ref.numpy(), 5e-5)


@pytest.mark.parametrize("C", [40, 257])
def test_dft_matrices_bitwise(C):
    for a, b in zip(tmxu.dft_matrices(C), jmxu.dft_matrices(C)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("C,N,lo,hi", [(40, 512, 20, 90), (24, 900, 60, 160)])
def test_fk_apply_dft_matmul_matches_jax(C, N, lo, hi):
    rng = np.random.default_rng(1)
    tr = rng.normal(size=(C, N)).astype(np.float32)
    mb = rng.uniform(size=(C, hi - lo)).astype(np.float32)
    wr, wi = tmxu.dft_matrices(C)
    ref = _j(lambda *a: jmxu.fk_apply_dft_matmul(*a[:2], lo, hi, *a[2:]), tr, mb, wr, wi)
    got = tmxu.fk_apply_dft_matmul(_t(tr), _t(mb), lo, hi, _t(wr), _t(wi))
    _close(got.numpy(), ref)
    _close(got.numpy(), tfk.fk_filter_apply_rfft_banded(_t(tr), _t(mb), lo, hi).numpy())
    # a leading file axis runs as one product and gives each file its own
    stack = tmxu.fk_apply_dft_matmul(_t(np.stack([tr, tr[::-1]])), _t(mb), lo, hi, _t(wr),
                                     _t(wi))
    _close(stack[0].numpy(), got.numpy(), 1e-6)
    _close(stack[1].numpy(), tmxu.fk_apply_dft_matmul(_t(tr[::-1]), _t(mb), lo, hi, _t(wr),
                                                      _t(wi)).numpy(), 1e-6)
    assert tmxu.fk_apply_body(_t(tr), _t(mb), lo, hi, "fft", None).shape == (C, N)


@pytest.mark.parametrize("nfft,hop", [(160, 8), (64, 16)])
def test_stft_magnitude_matmul_matches_jax(nfft, hop):
    x = _block(6, 1200, 3)
    ref = _j(lambda a: jspectral.stft_magnitude_matmul(a, nfft, hop), x)
    got = tspectral.stft_magnitude(_t(x), nfft, hop, engine="matmul")
    assert got.shape == ref.shape and got.dtype == torch.float32
    _close(got.numpy(), ref)
    _close(got.numpy(), tspectral.stft_magnitude(_t(x), nfft, hop, engine="rfft").numpy())
    assert tspectral.check_stft_engine("matmul") == "matmul"


def test_bf16_route_is_float32_of_bf16_inputs_and_float32_routes_keep_tf32_off(monkeypatch):
    """The bf16 route convolves bf16-ROUNDED float32 inputs in float32 and
    returns float32 (never a bf16 output); every contraction of every
    engine launches with TF32 off (a spy reads the flags at each launch)."""
    seen = []
    real = F.conv1d

    def spy(x, w, *a, **kw):
        seen.append((x.dtype, w.dtype, torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32))
        return real(x, w, *a, **kw)

    monkeypatch.setattr(tmxu.F, "conv1d", spy)
    tdevice.resolve_device("cpu")                        # sets both flags off
    x = _block(8, 600, 9)
    tt, mu, sc = _triple(600)
    f32 = tmxu.compute_cross_correlograms_matmul(_t(x), _t(tt), _t(mu), _t(sc))
    b16 = tmxu.compute_cross_correlograms_matmul(_t(x), _t(tt), _t(mu), _t(sc), bf16=True)
    fir, _ = tfilters.butter_zero_phase_fir(FS, (14.0, 30.0))
    folded, tcum, L = tmxu.fused_template_taps(tt, fir)
    tmxu.compute_cross_correlograms_fused(_t(x), _t(tt), _t(folded), _t(tcum), _t(mu), _t(sc), L)
    assert len(seen) == 4
    assert all(s == (torch.float32, torch.float32, False, False) for s in seen)
    assert f32.dtype == b16.dtype == torch.float32
    # exactly the float32 route on bf16-rounded inputs
    xr = _t(x).to(torch.bfloat16).float().numpy()
    ttr = _t(tt).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(
        tmxu.correlate_taps(_t(x), _t(tt), bf16=True).numpy(),
        tmxu.correlate_taps(_t(xr), _t(ttr)).numpy())
    assert not torch.equal(f32, b16)


# ---------------------------------------------------------------- detectors

def _scene(nx, ns, seed):
    scene = SyntheticScene(nx=nx, ns=ns, noise_rms=0.05, seed=seed, calls=[
        SyntheticCall(t0=1.2, x0_m=nx / 2 * 2.042, amplitude=2.0),
        SyntheticCall(t0=2.6, x0_m=nx / 3 * 2.042, amplitude=0.9, fmin=14.7, fmax=21.8,
                      duration=0.78)])
    raw = to_raw_counts(synthesize_scene(scene), scene.metadata)
    cond = ((raw - raw.mean(axis=1, keepdims=True)) * scene.metadata.scale_factor)
    return scene, {"raw": raw, "conditioned": cond.astype(np.float32)}


@pytest.fixture(scope="module")
def scenes():
    return {(24, 900): _scene(24, 900, 3), (32, 2000): _scene(32, 2000, 4)}


def _jax_fft(scene, wire, **kw):
    with jax.enable_x64(False):
        return JaxDetector(scene.metadata, [0, scene.nx, 1], (scene.nx, scene.ns), wire=wire,
                           pick_mode="sparse", mf_engine="fft", fk_engine="fft", **kw)


def _port(jd, scene, wire, **kw):
    design = convert.design_from_arrays({f: getattr(jd.design, f) for f in convert.DESIGN_FIELDS})
    return TorchDetector.from_design(design, scene.metadata, wire=wire, device="cpu", **kw)


def _assert_knife_edges(ref, got, env, thr_rtol=1e-5, edge=0):
    """Picks up to rounding knife edges of ``env``, over samples at least
    ``edge`` from either end of the record."""
    total = 0
    for i, name in enumerate(ref.picks):
        np.testing.assert_allclose(got.thresholds[name], ref.thresholds[name], rtol=thr_rtol)
        a, b = np.asarray(ref.picks[name]), got.picks[name]
        n = env.shape[-1]
        a, b = (p[:, (p[1] >= edge) & (p[1] < n - edge)] for p in (a, b))
        bad = unexplained_differences(a, b, env[i], ref.thresholds[name])
        assert not bad, f"{name}: picks differ beyond rounding at {bad[:10]}"
        total += b.shape[1]
    assert total > 0, "parity over an empty pick set proves nothing"


def _route_env(td, x):
    """The envelopes ``td``'s one-program route picks on, on its engines."""
    from das4whales_tpu_torch.models.matched_filter import mf_filter_fused, mf_filter_only

    mask, staged, kw = td._program_inputs()
    xin = td.condition_input(x)
    trf = (mf_filter_only(xin, mask, td._bp_gain, td._band_lo, td._band_hi,
                          td.design.bp_padlen, 0, td.fk_engine, kw["fk_dft"]) if staged
           else mf_filter_fused(xin, mask, td._band_lo, td._band_hi, 0, td.fk_engine,
                                kw["fk_dft"]))
    corr = tmxu.correlograms_body(trf, td._templates_true, td._template_mu,
                                  td._template_scale, td.mf_engine, fused=kw["mf_fused"],
                                  fir_half=kw["fir_half"])
    return tspectral.envelope_sqrt(corr).numpy()


ENGINES = [dict(mf_engine="matmul"), dict(mf_engine="matmul", fk_engine="matmul"),
           dict(mf_engine="matmul-fused")]


@pytest.mark.parametrize("engines", ENGINES, ids=lambda e: "+".join(e.values()))
@pytest.mark.parametrize("wire", ["raw", "conditioned"])
@pytest.mark.parametrize("shape,tile", [((24, 900), None), ((32, 2000), 8)])
def test_detect_picks_matmul_routes_match_jax_fft(scenes, engines, wire, shape, tile):
    """JAX's FFT-route picks up to knife edges. The tap-folded engine
    filters linearly where the FFT route's bandpass is circular, so it is
    held to them at least the FIR's half-length from the record's ends,
    and to JAX's own ``matmul-fused`` route over the whole record."""
    scene, blocks = scenes[shape]
    x = blocks[wire]
    jd = _jax_fft(scene, wire, channel_tile=tile, keep_correlograms=False)
    with jax.enable_x64(False):
        ref = jd.detect_picks(x)
    td = _port(jd, scene, wire, channel_tile=tile, **engines)
    for key, val in engines.items():
        assert getattr(td, key) == val, getattr(td, f"{key}_reason")
    got = td.detect_picks(x)
    assert td.syncs == td.dispatches
    fft_env = envelopes(_port(jd, scene, wire, channel_tile=tile), x)
    if engines["mf_engine"] != "matmul-fused":
        _assert_knife_edges(ref, got, fft_env)
        return
    _assert_knife_edges(ref, got, fft_env, thr_rtol=1e-4, edge=td._mf_fir_half)
    with jax.enable_x64(False):
        jf = JaxDetector(scene.metadata, [0, scene.nx, 1], (scene.nx, scene.ns), wire=wire,
                         pick_mode="sparse", channel_tile=tile, keep_correlograms=False,
                         mf_engine="matmul-fused", fk_engine="fft")
        assert jf.mf_engine == "matmul-fused"
        jref = jf.detect_picks(x)
    _assert_knife_edges(jref, got, _route_env(td, x))


def test_full_call_on_matmul_matches_jax_fft(scenes):
    scene, blocks = scenes[(32, 2000)]
    x = blocks["raw"]
    jd = _jax_fft(scene, "raw", channel_tile=8)
    with jax.enable_x64(False):
        jres = jd(x)
        jcorr = {k: np.array(v) for k, v in jres.correlograms.items()}
    td = _port(jd, scene, "raw", channel_tile=8, pick_mode="sparse", mf_engine="matmul")
    assert td._route() == "tiled" and td._staged_mf_engine == "matmul"
    res = td(x)
    for name, c in res.correlograms.items():
        _close(c.numpy(), jcorr[name])
    _close(res.trf_fk.numpy(), np.array(jres.trf_fk))
    _assert_knife_edges(jres, res, envelopes(_port(jd, scene, "raw", channel_tile=8), x))


def test_fused_engine_runs_the_gainless_mask_and_no_staged_bandpass(scenes):
    scene, blocks = scenes[(24, 900)]
    jd = _jax_fft(scene, "raw")
    for fused_bp in (True, False):
        td = _port(jd, scene, "raw", mf_engine="matmul-fused", fused_bandpass=fused_bp)
        assert td.mf_engine == "matmul-fused" and td._staged_mf_engine == "matmul"
        mask, staged, kw = td._program_inputs()
        assert staged is False and kw["mf_fused"] is not None and kw["fir_half"] > 0
        gainless = tfk.banded_mask_half(td.design.fk_mask)[0]
        np.testing.assert_array_equal(mask.numpy(), gainless)
        assert kw["mf_fused"][0].shape[0] == td._templates_true.shape[0] + 1
