"""Port parity, the full-artifact routes and the padded channel axis:
``MatchedFilterDetector.__call__`` (``_call_full`` untiled, ``_call_tiled``
tiled) in all three pick modes, ``design_matched_filter(channel_pad=...)``
through every filter variant, and the ops they need (the dense exact
picker, the scipy host route, the envelope SNR) — das4whales_tpu_torch on
the CPU against das4whales_tpu (float32, x64 off; ``pick_mode``,
``mf_engine="fft"`` and ``fk_engine="fft"`` explicit), on JAX's own
design (``convert.design_from_arrays``).

Tolerances: thresholds rtol 1e-5; ``trf_fk``, correlograms and
``filter_block`` within 1e-5 of their max (measured: 4e-7); the SNR within
0.01 dB wherever JAX's lies within 60 dB of its maximum (measured: 2e-3 dB;
below that the envelope's relative rounding grows without bound); picks
and the dense peak masks equal or differing only on rounding knife edges
(``utils.parity``, on the port's own envelopes). Within the port the
campaign configuration's ``__call__`` is ``detect_picks`` and the tiled
sparse route's picks and thresholds are ``detect_picks``' bit for bit.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import scipy.signal as sp
import torch

from das4whales_tpu import config as jcfg
from das4whales_tpu.io.synth import SyntheticCall, SyntheticScene, synthesize_scene, to_raw_counts
from das4whales_tpu.models import matched_filter as jmf
from das4whales_tpu.models import templates as jtpl
from das4whales_tpu.models.spectro import SpectroCorrDetector as JaxSpectro
from das4whales_tpu.ops import fk as jfk
from das4whales_tpu.ops import peaks as jpeaks
from das4whales_tpu.ops import spectral as jspectral
from das4whales_tpu.parallel.batch import BatchedMatchedFilterDetector as JaxBatched
from das4whales_tpu.utils import checkpoint as jckpt
from das4whales_tpu_torch import convert
from das4whales_tpu_torch.io.synth import SyntheticScene as TScene
from das4whales_tpu_torch.models import matched_filter as tmf
from das4whales_tpu_torch.models.spectro import SpectroCorrDetector
from das4whales_tpu_torch.ops import peaks as tpeaks
from das4whales_tpu_torch.ops import spectral as tspectral
from das4whales_tpu_torch.parallel.batch import BatchedMatchedFilterDetector
from das4whales_tpu_torch.utils import checkpoint as tckpt
from das4whales_tpu_torch.utils.parity import envelopes, unexplained_differences
from tests.torch_threads import one_torch_thread  # noqa: F401

REL = 1e-5
SNR_DB = 0.01
PAIR = jtpl.TemplateBank(
    name="pair", entries=(("HF", jcfg.FIN_HF_NOTE), ("LF", jcfg.FIN_LF_NOTE)),
    threshold_scope="per_template",
)


def _scene(nx, ns, seed):
    calls = [SyntheticCall(t0=1.2, x0_m=nx / 2 * 2.042, amplitude=2.0)]
    if ns >= 3000:
        calls.append(SyntheticCall(t0=8.0, x0_m=nx / 4 * 2.042, amplitude=1.5,
                                   fmin=14.7, fmax=21.8, duration=0.78))
    scene = SyntheticScene(nx=nx, ns=ns, noise_rms=0.05, seed=seed, calls=calls)
    raw = to_raw_counts(synthesize_scene(scene), scene.metadata)
    cond = ((raw - raw.mean(axis=1, keepdims=True))
            * scene.metadata.scale_factor).astype(np.float32)
    return scene, {"raw": raw, "conditioned": cond}


@pytest.fixture(scope="module")
def scenes():
    return {"small": _scene(24, 900, 0), "med": _scene(64, 3000, 1), "pad": _scene(49, 900, 2)}


def _jax_det(scene, **kw):
    return jmf.MatchedFilterDetector(scene.metadata, [0, scene.nx, 1], (scene.nx, scene.ns),
                                     mf_engine="fft", fk_engine="fft", **kw)


def _carry(jd):
    return convert.design_from_arrays({f: getattr(jd.design, f) for f in convert.DESIGN_FIELDS})


def _host(res):
    """A JAX result's device arrays as numpy copies."""
    return dict(picks={k: np.array(v) for k, v in res.picks.items()},
                thresholds=dict(res.thresholds),
                trf_fk=None if res.trf_fk is None else np.array(res.trf_fk),
                correlograms={k: np.array(v) for k, v in res.correlograms.items()},
                snr={k: np.array(v) for k, v in res.snr.items()},
                peak_masks={k: np.array(v) for k, v in res.peak_masks.items()})


def _close(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    scale = float(np.abs(b).max())
    err = float(np.abs(a - b).max())
    assert err <= REL * scale, f"{what}: max error {err:.3e} > {REL} * {scale:.3e}"


def _assert_picks(jpicks, tpicks, env, thresholds):
    total = 0
    for i, name in enumerate(jpicks):
        a, b = jpicks[name], tpicks[name]
        assert b.shape[0] == 2
        bad = unexplained_differences(a, b, env[i], thresholds[name])
        assert not bad, f"{name}: picks differ beyond rounding at {bad[:10]}"
        total += b.shape[1]
    assert total > 0, "parity over an empty pick set proves nothing"


def _assert_full_parity(jr, tr, names, *, snr, keep=True):
    assert list(tr.picks) == list(names)
    for name in names:
        np.testing.assert_allclose(tr.thresholds[name], jr["thresholds"][name], rtol=1e-5)
    _close(tr.trf_fk.numpy(), jr["trf_fk"], "trf_fk")
    assert set(tr.correlograms) == (set(names) if keep else set())
    for name in tr.correlograms:
        _close(tr.correlograms[name].numpy(), jr["correlograms"][name], f"correlograms {name}")
    assert set(tr.snr) == (set(names) if snr else set())
    for name in tr.snr:
        s, sj = tr.snr[name].numpy(), jr["snr"][name]
        near = sj > sj.max() - 60.0
        assert np.isfinite(s[near]).all()
        err = float(np.abs(s - sj)[near].max())
        assert err <= SNR_DB, f"snr {name}: {err:.3e} dB"


@pytest.mark.parametrize("pick_mode", ["sparse", "scipy", "dense"])
@pytest.mark.parametrize("tile", [None, 16])
def test_full_route_matches_jax(scenes, pick_mode, tile):
    scene, blocks = scenes["med"]
    x = blocks["raw"]
    with jax.enable_x64(False):
        jd = _jax_det(scene, wire="raw", pick_mode=pick_mode, channel_tile=tile)
        jr = _host(jd(x, with_snr=True))
    td = tmf.MatchedFilterDetector.from_design(_carry(jd), scene.metadata, wire="raw",
                                               pick_mode=pick_mode, channel_tile=tile,
                                               device="cpu")
    assert td._route() == ("tiled" if tile else "mono") and td.pick_mode == pick_mode
    tr = td(x, with_snr=True)
    names = td.design.template_names
    _assert_full_parity(jr, tr, names, snr=True)
    env = np.stack([tspectral.envelope_sqrt(tr.correlograms[n]).numpy() for n in names])
    _assert_picks(jr["picks"], tr.picks, env, tr.thresholds)
    if pick_mode == "dense":
        for i, name in enumerate(names):
            m = tr.peak_masks[name]
            assert m.dtype == bool and m.shape == (scene.nx, scene.ns)
            np.testing.assert_array_equal(tpeaks.convert_pick_times(m), tr.picks[name])
            _assert_picks({name: tpeaks.convert_pick_times(jr["peak_masks"][name])},
                          {name: tpeaks.convert_pick_times(m)}, env[i:i + 1], tr.thresholds)
    else:
        assert tr.peak_masks == {} and jr["peak_masks"] == {}


@pytest.mark.parametrize("tile", [None, 8])
def test_full_route_conditioned_bank_and_fixed_threshold(scenes, tile):
    """The conditioned wire, a per-template bank, no kept correlograms,
    and a caller's threshold."""
    scene, blocks = scenes["small"]
    x = blocks["conditioned"]
    for threshold in (None, 0.05):
        with jax.enable_x64(False):
            jd = _jax_det(scene, templates=PAIR, pick_mode="scipy", channel_tile=tile,
                          keep_correlograms=False)
            jr = _host(jd(x, threshold=threshold))
        td = tmf.MatchedFilterDetector.from_design(_carry(jd), scene.metadata,
                                                   pick_mode="scipy", channel_tile=tile,
                                                   keep_correlograms=False, device="cpu")
        tr = td(x, threshold=threshold)
        _assert_full_parity(jr, tr, td.design.template_names, snr=False, keep=False)
        if threshold is not None:
            assert set(tr.thresholds.values()) == {float(np.float32(threshold))}
        _assert_picks(jr["picks"], tr.picks, envelopes(td, x), tr.thresholds)


def test_auto_pick_mode_and_the_campaign_configuration(scenes):
    scene, blocks = scenes["small"]
    x = blocks["raw"]
    td = tmf.MatchedFilterDetector(scene.metadata, [0, scene.nx, 1], (scene.nx, scene.ns),
                                   wire="raw", device="cpu")
    assert td.pick_mode == "scipy" and td.keep_correlograms and td.peak_block == 1024
    td.detect_picks(x)               # the one-program route whatever the pick mode
    assert td.dispatches == td.syncs == 1
    with pytest.raises(ValueError, match="unknown pick_mode"):
        tmf.MatchedFilterDetector.from_design(td.design, td.metadata, pick_mode="fast",
                                              device="cpu")
    camp = tmf.MatchedFilterDetector.from_design(td.design, td.metadata, wire="raw",
                                                 pick_mode="sparse", keep_correlograms=False,
                                                 device="cpu")
    res = camp(x)
    assert camp.dispatches == camp.syncs == 1
    assert res.trf_fk is None and res.correlograms == {} and res.snr == {}
    ref = camp.detect_picks(x)
    for name in ref.picks:
        np.testing.assert_array_equal(res.picks[name], ref.picks[name])
        assert res.thresholds[name] == ref.thresholds[name]
    full = camp(x, with_snr=True)                 # SNR asks for the full route
    assert full.trf_fk is not None and set(full.snr) == set(ref.picks)


@pytest.fixture(scope="module")
def sparse_designs(scenes):
    """JAX's sparse-route designs of the ``med`` scene carried across, one
    per (bank, wire), each built once for the module (the cases of
    ``test_tiled_sparse_route_is_detect_picks_bitwise`` share them)."""
    scene, _ = scenes["med"]
    cache = {}

    def get(bank, wire):
        key = (getattr(bank, "name", bank), wire)
        if key not in cache:
            with jax.enable_x64(False):
                cache[key] = _carry(_jax_det(scene, templates=bank, wire=wire,
                                             pick_mode="sparse"))
        return cache[key]

    return get


@pytest.mark.parametrize("wire,k0", [("raw", None), ("conditioned", None), ("raw", 1)])
def test_tiled_sparse_route_is_detect_picks_bitwise(scenes, sparse_designs, wire, k0):
    """``_call_tiled``'s sparse picks and host thresholds against the
    one-program route on the same detector: bit for bit, escalation
    included."""
    scene, blocks = scenes["med"]
    x = blocks[wire]
    for bank in ("fin", PAIR):
        design = sparse_designs(bank, wire)
        td = tmf.MatchedFilterDetector.from_design(design, scene.metadata, wire=wire,
                                                   channel_tile=16, pick_mode="sparse",
                                                   device="cpu")
        thr = None
        if k0 is not None:
            td.pick_k0 = k0
            # a threshold low enough that rows saturate at K0
            thr = 0.3 * min(td.detect_picks(x).thresholds.values())
            td.escalations = 0
        full = td(x, threshold=thr)
        assert td.escalations == (1 if k0 else 0)
        ref = td.detect_picks(x, threshold=thr)
        assert td.escalations == (2 if k0 else 0)
        for name in ref.picks:
            np.testing.assert_array_equal(full.picks[name], ref.picks[name])
            assert full.picks[name].dtype == np.int64
            assert full.thresholds[name] == ref.thresholds[name]
        np.testing.assert_array_equal(full.trf_fk.numpy(), td.filter_block(x).numpy())


def test_tiled_sparse_overflow_takes_the_exact_merge(scenes, monkeypatch):
    scene, blocks = scenes["small"]
    td = tmf.MatchedFilterDetector(scene.metadata, [0, scene.nx, 1], (scene.nx, scene.ns),
                                   wire="raw", channel_tile=8, pick_mode="sparse", device="cpu")
    ref = td(blocks["raw"])
    monkeypatch.setattr(tpeaks, "compacted_to_host", lambda *a, **k: None)
    syncs = td.syncs
    got = td(blocks["raw"])
    assert td.syncs - syncs == 3   # thresholds, saturation, full transfer (the stub reads nothing)
    for name in ref.picks:
        np.testing.assert_array_equal(got.picks[name], ref.picks[name])


# -- the padded channel axis --------------------------------------------------


@pytest.mark.parametrize("pad,want", [("auto", 50), (60, 60)])
def test_padded_design_matches_jax(scenes, pad, want):
    scene, _ = scenes["pad"]
    sel = [0, scene.nx, 1]
    dj = jmf.design_matched_filter((scene.nx, scene.ns), sel, scene.metadata, channel_pad=pad)
    dt = tmf.design_matched_filter((scene.nx, scene.ns), sel, _port_meta(scene),
                                   channel_pad=pad)
    assert dt.fk_channels == dj.fk_channels == want
    assert dt.fk_mask.shape == dj.fk_mask.shape == (want, scene.ns)
    np.testing.assert_array_equal(dt.fk_mask, dj.fk_mask)
    assert dt.trace_shape == tuple(dj.trace_shape) == (scene.nx, scene.ns)
    msgs = []
    for mod, meta in ((jmf, scene.metadata), (tmf, _port_meta(scene))):
        with pytest.raises(ValueError) as ei:
            mod.design_matched_filter((scene.nx, scene.ns), sel, meta, channel_pad=40)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1] == "channel_pad=40 < channel count 49"


def _port_meta(scene):
    return TScene(nx=scene.nx, ns=scene.ns).metadata


@pytest.mark.parametrize("pad", ["auto", 64])
@pytest.mark.parametrize("fused", [True, False])
def test_padded_filter_block_matches_jax(scenes, pad, fused):
    scene, blocks = scenes["pad"]
    with jax.enable_x64(False):
        jd = _jax_det(scene, wire="raw", channel_pad=pad, fused_bandpass=fused,
                      pick_mode="sparse")
        ref = np.array(jd.filter_block(blocks["raw"]))
    td = tmf.MatchedFilterDetector.from_design(_carry(jd), scene.metadata, wire="raw",
                                               fused_bandpass=fused, device="cpu")
    assert td.fk_pad_rows == jd.fk_pad_rows == jd.design.fk_channels - scene.nx > 0
    got = td.filter_block(blocks["raw"]).numpy()
    _close(got, ref, "padded filter_block")
    unpadded = tmf.MatchedFilterDetector(scene.metadata, [0, scene.nx, 1],
                                         (scene.nx, scene.ns), wire="raw",
                                         fused_bandpass=fused, device="cpu")
    assert float(np.abs(unpadded.filter_block(blocks["raw"]).numpy() - got).max()) > 0


@pytest.mark.parametrize("tile", [None, 16])
def test_padded_detect_picks_match_jax(scenes, tile):
    scene, blocks = scenes["pad"]
    x = blocks["raw"]
    with jax.enable_x64(False):
        jd = _jax_det(scene, wire="raw", channel_pad="auto", pick_mode="sparse",
                      keep_correlograms=False, channel_tile=tile)
        jr = _host(jd.detect_picks(x))
        jstack = np.stack([x, np.roll(x, 97, axis=1)])
        jbat = JaxBatched(jd, serial=True).detect_batch(jstack)
    td = tmf.MatchedFilterDetector.from_design(_carry(jd), scene.metadata, wire="raw",
                                               channel_tile=tile, device="cpu")
    tr = td.detect_picks(x)
    for name in tr.picks:
        np.testing.assert_allclose(tr.thresholds[name], jr["thresholds"][name], rtol=1e-5)
    _assert_picks(jr["picks"], tr.picks, envelopes(td, x), tr.thresholds)
    full = td(x)                                  # the padded full-artifact route
    _assert_picks(tr.picks, full.picks, envelopes(td, x), tr.thresholds)
    for serial in (True, False):
        got = BatchedMatchedFilterDetector(td, serial=serial).detect_batch(jstack)
        for f in range(2):
            env = envelopes(td, jstack[f])
            for name in got[f][0]:
                np.testing.assert_allclose(got[f][1][name], jbat[f][1][name], rtol=1e-5)
            _assert_picks({k: np.asarray(v) for k, v in jbat[f][0].items()}, got[f][0], env,
                          got[f][1])


def test_padded_prefilter_matches_jax():
    """A padded design as the spectro family's prefilter
    (``filter_block``): correlograms within 1e-4 of their max (the spectro
    family's contract), frame picks equal up to knife edges."""
    nx, ns = 49, 2400
    scene = SyntheticScene(nx=nx, ns=ns, noise_rms=0.05, seed=4, calls=[
        SyntheticCall(t0=3.0, x0_m=nx / 2 * 2.042, amplitude=3.0)])
    cond = synthesize_scene(scene).astype(np.float32)
    with jax.enable_x64(False):
        jpre = _jax_det(scene, channel_pad="auto", pick_mode="sparse", keep_correlograms=False)
        jtrf = np.array(jpre.filter_block(cond))
        jcorr, jpicks, jfs = JaxSpectro(scene.metadata, threshold=4.0, stft_engine="rfft")(jtrf)
        jcorr = {k: np.array(v) for k, v in jcorr.items()}
    pre = tmf.MatchedFilterDetector.from_design(_carry(jpre), scene.metadata, device="cpu")
    assert pre.fk_pad_rows == 1
    trf = pre.filter_block(cond)
    _close(trf.numpy(), jtrf, "padded prefilter")
    corr, picks, fs = SpectroCorrDetector(scene.metadata, threshold=4.0, stft_engine="rfft",
                                          device="cpu")(trf)
    assert fs == jfs
    total = 0
    for name, c in corr.items():
        c = c.numpy()
        assert float(np.abs(c - jcorr[name]).max()) <= 1e-4 * float(np.abs(jcorr[name]).max())
        bad = unexplained_differences(np.asarray(jpicks[name]), picks[name], c, 4.0)
        assert not bad, f"{name}: picks differ beyond rounding at {bad[:10]}"
        total += picks[name].shape[1]
    assert total > 0


def test_padded_design_checkpoints_both_ways(scenes, tmp_path):
    scene, blocks = scenes["pad"]
    with jax.enable_x64(False):
        jd = _jax_det(scene, wire="raw", channel_pad="auto", pick_mode="sparse")
    pj = jckpt.save_design(str(tmp_path / "jax.npz"), jd.design)
    dt = tckpt.load_design(pj)
    assert dt.fk_channels == 50 and dt.fk_mask.shape[0] == 50
    np.testing.assert_array_equal(dt.fk_mask, jd.design.fk_mask)
    td = tmf.MatchedFilterDetector.from_design(dt, scene.metadata, wire="raw", device="cpu")
    ref = tmf.MatchedFilterDetector.from_design(_carry(jd), scene.metadata, wire="raw",
                                                device="cpu")
    np.testing.assert_array_equal(td.filter_block(blocks["raw"]).numpy(),
                                  ref.filter_block(blocks["raw"]).numpy())
    pt = tckpt.save_design(str(tmp_path / "port.npz"), dt)
    back = jckpt.load_design(pt)
    assert back.fk_channels == 50 and tuple(back.trace_shape) == (scene.nx, scene.ns)
    np.testing.assert_array_equal(back.fk_mask, jd.design.fk_mask)


def test_sparsity_report_matches_jax(scenes):
    scene, _ = scenes["pad"]
    dj = jmf.design_matched_filter((scene.nx, scene.ns), [0, scene.nx, 1], scene.metadata,
                                   channel_pad="auto")
    assert _carry_design(dj).sparsity_report() == dj.sparsity_report()
    assert tmf.design_matched_filter((scene.nx, scene.ns), [0, scene.nx, 1],
                                     _port_meta(scene)).sparsity_report() == \
        jfk.compression_report(jmf.design_matched_filter(
            (scene.nx, scene.ns), [0, scene.nx, 1], scene.metadata).fk_mask, verbose=False)


def _carry_design(dj):
    return convert.design_from_arrays({f: getattr(dj, f) for f in convert.DESIGN_FIELDS})


# -- the ops the full routes need ---------------------------------------------


def _rows(seed, shape=(6, 700)):
    rng = np.random.default_rng(seed)
    x = np.abs(np.convolve(rng.standard_normal(shape[0] * shape[1] + 8), np.ones(5) / 5,
                           "same")[: shape[0] * shape[1]]).reshape(shape).astype(np.float32)
    x[0, 100:104] = 2.0                      # a plateau
    x[1, 0] = 5.0                            # an edge maximum (no peak)
    x[2, 300:302] = x[2].max() + 1.0         # a two-sample plateau top
    return x


@pytest.mark.parametrize("seed", [0, 1])
def test_dense_picker_matches_jax_and_scipy(seed):
    x = _rows(seed)
    thr = np.float32(0.3)
    with jax.enable_x64(False):
        pj = np.array(jpeaks.peak_prominences_dense(x))
        mj = np.array(jpeaks.find_peaks_prominence(x, thr))
        bj = np.array(jpeaks.find_peaks_prominence_blocked(x, thr, 4))
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(tpeaks.peak_prominences_dense(xt).numpy(), pj)
    np.testing.assert_array_equal(tpeaks.find_peaks_prominence(xt, thr).numpy(), mj)
    np.testing.assert_array_equal(tpeaks.find_peaks_prominence_blocked(xt, thr, 4).numpy(), bj)
    host = tpeaks.find_peaks_scipy_host(xt, thr)
    np.testing.assert_array_equal(host, jpeaks.find_peaks_scipy_host(x, thr))
    np.testing.assert_array_equal(tpeaks.convert_pick_times(mj), host)
    for i in range(x.shape[0]):
        np.testing.assert_array_equal(np.nonzero(mj[i])[0],
                                      sp.find_peaks(x[i], prominence=thr)[0])


def test_pick_converters_match_jax():
    mask = _rows(2) > 0.6
    for a, b in zip(tpeaks.mask_to_pick_lists(torch.from_numpy(mask)),
                    jpeaks.mask_to_pick_lists(mask)):
        np.testing.assert_array_equal(a, b)
    lists = jpeaks.mask_to_pick_lists(mask)
    np.testing.assert_array_equal(tpeaks.convert_pick_times(lists),
                                  jpeaks.convert_pick_times(lists))
    np.testing.assert_array_equal(tpeaks.convert_pick_times(torch.from_numpy(mask)),
                                  jpeaks.convert_pick_times(mask))
    picks = jpeaks.convert_pick_times(mask)
    for a, b in zip(tpeaks.select_picked_times(picks, 0.5, 2.0, 200.0),
                    jpeaks.select_picked_times(picks, 0.5, 2.0, 200.0)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("env", [False, True])
def test_envelope_and_snr_match_jax(env):
    x = np.random.default_rng(3).standard_normal((5, 999)).astype(np.float32)
    with jax.enable_x64(False):
        sj = np.array(jspectral.snr_tr_array(x, env=env))
        ej = np.array(jspectral.envelope(x))
    st = tspectral.snr_tr_array(torch.from_numpy(x), env=env).numpy()
    near = sj > sj.max() - 60.0
    assert float(np.abs(st - sj)[near].max()) <= SNR_DB
    _close(tspectral.envelope(torch.from_numpy(x)).numpy(), ej, "envelope")


@pytest.mark.parametrize("scope", ["global", "per_template"])
def test_envelope_and_threshold_match_jax(scope):
    corr = np.random.default_rng(5).standard_normal((3, 7, 640)).astype(np.float32)
    fac = np.asarray([0.9, 1.0, 1.1], np.float32)
    with jax.enable_x64(False):
        ej, tj = (np.array(a) for a in jmf.mf_envelope_and_threshold(corr, fac, scope))
    et, tt = tmf.mf_envelope_and_threshold(torch.from_numpy(corr), torch.from_numpy(fac), scope)
    np.testing.assert_array_equal(tt.numpy(), tj)          # max and products are exact
    _close(et.numpy(), ej, "envelopes")
    for i in range(3):   # a template at a time: the pick kernel's transform shape
        np.testing.assert_array_equal(et[i].numpy(),
                                      tspectral.envelope_sqrt(torch.from_numpy(corr[i])).numpy())
