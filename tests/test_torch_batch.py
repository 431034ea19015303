"""Port parity, the batched slab route: ``stream_batched_slabs`` ->
``BatchedMatchedFilterDetector.detect_batch(with_health=True)`` of
das4whales_tpu_torch (on the CPU) against das4whales_tpu's (float32, x64
off, ``serial=True``, ``pick_mode="sparse"``, ``mf_engine="fft"``,
``fk_engine="fft"``), on five files — four of 64 x 1000 samples and one
of 64 x 900 — in slabs of 2 at pow2 buckets of at least 1024 samples:
two full slabs and a partial one.

Both detectors run on one design (``convert.design_from_arrays``) and one
bucket configuration (``convert.bucket_config_from_fields``). Contract
against JAX: thresholds within rtol 1e-6, health counts exact (rms
within rtol 1e-5: float32 sums in another order), and pick sets equal or
differing only on rounding knife edges (``utils.parity``: pocketfft and
XLA's FFT round differently, as in ``test_torch_detector.py``). Within
the port, bitwise: the serial mode against ``detect_picks`` on each
padded file, and the batched mode's picks against the serial mode's.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from das4whales_tpu import config as jcfg
from das4whales_tpu.eval import SpectroEvalAdapter as JaxAdapter
from das4whales_tpu.io.stream import stream_batched_slabs as jax_stream
from das4whales_tpu.io.synth import (
    SyntheticCall,
    SyntheticScene,
    synthesize_scene,
    write_synthetic_file,
)
from das4whales_tpu.models.matched_filter import MatchedFilterDetector as JaxDetector
from das4whales_tpu.parallel.batch import BatchedMatchedFilterDetector as JaxBatched
from das4whales_tpu.parallel.batch import BatchedSpectroDetector as JaxBatchedSpectro
from das4whales_tpu.workflows.spectrodetect import campaign_detector as jax_campaign_detector
from das4whales_tpu_torch import convert
from das4whales_tpu_torch.io.stream import stream_batched_slabs
from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector
from das4whales_tpu_torch.ops import conditioning
from das4whales_tpu_torch.parallel.batch import (
    BatchedMatchedFilterDetector,
    BatchedSpectroDetector,
    batched_detector_for,
    trim_picks,
)
from das4whales_tpu_torch.utils.parity import envelopes, unexplained_differences
from das4whales_tpu_torch.workflows.spectrodetect import campaign_detector
from tests.torch_threads import one_torch_thread  # noqa: F401

NX = 64
SEL = [0, NX, 1]
LENGTHS = (1000, 1000, 1000, 1000, 900)
BUCKET = jcfg.BatchBucketConfig(mode="pow2", min_length=1024)
T_BUCKET = 1024
CLIP = {"conditioned": 3e-10, "raw": 1500.0}


def _port_bucket():
    return convert.bucket_config_from_fields({f: getattr(BUCKET, f) for f in convert.BUCKET_FIELDS})


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("slab_files")
    paths = []
    for k, ns in enumerate(LENGTHS):
        # two calls a file: every channel has two picks, so K0 = 1 saturates
        scene = SyntheticScene(nx=NX, ns=ns, noise_rms=0.05, seed=100 + k, calls=[
            SyntheticCall(t0=0.8 + 0.3 * k, x0_m=(16 + 8 * k) * 2.042, amplitude=2.0),
            SyntheticCall(t0=3.0, x0_m=(48 - 4 * k) * 2.042, amplitude=2.0)])
        paths.append(write_synthetic_file(str(d / f"file{k}.h5"), scene))
    meta = SyntheticScene(nx=NX, ns=LENGTHS[0]).metadata
    return paths, meta


def _jax_detector(meta, wire, **kw):
    return JaxDetector(meta, SEL, (NX, T_BUCKET), wire=wire, pick_mode="sparse",
                       keep_correlograms=False, mf_engine="fft", fk_engine="fft", **kw)


def _jax_run(paths, det, wire, **detect_kw):
    out = []
    with jax.enable_x64(False):
        bd = JaxBatched(det, serial=True)
        for slab in jax_stream(paths, SEL, batch=2, bucket=BUCKET, wire=wire):
            out += bd.detect_batch(slab.stack, n_real=slab.n_real, n_valid=slab.n_valid,
                                   **detect_kw)
    return out


def _port_run(paths, det, wire, serial, **detect_kw):
    out, slabs = [], []
    bd = BatchedMatchedFilterDetector(det, serial=serial)
    for slab in stream_batched_slabs(paths, SEL, batch=2, bucket=_port_bucket(), wire=wire,
                                     device="cpu"):
        slabs.append((slab.n_valid, slab.n_real, tuple(slab.stack.shape)))
        out += bd.detect_batch(slab.stack, n_real=slab.n_real, n_valid=slab.n_valid,
                               **detect_kw)
    return out, slabs


@pytest.fixture(scope="module", params=["conditioned", "raw"])
def route(request, files):
    """Per wire: the JAX results (with health, clip on) and the port's
    serial and batched results on the same design."""
    paths, meta = files
    wire = request.param
    with jax.enable_x64(False):
        jd = _jax_detector(meta, wire)
    kw = dict(with_health=True, health_clip=CLIP[wire])
    jres = _jax_run(paths, jd, wire, **kw)
    design = convert.design_from_arrays({f: getattr(jd.design, f) for f in convert.DESIGN_FIELDS})
    port = {}
    for serial in (True, False):
        td = MatchedFilterDetector.from_design(design, meta, wire=wire, device="cpu")
        res, slabs = _port_run(paths, td, wire, serial, **kw)
        port[serial] = (td, res, slabs)
    return dict(wire=wire, meta=meta, paths=paths, jd=jd, design=design, jres=jres, port=port)


def _envelopes(route, block, n_real):
    """The envelopes the program picks on for one bucket-padded file: on
    the raw wire conditioned over its real samples, as the program does."""
    det = MatchedFilterDetector.from_design(route["design"], route["meta"],
                                            wire="conditioned", device="cpu")
    x = torch.as_tensor(block)
    if route["wire"] == "raw":
        x = conditioning.condition_padded(x, det._cond_scale, int(n_real))
    return envelopes(det, x)


def _padded_blocks(route):
    slabs = list(stream_batched_slabs(route["paths"], SEL, batch=2, bucket=_port_bucket(),
                                      wire=route["wire"], as_numpy=True))
    return [(s.stack[j], s.n_real[j]) for s in slabs for j in range(s.n_valid)]


def _assert_picks_match(route, jres, res):
    """Thresholds within rtol 1e-6; pick sets equal up to knife edges."""
    n_picks = 0
    for (block, n_real), j, r in zip(_padded_blocks(route), jres, res):
        jp, jt, tp, tt = j[0], j[1], r[0], r[1]
        assert list(jp) == list(tp)
        env = None
        for i, name in enumerate(jp):
            np.testing.assert_allclose(tt[name], jt[name], rtol=1e-6)
            a = np.asarray(jp[name])
            if not np.array_equal(a, tp[name]):
                env = _envelopes(route, block, n_real) if env is None else env
                bad = unexplained_differences(a, tp[name], env[i], tt[name])
                assert not bad, f"{name}: picks differ beyond rounding at {bad[:10]}"
            n_picks += tp[name].shape[1]
    assert n_picks > 0, "parity over an empty pick set proves nothing"


def _assert_health_equal(a: dict, b: dict):
    for key in ("nonfinite", "clipped", "n_samples", "n_channels", "n_bins", "bin_channels",
                "bin_nonfinite", "bin_clipped", "bin_dead", "dead_channels"):
        assert a[key] == b[key], key
    np.testing.assert_allclose(b["rms"], a["rms"], rtol=1e-5)
    np.testing.assert_allclose(b["bin_rms"], a["bin_rms"], rtol=1e-5)


def test_slabs_are_two_full_and_one_partial(route):
    _, _, slabs = route["port"][True]
    assert slabs == [(2, (1000, 1000), (2, NX, T_BUCKET)), (2, (1000, 1000), (2, NX, T_BUCKET)),
                     (1, (900,), (2, NX, T_BUCKET))]


def test_serial_matches_jax(route):
    jres = route["jres"]
    td, res, _ = route["port"][True]
    assert len(res) == len(jres) == len(LENGTHS)
    _assert_picks_match(route, jres, res)
    for (_, _, jh), (_, _, th) in zip(jres, res):
        _assert_health_equal(jh, th)
    # one packed read per attempt, one attempt per slab, no escalation
    assert td.syncs == td.dispatches == 3 and td.escalations == 0


def test_health_counts_what_the_clip_admits(route):
    """The clip is set inside the signal's range, so the counts are not
    all zero, and the 900-sample file counts its real samples only."""
    _, res, _ = route["port"][True]
    assert sum(h["clipped"] for _, _, h in res) > 0
    assert [h["n_samples"] for _, _, h in res] == [NX * n for n in LENGTHS]
    assert all(h["nonfinite"] == 0 for _, _, h in res)


def test_batched_mode_gives_the_serial_picks(route):
    _, serial, _ = route["port"][True]
    td, batched, _ = route["port"][False]
    for (sp, st, sh), (bp, bt, bh) in zip(serial, batched):
        for name in sp:
            np.testing.assert_array_equal(bp[name], sp[name])
            np.testing.assert_allclose(bt[name], st[name], rtol=1e-6)
        assert {k: sh[k] for k in ("nonfinite", "clipped", "bin_clipped", "bin_dead")} == \
               {k: bh[k] for k in ("nonfinite", "clipped", "bin_clipped", "bin_dead")}
        np.testing.assert_allclose(bh["rms"], sh["rms"], rtol=1e-6)
    assert td.syncs == td.dispatches == 3


def test_serial_equals_detect_picks_on_each_padded_file(route):
    """Serial mode runs the per-file program: bitwise ``detect_picks`` on
    each bucket-padded block, with the same health."""
    td, res, _ = route["port"][True]
    det = MatchedFilterDetector.from_design(route["design"], route["meta"], wire=route["wire"],
                                            device="cpu")
    for (block, n_real), (tp, tt, th) in zip(_padded_blocks(route), res):
        one = det.detect_picks(block, n_real=n_real, with_health=True,
                               health_clip=CLIP[route["wire"]])
        for name in tp:
            np.testing.assert_array_equal(one.picks[name], tp[name])
            assert one.thresholds[name] == tt[name]
        assert one.health == th


def test_trimmed_picks_stay_inside_the_record(route):
    _, res, _ = route["port"][True]
    for (picks, _, _), n in zip(res, LENGTHS):
        trimmed = trim_picks(picks, n)
        for name, pk in trimmed.items():
            assert pk.shape[0] == 2 and (pk.shape[1] == 0 or pk[1].max() < n)
            kept = {tuple(p) for p in picks[name].T.tolist() if p[1] < n}
            assert {tuple(p) for p in pk.T.tolist()} == kept


@pytest.mark.parametrize("serial", [True, False])
def test_k0_saturation_reruns_the_slab_like_jax(files, serial):
    paths, meta = files
    with jax.enable_x64(False):
        jd = _jax_detector(meta, "raw")
        jd.pick_k0 = 1
    jres = _jax_run(paths[:2], jd, "raw")
    design = convert.design_from_arrays({f: getattr(jd.design, f) for f in convert.DESIGN_FIELDS})
    td = MatchedFilterDetector.from_design(design, meta, wire="raw", device="cpu")
    td.pick_k0 = 1
    res, _ = _port_run(paths[:2], td, "raw", serial)
    assert td.escalations == 1 and td.dispatches == 2 and td.syncs == 2
    _assert_picks_match(dict(paths=paths[:2], wire="raw", design=design, meta=meta), jres, res)


@pytest.mark.parametrize("serial", [True, False])
def test_capacity_overflow_gives_none_like_jax(files, serial):
    paths, meta = files
    with jax.enable_x64(False):
        jd = _jax_detector(meta, "conditioned", pick_pack_cap=8)
    jres = _jax_run(paths[:2], jd, "conditioned")
    design = convert.design_from_arrays({f: getattr(jd.design, f) for f in convert.DESIGN_FIELDS})
    td = MatchedFilterDetector.from_design(design, meta, wire="conditioned", pick_pack_cap=8,
                                           device="cpu")
    res, _ = _port_run(paths[:2], td, "conditioned", serial)
    assert [r is None for r in res] == [r is None for r in jres] == [True, True]
    assert td.syncs == td.dispatches == 1


def test_facade_defaults_and_refusals(route):
    td, _, _ = route["port"][True]
    assert BatchedMatchedFilterDetector(td).serial is True      # the CPU's default
    assert isinstance(batched_detector_for(td), BatchedMatchedFilterDetector)
    with pytest.raises(TypeError, match="no batched facade"):
        batched_detector_for(object())
    with pytest.raises(ValueError, match="not splittable"):   # the fin bank's global scope
        BatchedMatchedFilterDetector(td).split_views()
    with pytest.raises(ValueError, match="one batched detector serves one bucket"):
        BatchedMatchedFilterDetector(td).detect_batch(np.zeros((2, NX, 512), np.float32))


def test_bucket_config_carried_from_jax():
    for jb in (BUCKET, jcfg.BatchBucketConfig(mode="exact"),
               jcfg.BatchBucketConfig(mode="fixed", lengths=(2048, 12000))):
        pb = convert.bucket_config_from_fields({f: getattr(jb, f) for f in convert.BUCKET_FIELDS})
        for ns in (1, 900, 1000, 1024, 1025, 2048, 11000, 12000):
            try:
                want = jb.bucket_ns(ns)
            except ValueError:
                with pytest.raises(ValueError):
                    pb.bucket_ns(ns)
                continue
            assert pb.bucket_ns(ns) == want


# --- the spectro facade ----------------------------------------------------

#: 10 s records (shorter ones give the LF hat kernel no time bins); 32
#: channels, since on 24 the f-k fan's first wavenumber bin lies outside
#: the passband at these frequencies and the prefilter passes nothing
SPECTRO_NX, SPECTRO_NS = 32, 2000


@pytest.fixture(scope="module")
def spectro_slab():
    """Two 32 x 2000 strain records, stacked."""
    blocks = []
    for seed in (7, 8):
        scene = SyntheticScene(nx=SPECTRO_NX, ns=SPECTRO_NS, noise_rms=0.05, seed=seed, calls=[
            SyntheticCall(t0=3.0, x0_m=16 * 2.042, amplitude=1.0),
            SyntheticCall(t0=6.5, x0_m=8 * 2.042, amplitude=0.8, fmin=14.7, fmax=21.8,
                          duration=0.78)])
        blocks.append(np.asarray(synthesize_scene(scene), np.float32))
    return scene.metadata, np.stack(blocks)


@pytest.mark.parametrize("serial", [True, False])
def test_spectro_facade_matches_jax(spectro_slab, serial):
    meta, stack = spectro_slab
    shape = (SPECTRO_NX, SPECTRO_NS)
    with jax.enable_x64(False):
        jad = jax_campaign_detector(meta, [0, SPECTRO_NX, 1], shape, threshold=4.0,
                                    stft_engine="rfft")
        assert isinstance(jad, JaxAdapter)
        jres = JaxBatchedSpectro(jad, serial=True).detect_batch(stack, with_health=True)
    ad = campaign_detector(meta, [0, SPECTRO_NX, 1], shape, threshold=4.0, device="cpu")
    bd = batched_detector_for(ad, serial=serial)
    assert isinstance(bd, BatchedSpectroDetector)
    res = bd.detect_batch(stack, with_health=True)
    total = 0
    for b, ((jp, jt, jh), (tp, tt, th)) in enumerate(zip(jres, res)):
        assert jt == tt and list(jp) == list(tp)
        corr = ad.det.correlograms(ad.prefilter.filter_block(stack[b]))
        for name in jp:
            a, c = np.asarray(jp[name]), tp[name]
            # picks in sample units; the knife-edge check reads frame units
            # (sample = round(frame * k) with k = ns / frames > 1 inverts exactly)
            if not np.array_equal(a, c):
                env = corr[name].numpy()
                k = SPECTRO_NS / env.shape[-1]
                fa, fc = (np.stack([p[0], np.round(p[1] / k).astype(int)]) for p in (a, c))
                bad = unexplained_differences(fa, fc, env, tt[name])
                assert not bad, f"{name}: picks differ beyond rounding at {bad[:10]}"
            total += c.shape[1]
        assert jh == th     # host stats: the same numpy definition on the same rows
    assert total > 0
