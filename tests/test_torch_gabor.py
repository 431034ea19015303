"""Port parity, the Gabor/image family: ``models.gabor``, the
``GaborEvalAdapter``, ``BatchedGaborDetector``, the planner program and
``workflows.gabordetect`` of das4whales_tpu_torch (on the CPU) against
das4whales_tpu's (float32, x64 off).

The scene is JAX's own test scene (``tests/test_gabor.py``: 128 x 3000,
one HF call, ``bin_factor=0.25``, thresholds 2000 / 1). The port runs on
JAX's design and JAX's float32 notes, carried across by
``convert.gabor_detector_from_jax``. Contract:

* the Gabor pair equal exactly; the port's own notes (float64 synthesis
  rounded once) within ``NOTE_ABS`` of JAX's (float32 synthesis);
* the score within ``SCORE_REL * max|score|``; the binary image and the
  mask equal except on knife edges — pixels where JAX's score lies within
  that tolerance of the threshold — counted and required to explain
  every flip;
* masked trace and correlograms within ``CORR_REL * max``; the per-note
  thresholds (``0.5 * max``, HF at 0.9x) within ``THR_REL`` (the max of
  an FFT correlation rounds differently);
* picks equal, or every pick in the symmetric difference on a rounding
  knife edge of the port's envelope (``utils.parity``).

Within the port: the serial batched facade's picks and thresholds are
bitwise the per-file adapter's; the batched mode's within the same
contract as the packages'.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sp
import torch

from das4whales_tpu import eval as jeval
from das4whales_tpu.config import AcquisitionMetadata
from das4whales_tpu.models import gabor as jg
from das4whales_tpu.models import templates as jtpl
from das4whales_tpu.models.matched_filter import MatchedFilterDetector as JaxMF
from das4whales_tpu.workflows import gabordetect as jgd
from das4whales_tpu_torch import config as tcfg
from das4whales_tpu_torch import convert
from das4whales_tpu_torch.eval import GaborEvalAdapter
from das4whales_tpu_torch.models import gabor as tg
from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector
from das4whales_tpu_torch.ops import spectral
from das4whales_tpu_torch.parallel.batch import BatchedGaborDetector, batched_detector_for
from das4whales_tpu_torch.utils.parity import unexplained_differences
from das4whales_tpu_torch.workflows import gabordetect as tgd
from das4whales_tpu_torch.workflows import planner
from tests.torch_threads import one_torch_thread  # noqa: F401

NOTE_ABS = 2e-5
SCORE_REL = 2e-6
CORR_REL = 1e-5
THR_REL = 1e-6
NX, NS = 128, 3000
SEL = [0, NX, 1]
KW = dict(bin_factor=0.25, threshold1=2000.0, threshold2=1.0)


def _scene(seed=0):
    """JAX's test scene: one Hann-windowed HF call with a 1500 m/s moveout
    from 400 m, on 0.02-rms noise (``tests/test_gabor.py::_scene``)."""
    rng = np.random.default_rng(seed)
    fs, dx = 200.0, 8.0
    time = np.arange(NS) / fs
    x = np.arange(NX) * dx
    call = np.asarray(jtpl.gen_template_fincall(time, fs, 17.8, 28.8, 0.68))
    data = 0.02 * rng.standard_normal((NX, NS))
    L = int(0.68 * fs)
    onsets = (5.0 + np.abs(x - 400.0) / 1500.0) * fs
    for ch in range(NX):
        s = int(onsets[ch])
        data[ch, s : s + L] += call[:L]
    return data.astype(np.float32)


def _host(v):
    if isinstance(v, dict):
        return {k: _host(a) for k, a in v.items()}
    if isinstance(v, torch.Tensor):
        return v.numpy()
    return np.array(v) if hasattr(v, "shape") else v


def _jax_fields(jdet):
    fields = convert.gabor_design_to_arrays(jdet.design)
    fields.update(note_params=jdet.note_params, max_peaks=jdet.max_peaks,
                  notes={k: np.array(v) for k, v in jdet.notes.items()})
    return fields


JMETA = AcquisitionMetadata(fs=200.0, dx=8.0, nx=NX, ns=NS)
TMETA = tcfg.AcquisitionMetadata(fs=200.0, dx=8.0, nx=NX, ns=NS)


@pytest.fixture(scope="module")
def ref():
    """JAX's detector at the test scene, its result, and the port's
    detector on JAX's design and notes."""
    data = _scene()
    with jax.enable_x64(False):
        jdet = jg.GaborDetector(JMETA, SEL, **KW)
        jres = _host(jdet(data))
        fields = _jax_fields(jdet)
    tdet = convert.gabor_detector_from_jax(fields, TMETA, device="cpu")
    return dict(data=data, jdet=jdet, jres=jres, fields=fields, tdet=tdet)


def _assert_near(ref_a, got, rel):
    assert ref_a.shape == got.shape, (ref_a.shape, got.shape)
    scale = float(np.abs(ref_a).max())
    assert scale > 0
    np.testing.assert_allclose(got, ref_a, rtol=0, atol=rel * scale)


def _knife_flips(ref_score, thr, ref_bool, got_bool):
    """``(flips, unexplained)``: pixels where the two thresholded images
    differ, and those of them where the reference's score is not within
    ``SCORE_REL * max|score|`` of ``thr``."""
    diff = ref_bool != got_bool
    edge = np.abs(ref_score - thr) <= SCORE_REL * float(np.abs(ref_score).max())
    return int(diff.sum()), int((diff & ~edge).sum())


def _assert_mask(jdesign, jscore, tscore, tmask, thr1, thr2):
    """The binary image and the mask equal up to counted knife edges: the
    port's binary against JAX's score at ``thr1``, then the port's mask
    against JAX's second score OF THE PORT'S BINARY at ``thr2`` (so a
    binary knife edge cannot hide a mask fault). Returns the flip counts."""
    tbin = tscore > thr1
    n1, bad1 = _knife_flips(jscore, thr1, jscore > thr1, tbin)
    assert bad1 == 0, f"{bad1} binary pixels flipped off the knife edge"
    with jax.enable_x64(False):
        up = jnp.asarray(jdesign.gabor_up, jnp.float32)
        down = jnp.asarray(jdesign.gabor_down, jnp.float32)
        jscore2 = np.array(jg._gabor_score(jnp.asarray(tbin.astype(np.float32)), up, down))
    n2, bad2 = _knife_flips(jscore2, thr2, jscore2 > thr2, tmask)
    assert bad2 == 0, f"{bad2} mask pixels flipped off the knife edge"
    return n1, n2


def _assert_picks(jpicks, tpicks, tcorr, thresholds):
    total = 0
    for name, b in tpicks.items():
        a = np.asarray(jpicks[name])
        assert b.dtype == np.int64 and b.shape[0] == 2
        env = spectral.envelope_sqrt(torch.as_tensor(tcorr[name])).numpy()
        bad = unexplained_differences(a, b, env, thresholds[name])
        assert not bad, f"{name}: picks differ beyond rounding at {bad[:10]}"
        total += b.shape[1]
    assert total > 0, "parity over an empty pick set proves nothing"


# ---------------------------------------------------------------- design


def test_design_equals_jax_and_notes_within_tolerance(ref):
    jdet = ref["jdet"]
    own = tg.GaborDetector(TMETA, SEL, device="cpu", **KW)
    for f in ("theta_c0", "bin_factor", "threshold1", "threshold2"):
        assert getattr(own.design, f) == getattr(jdet.design, f)
    np.testing.assert_array_equal(own.design.gabor_up, jdet.design.gabor_up)
    np.testing.assert_array_equal(own.design.gabor_down, jdet.design.gabor_down)
    assert own.design.gabor_up.shape == (101, 101)
    assert own.note_params == jdet.note_params
    for name, note in ref["fields"]["notes"].items():
        got = own.notes[name].numpy()
        assert got.dtype == np.float32 and got.shape == note.shape
        np.testing.assert_allclose(got, note, rtol=0, atol=NOTE_ABS)


def test_convert_carries_design_and_notes_both_ways(ref):
    fields, tdet = ref["fields"], ref["tdet"]
    for name, note in fields["notes"].items():
        np.testing.assert_array_equal(tdet.notes[name].numpy(), note)
    back = convert.gabor_detector_to_arrays(tdet)
    with jax.enable_x64(False):
        jdesign = jg.GaborDesign(**convert.gabor_design_to_arrays(tdet.design))
    np.testing.assert_array_equal(jdesign.gabor_up, ref["jdet"].design.gabor_up)
    again = convert.gabor_detector_from_jax(back, TMETA, device="cpu")
    a, b = tdet(ref["data"]), again(ref["data"])
    assert a["thresholds"] == b["thresholds"]
    for name in a["picks"]:
        np.testing.assert_array_equal(a["picks"][name], b["picks"][name])
    with pytest.raises(KeyError, match="gabor detector fields missing"):
        convert.gabor_detector_from_jax({"gabor_up": 1}, TMETA, device="cpu")


# ---------------------------------------------------------------- stages


@pytest.mark.parametrize("pct1, pct2", [(98.0, 60.0), (90.0, 85.0)])
def test_gabor_mask_matches_jax_on_a_partial_mask(ref, pct1, pct2):
    """Data-driven thresholds (as JAX's own mask test sets them) that leave
    a partial mask, so the mask comparison means something."""
    data, jdet = ref["data"], ref["jdet"]
    with jax.enable_x64(False):
        design = jg.GaborDesign(jdet.design.gabor_up, jdet.design.gabor_down,
                                jdet.design.theta_c0, 0.25, 0.0, 0.0)
        img = jg.img_ops.binning(jg.img_ops.trace2image(jnp.asarray(data)), 0.25, 0.25)
        up = jnp.asarray(design.gabor_up, jnp.float32)
        down = jnp.asarray(design.gabor_down, jnp.float32)
        s1 = np.array(jg._gabor_score(img, up, down))
        design.threshold1 = float(np.percentile(s1, pct1))
        s2 = np.array(jg._gabor_score(jnp.asarray((s1 > design.threshold1).astype(np.float32)),
                                      up, down))
        design.threshold2 = float(np.percentile(s2, pct2))
        jscore, jmask, jmasked = (np.array(v) for v in jg.gabor_mask(jnp.asarray(data), design))
    assert 0 < jmask.sum() < jmask.size
    tdesign = convert.gabor_design_from_arrays(convert.gabor_design_to_arrays(design))
    tscore, tmask, tmasked = (v.numpy() for v in tg.gabor_mask(torch.from_numpy(data), tdesign))
    _assert_near(jscore, tscore, SCORE_REL)
    _assert_mask(design, jscore, tscore, tmask, design.threshold1, design.threshold2)
    if np.array_equal(tmask, jmask):
        _assert_near(jmasked, tmasked, CORR_REL)


def test_masked_matched_filter_matches_jax_and_scipy():
    rng = np.random.default_rng(3)
    x = np.abs(rng.standard_normal((6, 500))).astype(np.float32)
    x[2] = 0.0                               # a fully masked channel stays zero
    x[4] = -x[4]                             # and so does one with no positive sample
    for m in (81, 80, 1):
        note = rng.standard_normal(m).astype(np.float32)
        with jax.enable_x64(False):
            want = np.array(jg.masked_matched_filter(jnp.asarray(x), jnp.asarray(note)))
        got = tg.masked_matched_filter(torch.from_numpy(x), torch.from_numpy(note)).numpy()
        _assert_near(want, got, CORR_REL)
        assert not got[2].any() and not got[4].any()
        for i in (0, 1, 3, 5):
            sc = sp.correlate(x[i] / x[i].max(), note, mode="same", method="direct")
            np.testing.assert_allclose(got[i], sc, rtol=0, atol=CORR_REL * np.abs(sc).max())


# ---------------------------------------------------------------- detector


def test_detector_call_matches_jax(ref):
    jres, tres = ref["jres"], ref["tdet"](ref["data"])
    assert set(tres) == set(jres)
    _assert_near(jres["score"], tres["score"].numpy(), SCORE_REL)
    n1, n2 = _assert_mask(ref["jdet"].design, jres["score"], tres["score"].numpy(),
                          tres["mask"].numpy(), KW["threshold1"], KW["threshold2"])
    assert (n1, n2) == (0, 0)                # none on this scene (every flip would be explained)
    _assert_near(jres["masked_trace"], tres["masked_trace"].numpy(), CORR_REL)
    for name in jres["correlograms"]:
        _assert_near(jres["correlograms"][name], tres["correlograms"][name].numpy(), CORR_REL)
        np.testing.assert_allclose(tres["thresholds"][name], jres["thresholds"][name],
                                   rtol=THR_REL)
    np.testing.assert_allclose(tres["threshold"], jres["threshold"], rtol=THR_REL)
    assert tres["thresholds"]["HF"] == tres["threshold"] * 0.9
    _assert_picks(jres["picks"], tres["picks"], _host(tres["correlograms"]), tres["thresholds"])


def test_absolute_threshold_override_matches_jax(ref):
    with jax.enable_x64(False):
        jres = _host(ref["jdet"](ref["data"], threshold=6.0))
    tres = ref["tdet"](ref["data"], threshold=6.0)
    assert tres["threshold"] == jres["threshold"] == 6.0
    assert tres["thresholds"] == jres["thresholds"] == {"HF": 6.0, "LF": 6.0}
    _assert_picks(jres["picks"], tres["picks"], _host(tres["correlograms"]), tres["thresholds"])


def test_engine_resolution_and_conv_engine(ref, monkeypatch):
    det = tg.GaborDetector(TMETA, SEL, device="cpu", **KW)
    assert det.resolve_engine((NX, NS)) == "fft"
    # the default is the FFT route, forced; "auto" runs the A/B router,
    # which off a CUDA device is the FFT route with the JAX package's reason
    assert det.gabor_engine_reason == "forced"
    auto = tg.GaborDetector(TMETA, SEL, device="cpu", gabor_engine="auto")
    assert auto.resolve_engine((NX, NS)) == "fft"
    assert "'cpu'" in auto.gabor_engine_reason and "no MXU" in auto.gabor_engine_reason
    monkeypatch.setenv("DAS_GABOR_ENGINE", "conv")
    conv = convert.gabor_detector_from_jax(ref["fields"], TMETA, device="cpu")
    assert conv.resolve_engine() == "conv" and conv.gabor_engine_reason == "forced"
    a, b = ref["tdet"](ref["data"]), conv(ref["data"])
    _assert_near(a["score"].numpy(), b["score"].numpy(), 1e-5)
    monkeypatch.setenv("DAS_GABOR_ENGINE", "matmul")
    with pytest.raises(ValueError, match="unknown gabor engine"):
        tg.GaborDetector(TMETA, SEL, device="cpu")
    forced = tg.GaborDetector(TMETA, SEL, device="cpu", gabor_engine="fft")
    assert forced.resolve_engine() == "fft" and forced.gabor_engine_reason == "forced"


def test_stage_hook_counters_and_host_view(ref):
    det = convert.gabor_detector_from_jax(ref["fields"], TMETA, device="cpu")
    names = []
    det(ref["data"], stage_hook=names.append)
    assert names == ["trace2image", "binning", "score", "mask", "smooth", "masked_mf", "picks"]
    # the max, then per note a saturation check and a packed fetch
    assert det.syncs == 5 and det.escalations == 0
    view = det.host_view()
    assert view is det.host_view() and view.device == torch.device("cpu")
    a, b = det(ref["data"]), view(ref["data"])
    for name in a["picks"]:
        np.testing.assert_array_equal(a["picks"][name], b["picks"][name])


def test_escalation_reruns_and_matches_scipy(ref):
    """At a low absolute threshold the rows hold more than K0 = 64 peaks:
    one ``topk`` rerun at ``max_peaks`` per note, and the picks equal
    scipy's ``find_peaks`` on the port's envelope."""
    det = convert.gabor_detector_from_jax(ref["fields"], TMETA, device="cpu")
    corr = det.correlograms(ref["data"])[3]
    picks, _, thresholds = det.picks_from_correlograms(corr, threshold=0.05)
    assert det.escalations == 2
    for name, c in corr.items():
        env = spectral.envelope_sqrt(c).numpy()
        want = tg.peak_ops.find_peaks_scipy_host(env, thresholds[name])
        np.testing.assert_array_equal(picks[name], want)
        assert picks[name].shape[1] > 64 * 1
    with pytest.warns(UserWarning, match="saturated"):
        convert.gabor_detector_from_jax(dict(ref["fields"], max_peaks=1), TMETA,
                                        device="cpu").picks_from_correlograms(corr, threshold=0.05)


# ---------------------------------------------------------------- family


def _adapters(ref):
    """JAX's adapter (its MF prefilter at the scene's shape) and the
    port's on the same prefilter design and Gabor design and notes."""
    with jax.enable_x64(False):
        jmf = JaxMF(JMETA, SEL, (NX, NS), mf_engine="fft", fk_engine="fft")
        jad = jeval.GaborEvalAdapter(jmf, ref["jdet"])
    tmf = MatchedFilterDetector.from_design(
        convert.design_from_arrays({f: getattr(jmf.design, f) for f in convert.DESIGN_FIELDS}),
        TMETA, device="cpu")
    return jad, GaborEvalAdapter(tmf, ref["tdet"])


def _strain(seed):
    """A conditioned block for the prefilter: the scene as strain."""
    return (_scene(seed) * 1e-9).astype(np.float32)


def test_eval_adapter_matches_jax(ref):
    jad, tad = _adapters(ref)
    assert tad.template_configs == jad.template_configs == {
        "HF": {"f0": 28.8, "f1": 17.8, "dur": 0.68}, "LF": {"f0": 21.8, "f1": 14.7, "dur": 0.78}}
    block = _strain(0)
    with jax.enable_x64(False):
        jr = jad(block)
    names = []
    tr = tad(block, stage_hook=names.append)
    assert names[0] == "prefilter" and names[-1] == "picks"
    trf = tad.prefilter.filter_block(block)
    corr = _host(tad.det.correlograms(trf)[3])
    for name in tr.thresholds:
        np.testing.assert_allclose(tr.thresholds[name], jr.thresholds[name], rtol=THR_REL)
    _assert_picks(jr.picks, tr.picks, corr, tr.thresholds)


def test_batched_facade_serial_is_bitwise_the_per_file_route(ref):
    _, tad = _adapters(ref)
    stack = np.stack([_strain(s) for s in (0, 1, 2)])
    per_file = [tad(stack[b]) for b in range(3)]
    bd = batched_detector_for(tad)
    assert isinstance(bd, BatchedGaborDetector) and bd.serial and bd.family == "gabor"
    assert bd._trace_shape == (NX, NS)
    out = bd.detect_batch(stack, n_valid=3, with_health=True)
    assert len(out) == 3
    for b, (picks, thr, health) in enumerate(out):
        assert thr == per_file[b].thresholds
        for name in picks:
            np.testing.assert_array_equal(picks[name], per_file[b].picks[name])
        assert health["nonfinite"] == 0
    # the batched mode: every stage over the file axis, each file its own scale
    bb = BatchedGaborDetector(tad, serial=False)
    heavy = bb._heavy(torch.from_numpy(stack))
    for b, (picks, thr) in enumerate(bb.detect_batch(stack)):
        for name in thr:
            np.testing.assert_allclose(thr[name], per_file[b].thresholds[name], rtol=THR_REL)
        _assert_picks(per_file[b].picks, picks, {k: v[b] for k, v in heavy.items()}, thr)
    with pytest.raises(ValueError, match="one batched detector serves one bucket"):
        bd.detect_batch(np.zeros((2, NX, NS - 1), np.float32))


def test_planner_program_and_ladder_stages(ref):
    _, tad = _adapters(ref)
    prog = planner.program_for(tad)
    assert isinstance(prog, planner.GaborProgram) and prog.family == "gabor"
    assert prog.stages == ("file", "host") and prog.supports_batched
    assert planner.FAMILY_PROGRAMS["gabor"] is planner.GaborProgram
    assert planner.family_ladder_stages("gabor") == ("batched", "file", "host")
    block = _strain(1)
    tr = tad(block)
    host = prog._det_at("host")
    assert host is tad.host_view() and host.det is tad.det.host_view()
    assert host.det.device.type == "cpu" and host.prefilter.device.type == "cpu"
    for rung in (("file", 1), ("host", 1)):
        picks, thr, stats = prog.detect(rung, block, with_health=True)
        assert thr == tr.thresholds and stats["nonfinite"] == 0
        for name in picks:
            np.testing.assert_array_equal(picks[name], tr.picks[name])
    assert prog.engines == {"gabor_engine": "fft"}


def test_campaign_detector_matches_jax():
    block = _strain(2)
    kw = dict(bin_factor=0.25, threshold1=2000.0, threshold2=1.0)
    with jax.enable_x64(False):
        jad = jgd.campaign_detector(JMETA, SEL, (NX, NS), **kw)
        jr = jad(block)
    tad = tgd.campaign_detector(TMETA, SEL, (NX, NS), device="cpu", **kw)
    assert isinstance(tad, GaborEvalAdapter) and tad.det.device.type == "cpu"
    assert tad.template_configs == jad.template_configs
    np.testing.assert_array_equal(tad.det.design.gabor_up, jad.det.design.gabor_up)
    tr = tad(block)
    corr = _host(tad.det.correlograms(tad.prefilter.filter_block(block))[3])
    for name in tr.thresholds:
        np.testing.assert_allclose(tr.thresholds[name], jr.thresholds[name], rtol=1e-5)
    _assert_picks(jr.picks, tr.picks, corr, tr.thresholds)


# ---------------------------------------------------------------- main


MAIN_CHANNELS_M = (0.0, 160 * 2.042, 2.042)
MAIN_KW = dict(bin_factor=0.25, threshold1=1500.0, threshold2=1.0)


def test_gabordetect_main_matches_jax(tmp_path, monkeypatch):
    """Both mains on the offline scene (``acquire(None)``), the first 160
    channels, at thresholds that keep a mask there (the reference's 9100 /
    150 are set on OOI data)."""
    monkeypatch.chdir(tmp_path)
    with jax.enable_x64(False):
        block, meta, sel = jgd.acquire(None, selected_channels_m=MAIN_CHANNELS_M)
        jdet = jg.GaborDetector(meta.with_shape(*block.trace.shape), sel, **MAIN_KW)
        jr = _host(jdet(JaxMF(meta, sel, tuple(block.trace.shape)).filter_block(block.trace)))
    tr = tgd.main(None, selected_channels_m=MAIN_CHANNELS_M, device="cpu", **MAIN_KW)
    assert set(tr) == set(jr) | {"trf_fk", "block", "figures", "timings"}
    assert tr["figures"] == {} and set(tr["timings"]) == {"acquire", "design", "detect"}
    assert tr["mask"].any()
    for name in tr["thresholds"]:
        np.testing.assert_allclose(tr["thresholds"][name], jr["thresholds"][name], rtol=1e-5)
    _assert_picks(jr["picks"], tr["picks"], _host(tr["correlograms"]), tr["thresholds"])


def test_entry_points_take_the_card_by_default(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tg.GaborDetector(TMETA, SEL)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tgd.campaign_detector(TMETA, SEL, (NX, NS))
    with pytest.raises(RuntimeError, match="CUDA device"):
        tgd.main(None)
