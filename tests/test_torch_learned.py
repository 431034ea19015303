"""Port parity, the learned CNN family: ``models.learned``, the parameter
conversion, ``BatchedLearnedDetector``, the planner program and the
trainer of das4whales_tpu_torch (on the CPU) against das4whales_tpu's
(float32, x64 off).

The scenes are JAX's own (``tests/test_learned.py``: 32 x 3000 at 8 m,
noise 0.08; the held-out 96 x 5000 scene, seed 77, for the pretrained
model). Contract:

* window features within ``FEAT_ABS`` (standardised units) of JAX's, for
  the rFFT engine on both sides and for the port's ``"fused"`` engine
  (the kernel's plain version here) against JAX's Pallas kernel in
  interpret mode: a log of a float32 STFT magnitude, standardised,
  amplifies the STFT's rounding in the quiet bins; centers equal;
* logits on identical windows and parameters within ``LOGIT_REL *
  max|logit|``;
* detector scores within ``SCORE_ABS``; picks equal, or every pick in
  the symmetric difference on a knife edge of the port's scores
  (``utils.parity.unexplained_learned_differences``);
* the pretrained model's recall on the held-out scene at least 0.9;
* parameter files saved by either package load in the other, bitwise;
* AdamW against ``optax.adamw`` on identical batches: losses within
  ``LOSS_REL``, parameters within ``PARAM_ABS``; ``fit``'s history within
  ``FIT_REL`` (the packages' features differ by their STFT engines).

Within the port: the tiled view, the batched facade's batched mode and
its chunked CNN passes change scores by at most ``CHUNK_ABS`` (the CPU's
convolution picks its algorithm by batch size), picks up to knife edges;
the serial facade is bitwise the per-file call.
"""

from __future__ import annotations

import dataclasses
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from das4whales_tpu import eval as jeval
from das4whales_tpu.io.synth import SyntheticCall, SyntheticScene, synthesize_scene
from das4whales_tpu.models import learned as jl
from das4whales_tpu.workflows import planner as jplanner
from das4whales_tpu_torch import convert, faults
from das4whales_tpu_torch.models import learned as tl
from das4whales_tpu_torch.parallel import batch as tbatch
from das4whales_tpu_torch.utils.parity import unexplained_learned_differences
from das4whales_tpu_torch.workflows import campaign as tcampaign
from das4whales_tpu_torch.workflows import planner as tplanner

FEAT_ABS = 2e-3
LOGIT_REL = 1e-5
SCORE_ABS = 1e-4
CHUNK_ABS = 1e-6
LOSS_REL = 1e-5
PARAM_ABS = 1e-5
FIT_REL = 1e-3
KNIFE = 1e-4

CFG = tl.LearnedConfig()
JCFG = jl.LearnedConfig()


def _scene(seed, amps, nx=32, ns=3000):
    """JAX's test scene (tests/test_learned.py)."""
    calls = [SyntheticCall(t0=3.0 + 4.5 * k, x0_m=100.0 + 60 * k, amplitude=a)
             for k, a in enumerate(amps)]
    return SyntheticScene(nx=nx, ns=ns, dx=8.0, noise_rms=0.08, calls=calls, seed=seed)


def _block(scene):
    return synthesize_scene(scene).astype(np.float32)


@pytest.fixture(scope="module")
def pretrained():
    with jax.enable_x64(False):
        jp, jcfg = jl.load_pretrained()
    model, cfg = tl.load_pretrained()
    return jp, jcfg, model, cfg


def _assert_picks(jres, tres, name="CALL"):
    """Picks equal, or every difference on a knife edge of the port's
    scores; returns the number of picks."""
    bad = unexplained_learned_differences(jres.picks[name], tres.picks[name], tres.scores,
                                          tres.centers, tres.thresholds[name], KNIFE)
    assert not bad, f"picks differ beyond rounding at {bad}"
    return tres.picks[name].shape[1]


@pytest.mark.parametrize("engine,jax_engine", [("rfft", "rfft"), ("fused", "pallas")])
def test_window_features_match_jax(engine, jax_engine):
    block = _block(_scene(0, [1.0]))
    with jax.enable_x64(False):
        jw, jc = jl.window_features(block, JCFG, engine=jax_engine)
        jw = np.array(jw)
    tw, tc = tl.window_features(block, CFG, engine=engine, device="cpu")
    assert tw.shape == jw.shape == (32, 22, 32, 8)
    np.testing.assert_array_equal(tc, jc)
    np.testing.assert_allclose(tw.numpy(), jw, rtol=0, atol=FEAT_ABS)


def test_window_features_of_a_record_shorter_than_a_window():
    block = _block(_scene(0, [], ns=200))
    with jax.enable_x64(False):
        jw, jc = jl.window_features(block, JCFG, engine="rfft")
    tw, tc = tl.window_features(block, CFG, engine="rfft", device="cpu")
    assert tuple(tw.shape) == tuple(jw.shape) == (32, 0, 32, 8)
    assert len(tc) == len(jc) == 0


@pytest.mark.parametrize("shape", [(32, 8), (31, 7), (9, 4)], ids=lambda s: "x".join(map(str, s)))
def test_cnn_logits_match_jax(pretrained, shape):
    """Identical windows and parameters: even map sizes take XLA's
    asymmetric SAME padding (nothing before, one after), odd ones one on
    each side; GELU is the tanh form. Trained and initial parameters."""
    jp, _, model, _ = pretrained
    rng = np.random.default_rng(11)
    win = rng.standard_normal((257, *shape)).astype(np.float32)
    init = _init_params(5)
    with jax.enable_x64(False):
        want = [np.array(jl.cnn_logits(jp, jnp.asarray(win))),
                np.array(jl.cnn_logits(init, jnp.asarray(win)))]
    models = [model, convert.learned_params_from_arrays(
        {k: {kk: np.array(v) for kk, v in sub.items()} for k, sub in init.items()},
        {"features": CFG.features})]
    for m, w in zip(models, want):
        with torch.no_grad():
            got = tl.cnn_logits(m, torch.from_numpy(win)).numpy()
        np.testing.assert_allclose(got, w, rtol=0, atol=LOGIT_REL * np.abs(w).max())


def _init_params(seed):
    with jax.enable_x64(False):
        return jl._init_cnn_params(np.random.default_rng(seed), JCFG)


def test_initial_parameters_are_jax_draws():
    want = _init_params(3)
    got = tl._init_cnn_params(np.random.default_rng(3), CFG)
    back = convert.learned_params_to_arrays(convert.learned_params_from_arrays(
        got, {"features": CFG.features}))
    for k in want:
        for kk in want[k]:
            np.testing.assert_array_equal(got[k][kk], np.array(want[k][kk]))
            np.testing.assert_array_equal(back[k][kk], np.array(want[k][kk]))
            assert back[k][kk].shape == np.shape(want[k][kk])


@pytest.mark.parametrize("amps", [[0.8, 0.7], [0.9], []], ids=["two_calls", "one_call", "quiet"])
def test_detector_scores_and_picks_match_jax(pretrained, amps):
    jp, jcfg, model, cfg = pretrained
    block = _block(_scene(99, amps))
    with jax.enable_x64(False):
        jres = jl.LearnedDetector(jp, jcfg, threshold=0.5)(block)
    det = tl.LearnedDetector(model, cfg, threshold=0.5, device="cpu")
    tres = det(block)
    assert det.syncs == 1
    np.testing.assert_array_equal(tres.centers, jres.centers)
    np.testing.assert_allclose(tres.scores, jres.scores, rtol=0, atol=SCORE_ABS)
    assert tres.thresholds == jres.thresholds == {"CALL": 0.5}
    n = _assert_picks(jres, tres)
    assert (n > 0) == bool(amps)


def test_pretrained_model_detects_the_held_out_scene(pretrained):
    """JAX's held-out scene for the shipped model (96 x 5000, seed 77),
    scored by JAX's own evaluation harness."""
    _, _, model, cfg = pretrained
    det = tl.LearnedDetector(model, cfg, threshold=0.5, device="cpu")
    scene = SyntheticScene(nx=96, ns=5000, dx=2.042, noise_rms=0.05, seed=77,
                           calls=[SyntheticCall(t0=5.0, x0_m=100.0, amplitude=0.7)])
    with jax.enable_x64(False):
        m = jeval.evaluate_detector(det, scene, time_tol_s=1.0)["CALL"]
    assert m["recall"] >= 0.9
    assert m["false_per_channel_minute"] < 0.5
    with pytest.raises(FileNotFoundError):
        tl.load_pretrained("nope")


def test_params_files_load_in_either_package(pretrained, tmp_path):
    jp, jcfg, model, cfg = pretrained
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert filecmp.cmp(os.path.join(root, "das4whales_tpu/models/pretrained/fin_cnn.npz"),
                       os.path.join(root, "das4whales_tpu_torch/models/pretrained/fin_cnn.npz"),
                       shallow=False)
    bf16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    port_file = tl.save_params(str(tmp_path / "port_model"), model, bf16)
    assert port_file.endswith(".npz")
    with jax.enable_x64(False):
        jp2, jcfg2 = jl.load_params(port_file)
        jax_file = jl.save_params(str(tmp_path / "jax_model.npz"), jp, jcfg)
    assert dataclasses.asdict(jcfg2) == dataclasses.asdict(bf16)
    m2, cfg2 = tl.load_params(jax_file)
    assert dataclasses.asdict(cfg2) == dataclasses.asdict(jcfg)
    m3, cfg3 = tl.load_params(port_file)
    assert cfg3 == bf16
    want = {k: {kk: np.array(v) for kk, v in sub.items()} for k, sub in jp.items()}
    for tree in (jp2, convert.learned_params_to_arrays(m2), convert.learned_params_to_arrays(m3)):
        for k in want:
            for kk in want[k]:
                got = np.asarray(tree[k][kk])
                assert got.dtype == np.float32 and got.shape == want[k][kk].shape
                np.testing.assert_array_equal(got, want[k][kk])
    # JAX's pytree itself is a detector's params, as in the JAX package
    block = _block(_scene(99, [0.8]))
    a = tl.LearnedDetector(want, cfg, device="cpu")(block)
    b = tl.LearnedDetector(m2, cfg2, device="cpu")(block)
    np.testing.assert_array_equal(a.scores, b.scores)


def test_tiled_and_host_views(pretrained):
    _, _, model, cfg = pretrained
    det = tl.LearnedDetector(model, cfg, device="cpu")
    tv = det.tiled_view()
    assert tv is det.tiled_view() and tv.row_chunk == 4096 and det.row_chunk is None
    assert tl.LearnedDetector(model, cfg, row_chunk=300, device="cpu").tiled_view().row_chunk == 256
    assert tl.LearnedDetector(model, cfg, row_chunk=256, device="cpu").tiled_view().row_chunk == 256
    hv = det.host_view()
    assert hv is det.host_view() and hv.device == torch.device("cpu")
    assert hv.model is not det.model
    block = _block(_scene(99, [0.8, 0.7]))
    ref = det(block)
    small = tl.LearnedDetector(model, cfg, row_chunk=100, device="cpu")
    for view in (small, small.tiled_view(), hv):
        got = view(block)
        np.testing.assert_allclose(got.scores, ref.scores, rtol=0, atol=CHUNK_ABS)
        _assert_picks(ref, got)
    with jax.enable_x64(False):
        assert tplanner.family_ladder_stages("learned") == jplanner.family_ladder_stages("learned")
    prog = tplanner.program_for(det)
    assert isinstance(prog, tplanner.LearnedProgram) and prog.family == "learned"
    assert prog.stages == ("file", "tiled", "host") and prog.supports_batched
    assert prog._det_at("tiled") is tv and prog._det_at("host") is hv
    assert prog._det_at("file") is det and prog.dispatch(block) is None


def test_batched_facade_serial_and_batched(pretrained, monkeypatch):
    _, _, model, cfg = pretrained
    det = tl.LearnedDetector(model, cfg, device="cpu")
    blocks = [_block(_scene(s, [0.8, 0.6])) for s in (21, 22, 23)]
    refs = [det(b) for b in blocks]
    stack = torch.from_numpy(np.stack(blocks))
    serial = tbatch.batched_detector_for(det, serial=True, trace_shape=(32, 3000))
    assert isinstance(serial, tbatch.BatchedLearnedDetector)
    assert serial.family == "learned" and serial.engine == "fused"
    det.syncs = 0
    out = serial.detect_batch(stack, with_health=True)
    assert det.syncs == 1 and len(out) == 3
    for (picks, thr, stats), ref, blk in zip(out, refs, blocks):
        np.testing.assert_array_equal(picks["CALL"], ref.picks["CALL"])
        assert thr == ref.thresholds
        assert stats["nonfinite"] == 0 and stats["clipped"] == 0
    batched = tbatch.BatchedLearnedDetector(det, serial=False, trace_shape=(32, 3000))
    with pytest.raises(ValueError, match="one batched detector serves one bucket"):
        batched.detect_batch(stack[:, :, :2000])
    for rows in (tbatch.LEARNED_BATCH_ROWS, 100):
        monkeypatch.setattr(tbatch, "LEARNED_BATCH_ROWS", rows)
        heavy = batched._fetch(batched._heavy(stack[:2]))
        for b in range(2):
            np.testing.assert_allclose(heavy[b], refs[b].scores, rtol=0, atol=CHUNK_ABS)
        out = batched.detect_batch(stack, n_valid=2)
        assert len(out) == 2
        for (picks, _), ref in zip(out, refs):
            bad = unexplained_learned_differences(ref.picks["CALL"], picks["CALL"], ref.scores,
                                                  ref.centers, 0.5, KNIFE)
            assert not bad


def test_family_detector_builds_the_learned_detector(pretrained):
    _, _, model, cfg = pretrained
    meta = _scene(0, []).metadata
    det = tcampaign.family_detector("learned", meta, [0, 32, 1], (32, 3000), device="cpu",
                                    threshold=0.7)
    assert isinstance(det, tl.LearnedDetector) and det.threshold == 0.7
    assert det.cfg == cfg
    own = tcampaign.family_detector("learned", meta, [0, 32, 1], (32, 3000), device="cpu",
                                    params=model, cfg=cfg, name="FIN")
    assert own.name == "FIN" and own.model is not model
    with pytest.raises(FileNotFoundError):
        tcampaign.family_detector("learned", meta, [0, 32, 1], (32, 3000), device="cpu",
                                  pretrained="nope")
    if not torch.cuda.is_available():
        # the card by default, never a silent CPU run
        with pytest.raises(RuntimeError, match="CUDA device"):
            tl.LearnedDetector(model, cfg)


def test_bf16_compute_matches_f32_decisions(pretrained):
    """JAX's bf16 test, on the port: scores within 0.05 of float32's and
    the clear call's channel picked by both."""
    _, _, model, cfg = pretrained
    scene = _scene(99, [0.9])
    block = _block(scene)
    r32 = tl.LearnedDetector(model, cfg, threshold=0.5, device="cpu")(block)
    r16 = tl.LearnedDetector(model, dataclasses.replace(cfg, compute_dtype="bfloat16"),
                             threshold=0.5, device="cpu")(block)
    np.testing.assert_allclose(r16.scores, r32.scores, atol=0.05)
    ch = int(round(100.0 / scene.dx))
    assert ch in r16.picks["CALL"][0] and ch in r32.picks["CALL"][0]
    with pytest.raises(ValueError, match="compute_dtype"):
        tl.cnn_logits(model, torch.zeros((1, 32, 8)), "float16")


def test_train_step_matches_optax():
    """Five AdamW steps from JAX's initial parameters on identical
    batches: the losses and the parameters of both packages agree."""
    import optax

    scene = _scene(7, [0.9])
    with jax.enable_x64(False):
        win, centers = jl.window_features(_block(scene), JCFG, engine="rfft")
        lab = jl.window_labels(scene, np.asarray(centers), JCFG)
        x = np.array(win).reshape(-1, 32, 8)
        y = np.asarray(lab).reshape(-1)
        params, opt_state, tx = jl.init_train_state(JCFG, seed=3)
        jlosses = []
        for s in range(5):
            sl = slice(128 * s, 128 * (s + 1))
            params, opt_state, loss = jl.train_step(params, opt_state, tx, jnp.asarray(x[sl]),
                                                    jnp.asarray(y[sl]))
            jlosses.append(float(loss))
        params = {k: {kk: np.array(v) for kk, v in sub.items()} for k, sub in params.items()}
    assert isinstance(tx, optax.GradientTransformation)
    model, opt = tl.init_train_state(CFG, seed=3, device="cpu")
    assert isinstance(opt, torch.optim.AdamW)
    g = opt.param_groups[0]
    assert (g["lr"], g["betas"], g["eps"], g["weight_decay"]) == (1e-2, (0.9, 0.999), 1e-8, 1e-4)
    tlosses = []
    for s in range(5):
        sl = slice(128 * s, 128 * (s + 1))
        model, opt, loss = tl.train_step(model, opt, torch.from_numpy(x[sl]),
                                         torch.from_numpy(y[sl]))
        tlosses.append(float(loss))
    np.testing.assert_allclose(tlosses, jlosses, rtol=LOSS_REL)
    got = convert.learned_params_to_arrays(model)
    for k in params:
        for kk in params[k]:
            np.testing.assert_allclose(got[k][kk], params[k][kk], rtol=0, atol=PARAM_ABS)


def test_fit_matches_jax_and_detects_a_held_out_scene():
    """``fit`` on JAX's two training scenes: the same pooling, rebalancing
    and batch order, so the loss history follows JAX's; the trained model
    finds JAX's held-out scene's calls (JAX's own test holds it to recall
    0.8)."""
    train = [_scene(s, [0.6, 0.9]) for s in range(2)]
    with jax.enable_x64(False):
        _, jhist = jl.fit(JCFG, train, epochs=25, batch=512, seed=0)
    model, hist = tl.fit(CFG, train, epochs=25, batch=512, seed=0, device="cpu")
    assert len(hist) == 25
    np.testing.assert_allclose(hist, jhist, rtol=FIT_REL)
    assert hist[-1] < 0.1 and hist[-1] < hist[0] * 0.3
    det = tl.LearnedDetector(model, CFG, threshold=0.5, device="cpu")
    with jax.enable_x64(False):
        m = jeval.evaluate_detector(det, _scene(99, [0.8, 0.7]), time_tol_s=1.0)["CALL"]
    assert m["recall"] >= 0.8
    assert m["false_per_channel_minute"] < 0.5


def test_window_labels_match_jax():
    scene = _scene(0, [1.0, 0.5])
    centers = tl.window_centers(22, CFG)
    with jax.enable_x64(False):
        want = jl.window_labels(scene, centers, JCFG)
    np.testing.assert_array_equal(tl.window_labels(scene, centers, CFG), want)
    from das4whales_tpu_torch.eval import arrival_times

    for call in scene.calls:
        np.testing.assert_array_equal(arrival_times(call, scene), jeval.arrival_times(call, scene))


def test_sharded_entries_and_cudnn_allocation_failures():
    for fn in (lambda: tl.make_sharded_train_step(None), lambda: tl.make_sharded_inference(
            None, CFG, None), lambda: tl.fit(CFG, [], mesh=object(), device="cpu")):
        with pytest.raises(NotImplementedError, match="Multi-GPU"):
            fn()
    # cuDNN's workspace allocation, by text, moves the ladder like cuFFT's
    assert faults.classify_failure(
        RuntimeError("cuDNN error: CUDNN_STATUS_ALLOC_FAILED")) == "resource"
    assert faults.classify_failure(torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 8.40 GiB (in cudnn_convolution)")) == "resource"
