"""Port parity, the whole slice: ``MatchedFilterDetector.detect_picks`` of
das4whales_tpu_torch (on the CPU) against das4whales_tpu's (float32, x64
off; ``pick_mode="sparse"``, ``mf_engine="fft"``, ``fk_engine="fft"`` set
explicitly, since on a CPU ``"auto"`` resolves to host scipy).

Both detectors run on one and the same design: the JAX design is carried
across with ``convert.design_from_arrays`` and the port's detector built
with ``MatchedFilterDetector.from_design``. Contract: thresholds to rtol
1e-5; pick sets equal, or every pick in the symmetric difference sits on
a rounding knife edge (``utils.parity.unexplained_differences``: its
height or prominence within 1e-5 relative of the threshold, or a
neighbour tied within 1e-5) — pocketfft and XLA's FFT round differently.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest

from das4whales_tpu import config as jcfg
from das4whales_tpu.io.synth import SyntheticCall, SyntheticScene, synthesize_scene, to_raw_counts
from das4whales_tpu.models import templates as jtpl
from das4whales_tpu.models.matched_filter import MatchedFilterDetector as JaxDetector
from das4whales_tpu_torch import convert
from das4whales_tpu_torch.models.matched_filter import InFlightResult
from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector as TorchDetector
from das4whales_tpu_torch.utils.parity import envelopes, unexplained_differences
from tests.torch_threads import one_torch_thread  # noqa: F401

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
    cond = ((raw - raw.mean(axis=1, keepdims=True)) * scene.metadata.scale_factor).astype(np.float32)
    return scene, {"raw": raw, "conditioned": cond}


@pytest.fixture(scope="module")
def scenes():
    return {"small": _scene(24, 900, 0), "med": _scene(64, 3000, 1)}


def _pair(scenes, size, wire, bank, tile, x=None, **kw):
    """(jax detector, jax result, torch detector, torch result, input)."""
    scene, blocks = scenes[size]
    x = blocks[wire] if x is None else x
    shape = (scene.nx, scene.ns)
    jk = {k: v for k, v in kw.items() if k in ("pick_pack_cap",)}
    with jax.enable_x64(False):
        jd = JaxDetector(scene.metadata, [0, scene.nx, 1], shape, templates=bank,
                         channel_tile=tile, wire=wire, pick_mode="sparse",
                         keep_correlograms=False, mf_engine="fft", fk_engine="fft", **jk)
        if "pick_k0" in kw:
            jd.pick_k0 = kw["pick_k0"]
        jr = jd.detect_picks(x, n_real=kw.get("n_real"))
    design = convert.design_from_arrays({f: getattr(jd.design, f) for f in convert.DESIGN_FIELDS})
    td = TorchDetector.from_design(design, scene.metadata, channel_tile=tile, wire=wire,
                                   device="cpu", **jk)
    if "pick_k0" in kw:
        td.pick_k0 = kw["pick_k0"]
    tr = td.detect_picks(x, n_real=kw.get("n_real"))
    return jd, jr, td, tr, x


def _assert_parity(jr, tr, td, x):
    assert list(jr.picks) == list(tr.picks)
    env = envelopes(td, x)
    total = 0
    for i, name in enumerate(jr.picks):
        np.testing.assert_allclose(tr.thresholds[name], jr.thresholds[name], rtol=1e-5)
        a, b = np.asarray(jr.picks[name]), tr.picks[name]
        assert b.dtype == np.int64 and b.shape[0] == 2
        bad = unexplained_differences(a, b, env[i], tr.thresholds[name])
        assert not bad, f"{name}: picks differ beyond rounding at {bad[:10]}"
        total += b.shape[1]
    assert total > 0, "parity over an empty pick set proves nothing"


CASES = [
    ("small", "raw", "fin", None),
    ("small", "raw", "fin", 16),
    ("small", "conditioned", "fin", None),
    ("small", "conditioned", "pair", 16),
    ("med", "raw", "pair", None),
    ("med", "raw", "fin", 16),
    ("med", "conditioned", "fin", 16),
]


@pytest.mark.parametrize("size,wire,bank,tile", CASES)
def test_detect_picks_matches_jax(scenes, size, wire, bank, tile):
    jd, jr, td, tr, x = _pair(scenes, size, wire, PAIR if bank == "pair" else bank, tile)
    assert td._route() == ("tiled" if tile else "mono")
    assert td.threshold_scope == jd.threshold_scope
    assert td.syncs == td.dispatches == 1 and td.escalations == 0
    _assert_parity(jr, tr, td, x)


def test_k0_saturation_escalates_like_jax(scenes):
    jd, jr, td, tr, x = _pair(scenes, "small", "raw", "fin", 16, pick_k0=1)
    assert td.escalations == 1 and td.dispatches == 2 and td.syncs == 2
    _assert_parity(jr, tr, td, x)


def test_capacity_overflow_returns_the_exact_full_set(scenes):
    jd, jr, td, tr, x = _pair(scenes, "med", "raw", "fin", 16, pick_pack_cap=4)
    assert td.syncs == td.dispatches + 1            # the full transfer
    assert max(p.shape[1] for p in tr.picks.values()) > 4
    _assert_parity(jr, tr, td, x)
    # bit for bit the picks of an attempt that did not overflow
    roomy = TorchDetector.from_design(td.design, td.metadata, channel_tile=16,
                                      wire="raw", device="cpu")
    ref = roomy.detect_picks(x)
    for name in ref.picks:
        np.testing.assert_array_equal(tr.picks[name], ref.picks[name])
        assert tr.thresholds[name] == ref.thresholds[name]


def test_padded_record_demeans_real_samples_only(scenes):
    scene, blocks = scenes["small"]
    padded = np.zeros((scene.nx, 1024), np.int32)
    padded[:, : scene.ns] = blocks["raw"]
    scenes = dict(scenes, padded=(SyntheticScene(nx=scene.nx, ns=1024, noise_rms=0.05,
                                                 seed=0), {"raw": padded}))
    jd, jr, td, tr, x = _pair(scenes, "padded", "raw", "fin", None, n_real=scene.ns)
    _assert_parity(jr, tr, td, x)


def test_detector_designs_like_jax_and_dispatches(scenes):
    """The port's own design path (no carried-over arrays) against the
    carried-over one: same picks bit for bit."""
    scene, blocks = scenes["small"]
    td = TorchDetector(scene.metadata, [0, scene.nx, 1], (scene.nx, scene.ns),
                       wire="raw", device="cpu")
    assert td._route() == "mono" and td.effective_channel_tile == 512
    handle = td.dispatch_picks(blocks["raw"])
    assert isinstance(handle, InFlightResult) and td.syncs == 0
    res = handle.resolve()
    assert handle.resolve() is res and td.syncs == 1
    _, jr, _, ref, _ = _pair(scenes, "small", "raw", "fin", None)
    for name in ref.picks:
        np.testing.assert_array_equal(res.picks[name], ref.picks[name])


@pytest.mark.parametrize("kw", [
    {"mf_engine": "matmul"}, {"mf_engine": "auto"}, {"fk_engine": "matmul"},
    {"mf_engine": "matmul-fused"}, {"fk_engine": "auto"},
])
def test_settings_outside_the_slice_raise(kw, tmp_path, monkeypatch):
    # the engine settings came with the matmul engines (ops.mxu): each one
    # builds and resolves (forced as given, a gated engine to itself or to
    # its float32 fallback, "auto" to the FFT route on the CPU), and the
    # same setting with an unknown engine raises
    monkeypatch.setenv("DAS_CALIBRATION_CACHE", str(tmp_path / "cal.json"))
    meta = SyntheticScene(nx=24, ns=900).metadata
    det = TorchDetector(meta, [0, 24, 1], (24, 900), device="cpu", **kw)
    (key, value), = kw.items()
    want = {"auto": ("fft",), "matmul-fused": ("matmul-fused", "matmul")}.get(value, (value,))
    assert getattr(det, key) in want, getattr(det, f"{key}_reason")
    if value == "auto":
        assert "no MXU" in getattr(det, f"{key}_reason")
    with pytest.raises(ValueError, match=key):
        TorchDetector(meta, [0, 24, 1], (24, 900), device="cpu", **{key: "nope"})
