"""Port parity, the long record: ``workflows.longrecord.detect_long_record``
on the CPU against the JAX package's on a one-device mesh (JAX's default
mesh spans the eight virtual CPU devices and would pad the record to a
multiple of 8).

Scene: ``tests/test_longrecord.py``'s three consecutive 32 x 4096 files
with a call mid-file-0 and one straddling the 0/1 boundary. Tolerance:
picks equal up to rounding knife edges of the port's own envelopes
(``utils.parity.unexplained_differences``, 1e-5 relative); thresholds
rtol 1e-5 (float32 FFTs of two libraries); the learned family's picks
up to knife edges of its scores (1e-4, ``test_torch_learned.py``'s).
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from das4whales_tpu import io as jio
from das4whales_tpu.models import learned as jlearned
from das4whales_tpu.parallel.mesh import make_mesh
from das4whales_tpu.workflows import longrecord as jlr
from das4whales_tpu_torch.io.interrogators import get_acquisition_parameters
from das4whales_tpu_torch.io.stream import stream_strain_blocks
from das4whales_tpu_torch.models import learned as tlearned
from das4whales_tpu_torch.models.matched_filter import design_matched_filter
from das4whales_tpu_torch.utils.parity import (
    unexplained_differences,
    unexplained_learned_differences,
)
from das4whales_tpu_torch.workflows import longrecord as tlr
from tests.torch_threads import one_torch_thread  # noqa: F401

FS, DX = 200.0, 4.0
NX, NS_FILE = 32, 4096
SEL = [0, NX, 1]
REL = 1e-5
KNIFE = 1e-4


def _template():
    from das4whales_tpu.models.templates import gen_template_fincall

    time = np.arange(NS_FILE) / FS
    full = np.asarray(gen_template_fincall(time, FS, 17.8, 28.8, 0.68, True))
    return full[: int(0.68 * FS) + 1]


def _write(tmp_path, record, prefix, bounds):
    paths = []
    for k, (lo, hi) in enumerate(bounds):
        raw = np.round(record[:, lo:hi] / 1e-12).astype(np.int32)
        paths.append(jio.write_optasense(str(tmp_path / f"{prefix}{k}.h5"), raw, fs=FS, dx=DX))
    return paths


@pytest.fixture(scope="module")
def campaign(tmp_path_factory):
    """JAX's fixture: three consecutive files, calls mid-file-0 and
    straddling the 0/1 boundary (onset 68 samples before the break)."""
    rng = np.random.default_rng(1234)
    call = _template()
    record = rng.standard_normal((NX, 3 * NS_FILE)).astype(np.float64) * 1e-9
    onsets = {"mid": (6, 800), "straddle": (20, NS_FILE - 68)}
    for ch, onset in onsets.values():
        record[ch, onset : onset + len(call)] += 6e-9 * call
    bounds = [(k * NS_FILE, (k + 1) * NS_FILE) for k in range(3)]
    return _write(tmp_path_factory.mktemp("lr"), record, "seg", bounds), onsets


def _mesh1():
    return make_mesh(shape=(1,), axis_names=("time",), devices=jax.devices()[:1])


def _jax_run(paths, **kw):
    meta = jio.get_acquisition_parameters(paths[0], "optasense")
    with jax.enable_x64(False):
        return jlr.detect_long_record(paths, SEL, meta, mesh=_mesh1(), **kw)


def _port_env(paths, wire):
    """The port's record envelopes and thresholds (the knife-edge margin)."""
    from das4whales_tpu_torch.ops import spectral

    blocks = list(stream_strain_blocks(paths, SEL, as_numpy=True, wire=wire))
    record = np.concatenate([b.trace for b in blocks], axis=-1)
    design = design_matched_filter(record.shape, SEL, blocks[0].metadata)
    corr = tlr._mf_record_correlograms(torch.from_numpy(record), blocks, design,
                                       blocks[0].metadata, wire, lambda n: None)
    return spectral.envelope_sqrt(corr).numpy()


def _assert_same_picks(jres, tres, env):
    assert set(jres.picks) == set(tres.picks)
    for i, name in enumerate(jres.picks):
        np.testing.assert_allclose(tres.thresholds[name], jres.thresholds[name], rtol=REL)
        bad = unexplained_differences(jres.picks[name], tres.picks[name], env[i],
                                      tres.thresholds[name], REL)
        assert not bad, f"{name}: picks differ beyond rounding at {bad}"
        np.testing.assert_array_equal(tres.pick_times_s[name], tres.picks[name][1] / FS)


def _picked_near(pk, ch, onset, tol=120):
    sel = pk[1][pk[0] == ch]
    return bool(np.any(np.abs(sel - onset) < tol))


@pytest.mark.parametrize("wire", ["conditioned", "raw"])
def test_mf_record_matches_jax_and_picks_the_straddling_call(campaign, wire):
    paths, onsets = campaign
    meta = get_acquisition_parameters(paths[0], "optasense")
    tres = tlr.detect_long_record(paths, SEL, meta, wire=wire, device="cpu")
    jres = _jax_run(paths, wire=wire, halo=384)
    assert (tres.n_files, tres.n_samples) == (jres.n_files, jres.n_samples) == (3, 3 * NS_FILE)
    assert tres.t0_utc == jres.t0_utc
    _assert_same_picks(jres, tres, _port_env(paths, wire))
    for name, (ch, onset) in onsets.items():
        assert _picked_near(tres.picks["HF"], ch, onset), f"{name} call missed"


def test_both_wires_pick_the_same(campaign):
    """The raw wire demeans file by file on the card, as the conditioned
    wire's readers do: the two wires' picks agree."""
    paths, _ = campaign
    a = tlr.detect_long_record(paths, SEL, wire="conditioned", device="cpu")
    b = tlr.detect_long_record(paths, SEL, wire="raw", device="cpu")
    env = _port_env(paths, "conditioned")
    for i, name in enumerate(a.picks):
        assert not unexplained_differences(a.picks[name], b.picks[name], env[i],
                                           a.thresholds[name], REL)


def test_end_of_record_call_and_no_pick_past_the_record(tmp_path):
    """A call ending 13 samples before the record's end is picked, and no
    pick lies at or past the record's end (JAX's end-of-record test, on
    one device: the record needs no divisibility padding)."""
    rng = np.random.default_rng(99)
    call = _template()
    ns_a, ns_b = 4096, 4099
    total = ns_a + ns_b
    record = rng.standard_normal((NX, total)).astype(np.float64) * 1e-9
    ch, onset = 12, total - len(call) - 13
    record[ch, onset : onset + len(call)] += 6e-9 * call
    paths = _write(tmp_path, record, "end", [(0, ns_a), (ns_a, total)])
    tres = tlr.detect_long_record(paths, SEL, device="cpu")
    jres = _jax_run(paths, halo=384)
    assert tres.n_samples == jres.n_samples == total
    _assert_same_picks(jres, tres, _port_env(paths, "conditioned"))
    for pk in tres.picks.values():
        assert pk.shape[1] == 0 or pk[1].max() < total
    assert _picked_near(tres.picks["HF"], ch, onset)


def test_pack_overflow_takes_the_full_grid(campaign, monkeypatch):
    """A pack capacity of 1 overflows into the full-grid route, which
    returns the packed route's picks exactly."""
    paths, _ = campaign
    packed = tlr.detect_long_record(paths, SEL, device="cpu")
    monkeypatch.setattr(tlr, "_PICK_PACK_CAP", 1)
    full = tlr.detect_long_record(paths, SEL, device="cpu")
    assert max(p.shape[1] for p in packed.picks.values()) > 1
    for name in packed.picks:
        np.testing.assert_array_equal(packed.picks[name], full.picks[name])


def test_a_given_design_is_the_designed_one(campaign):
    paths, _ = campaign
    meta = get_acquisition_parameters(paths[0], "optasense")
    design = design_matched_filter((NX, 3 * NS_FILE), SEL, meta)
    a = tlr.detect_long_record(paths, SEL, meta, device="cpu")
    b = tlr.detect_long_record(paths, SEL, meta, design=design, device="cpu")
    for name in a.picks:
        np.testing.assert_array_equal(a.picks[name], b.picks[name])
    small = design_matched_filter((NX, NS_FILE), SEL, meta)
    with pytest.raises(ValueError, match="does not fit"):
        tlr.detect_long_record(paths, SEL, meta, design=small, device="cpu")


def test_learned_family_matches_jax(campaign):
    """The learned family over the whole record with the pretrained model:
    picks equal JAX's up to knife edges of the port's scores; both calls
    (the straddling one too) are picked; no pick past the record."""
    paths, onsets = campaign
    meta = get_acquisition_parameters(paths[0], "optasense")
    model, cfg = tlearned.load_pretrained()
    tres = tlr.detect_long_record(paths, SEL, meta, family="learned", device="cpu",
                                  family_kwargs={"params": model, "cfg": cfg, "threshold": 0.5})
    with jax.enable_x64(False):
        jp, jcfg = jlearned.load_pretrained()
    jres = _jax_run(paths, family="learned",
                    family_kwargs={"params": jp, "cfg": jcfg, "threshold": 0.5})
    pk = tres.picks["CALL"]
    assert pk.shape[1] > 0 and int(pk[1].max()) < tres.n_samples
    record = np.concatenate([b.trace for b in stream_strain_blocks(paths, SEL, as_numpy=True)],
                            axis=-1)
    det = tlearned.LearnedDetector(model, cfg, device="cpu")
    scores = det.scores(torch.from_numpy(record)).numpy()
    centers = tlearned.window_centers(scores.shape[1], cfg)
    bad = unexplained_learned_differences(jres.picks["CALL"], pk, scores, centers, 0.5, KNIFE)
    assert not bad, f"picks differ beyond rounding at {bad}"
    assert tres.thresholds == jres.thresholds == {"CALL": 0.5}
    np.testing.assert_array_equal(tres.pick_times_s["CALL"], pk[1] / FS)


def test_learned_family_loads_a_model_file(campaign, tmp_path):
    paths, _ = campaign
    model, cfg = tlearned.load_pretrained()
    path = tlearned.save_params(str(tmp_path / "m.npz"), model, cfg)
    a = tlr.detect_long_record(paths, SEL, family="learned", device="cpu",
                               family_kwargs={"model": path})
    b = tlr.detect_long_record(paths, SEL, family="learned", device="cpu",
                               family_kwargs={"params": model, "cfg": cfg})
    np.testing.assert_array_equal(a.picks["CALL"], b.picks["CALL"])


def test_settings_outside_the_slice_raise(campaign):
    """The spectro and Gabor families, once refused, now run on one device
    (a mesh of one) and pick as JAX's on a one-device mesh, up to knife
    edges of the port's own correlograms (the Gabor family at
    ``tests/test_gabor_timeshard.py``'s image settings: 32 channels are too
    few for the default receptive field); the settings that stay invalid
    raise as before."""
    paths, _ = campaign
    n_picks = {}
    for fam, kw in (("spectro", {}), ("gabor", dict(bin_factor=0.5, ksize=6,
                                                     threshold1=2000.0, threshold2=10.0))):
        tres = tlr.detect_long_record(paths, SEL, device="cpu", family=fam, family_kwargs=kw,
                                      keep_envelopes=True)
        jres = _jax_run(paths, family=fam, family_kwargs=kw)
        names, env, scale = list(tres.thresholds), tres.envelopes, tres.pos_scale
        assert set(tres.picks) == set(jres.picks) == set(names)
        assert tres.n_samples == jres.n_samples and tres.t0_utc == jres.t0_utc
        for i, name in enumerate(names):
            np.testing.assert_allclose(tres.thresholds[name], jres.thresholds[name], rtol=REL)
            bad = unexplained_differences(jres.picks[name] // [[1], [scale]],
                                          tres.picks[name] // [[1], [scale]], env[i],
                                          tres.thresholds[name], REL)
            assert not bad, f"{fam} {name}: picks differ beyond rounding at {bad}"
        n_picks[fam] = sum(pk.shape[1] for pk in tres.picks.values())
    # the one-channel calls of this scene survive the f-k fan in the Gabor
    # family's masked matched filter
    assert n_picks["gabor"] > 0, n_picks
    # a mesh is a parallel.mesh.Mesh built by every rank (test_torch_timeshard.py)
    for mesh in (2, ["cuda:0", "cuda:1"]):
        with pytest.raises(ValueError, match="parallel.mesh.Mesh"):
            tlr.detect_long_record(paths, SEL, device="cpu", mesh=mesh)
    # the correlate engines come through ops.mxu's router
    with pytest.raises(ValueError, match="mf_engine"):
        tlr.detect_long_record(paths, SEL, device="cpu", mf_engine="nope")
    with pytest.raises(ValueError, match="at least one file"):
        tlr.detect_long_record([], SEL, device="cpu")
    with pytest.raises(ValueError, match="learned"):
        tlr.detect_long_record(paths, SEL, family="learned", device="cpu")
    with pytest.raises(ValueError, match="flagship"):
        tlr.detect_long_record(paths, SEL, wire="raw", family="learned", device="cpu",
                               family_kwargs={"model": "m.npz"})
    with pytest.raises(ValueError, match="family_kwargs"):
        tlr.detect_long_record(paths, SEL, family_kwargs={"threshold": 1.0}, device="cpu")
    assert tlr._pad_to_multiple(np.zeros((2, 5)), 4).shape == (2, 8)
    assert tlr._pad_to_multiple(np.zeros((2, 8)), 4).shape == (2, 8)
    single = tlr.detect_long_record(paths[:1], SEL, mesh=1, device="cpu")
    assert single.n_files == 1
