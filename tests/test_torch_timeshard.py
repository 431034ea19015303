"""Port parity, time-split processing: ``parallel.timeshard`` (the halo
bandpass, the pencil f-k transform, ``make_sharded_mf_step_time``) and
``workflows.longrecord.detect_long_record(mesh=...)`` on a ``(time=2)``
mesh of gloo CPU ranks, against the JAX package's on a CPU mesh of the
same shape (float32, ``pick_mode="sparse"``, ``mf_engine="fft"``).

The ranks run once a module (``tests/torch_mesh_worker.py``); each test
asserts one case. Contract: the halo bandpass and every filtered block,
correlogram and envelope within 1e-5·max of JAX's (every shard boundary
included: boundary-exact); thresholds rtol 1e-5; picks up to rounding
knife edges of the port's own envelopes (the step at a mesh of one, in
the test process: its collectives are identities).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from das4whales_tpu import config as jcfg
from das4whales_tpu import io as jio
from das4whales_tpu.io.synth import SyntheticCall, SyntheticScene, synthesize_scene, to_raw_counts
from das4whales_tpu.models import templates as jtpl
from das4whales_tpu.models.matched_filter import design_matched_filter as jdesign
from das4whales_tpu.parallel import timeshard as jts
from das4whales_tpu.parallel.mesh import make_mesh as jmake_mesh
from das4whales_tpu.workflows import longrecord as jlr
from das4whales_tpu_torch import convert
from das4whales_tpu_torch.models.templates import gen_template_fincall
from das4whales_tpu_torch.ops import fk as tfk
from das4whales_tpu_torch.ops import peaks as tpeaks
from das4whales_tpu_torch.parallel import timeshard as tts
from das4whales_tpu_torch.parallel.mesh import make_mesh
from das4whales_tpu_torch.utils.parity import unexplained_differences
from das4whales_tpu_torch.workflows import longrecord as tlr
from das4whales_tpu_torch.workflows.planner import DownshiftLadder
from torch_mesh_worker import run_pool
from tests.torch_threads import one_torch_thread  # noqa: F401

P = 2
NX, NS = 32, 2000
FS, BAND, HALO = 200.0, (14.0, 30.0), 256
REL = 1e-5
PAIR = jtpl.TemplateBank(
    name="pair", entries=(("HF", jcfg.FIN_HF_NOTE), ("LF", jcfg.FIN_LF_NOTE)),
    threshold_scope="per_template",
)
SEGS = (1200, 800)

#: name -> (bank, wire, step kwargs beyond the wire's)
STEPS = {
    "fused_cond": ("fin", "conditioned", dict(outputs="full")),
    "staged_raw_tail": ("fin", "raw", dict(outputs="full", fused_bandpass=False, halo=HALO,
                                           cond_time_samples=NS - 100)),
    "segmented_per_template": ("pair", "raw", dict(outputs="full", cond_segments=SEGS)),
}


def _record():
    calls = [SyntheticCall(t0=4.0, x0_m=NX / 2 * 2.042, amplitude=2.0),
             SyntheticCall(t0=5.8, x0_m=NX / 4 * 2.042, amplitude=1.5)]
    scene = SyntheticScene(nx=NX, ns=NS, noise_rms=0.05, seed=21, calls=calls)
    raw = to_raw_counts(synthesize_scene(scene), scene.metadata)
    cond = ((raw - raw.mean(axis=1, keepdims=True)) * scene.metadata.scale_factor).astype(
        np.float32)
    tail = raw.copy()
    tail[:, NS - 100:] = 0                     # divisibility padding, raw zeros
    return scene.metadata, {"conditioned": cond, "raw": raw, "tail": tail}


def _seg_means(raw):
    a, b = SEGS
    return np.stack([raw[:, :a].astype(np.float32).mean(axis=1),
                     raw[:, a:a + b].astype(np.float32).mean(axis=1)], axis=1)


def _step_kw(name, meta, recs):
    bank, wire, kw = STEPS[name]
    kw = dict(kw)
    if wire == "raw":
        kw.update(wire="raw", scale_factor=meta.scale_factor)
    if "cond_segments" in kw:
        kw["cond_means"] = _seg_means(recs["raw"])
    x = recs["tail"] if "cond_time_samples" in kw else recs[wire]
    return bank, x, kw


def _long_files(d):
    rng = np.random.default_rng(5)
    ns = 1536
    record = rng.standard_normal((NX, 2 * ns)) * 1e-9
    t = np.arange(ns) / FS
    call = gen_template_fincall(t, FS, 17.8, 28.8, 0.68, True)
    n_call = int(0.68 * FS) + 1
    onset = ns - n_call // 2          # one call straddling the boundary
    record[7, onset:onset + n_call] += 8e-9 * call[:n_call]
    paths = [jio.write_optasense(str(d / f"seg{k}.h5"),
                                 np.round(record[:, k * ns:(k + 1) * ns] / 1e-12).astype(np.int32),
                                 fs=FS, dx=4.0) for k in range(2)]
    return paths, (7, onset)


LONG = {"cond_fused": dict(wire="conditioned"),
        "raw_staged": dict(wire="raw", fused_bandpass=False, halo=384)}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    meta, recs = _record()
    with jax.enable_x64(False):
        jd = {b: jdesign((NX, NS), [0, NX, 1], meta, templates=t)
              for b, t in (("fin", "fin"), ("pair", PAIR))}
    dd = {b: {f: getattr(d, f) if isinstance(getattr(d, f), (str, tuple, int, float))
              else np.array(getattr(d, f)) for f in convert.DESIGN_FIELDS}
          for b, d in jd.items()}
    rng = np.random.default_rng(3)
    x = rng.standard_normal((16, NS)).astype(np.float32)
    mask = tfk.hybrid_ninf_filter_design((NX, NS), [0, NX, 1], 8.0, FS).astype(np.float32)
    paths, straddle = _long_files(tmp_path_factory.mktemp("long"))
    ax = dict(shape=(P,), axis_names=("time",))
    cases = [dict(name="halo", fn="halo", args=dict(x=x, fs=FS, band=BAND, halo=HALO), **ax),
             dict(name="fk_time", fn="fk_time", args=dict(trace=recs["conditioned"],
                                                         mask=mask), **ax),
             dict(name="ladder", fn="ladder", args=dict(shape=(NX, NS)), **ax)]
    for name in STEPS:
        bank, xin, kw = _step_kw(name, meta, recs)
        cases.append(dict(name=name, fn="mf_step_time", args=dict(design=dd[bank], record=xin,
                                                                   kw=kw), **ax))
    for name, kw in LONG.items():
        cases.append(dict(name=f"long_{name}", fn="longrecord",
                          args=dict(files=paths, sel=[0, NX, 1], kw=kw), **ax))
    with ThreadPoolExecutor(1) as ex:
        fut = ex.submit(run_pool, cases, P, tmp_path_factory.mktemp("ts"))
        jax_out = _jax_side(meta, recs, jd, x, mask, paths)
        ranks = fut.result()
    return dict(meta=meta, recs=recs, dd=dd, x=x, mask=mask, paths=paths, straddle=straddle,
                jax=jax_out, ranks=ranks)


def _jmesh():
    return jmake_mesh(shape=(P,), axis_names=("time",), devices=jax.devices()[:P])


def _jax_side(meta, recs, jd, x, mask, paths):
    out = {}
    m = _jmesh()
    sh = jts.time_sharding(m)
    with jax.enable_x64(False):
        out["halo"] = np.array(jts.sharded_bp_filt_time(
            jax.device_put(jnp.asarray(x), sh), m, FS, BAND[0], BAND[1], halo=HALO))
        out["fk_time"] = np.array(jts.sharded_fk_apply_time(
            jax.device_put(jnp.asarray(recs["conditioned"]), sh), mask, m))
        for name in STEPS:
            bank, xin, kw = _step_kw(name, meta, recs)
            step = jts.make_sharded_mf_step_time(jd[bank], m, pick_mode="sparse", **kw)
            out[name] = jax.tree_util.tree_map(np.array, step(jax.device_put(jnp.asarray(xin),
                                                                            sh)))
        jmeta = jio.get_acquisition_parameters(paths[0], "optasense")
        for name, kw in LONG.items():
            out[f"long_{name}"] = jlr.detect_long_record(paths, [0, NX, 1], jmeta, mesh=m, **kw)
    return out


def test_halo_bandpass_is_boundary_exact_against_jax(world):
    want = world["jax"]["halo"]
    for r in range(P):
        got = world["ranks"][r]["halo"]["bp"]
        np.testing.assert_allclose(got, want, rtol=0, atol=REL * np.abs(want).max())
    # the one-device odd-extension edges at a mesh of one
    m1 = make_mesh(shape=(1,), axis_names=("time",), devices=["cpu"])
    one = tts.sharded_bp_filt_time(torch.from_numpy(world["x"]), m1, FS, *BAND, halo=HALO)
    assert one.shape == (16, NS) and torch.isfinite(one).all()


def test_fk_apply_time_matches_jax_and_one_device(world):
    want = world["jax"]["fk_time"]
    got = world["ranks"][0]["fk_time"]["fk"]
    np.testing.assert_allclose(got, want, rtol=0, atol=REL * np.abs(want).max())
    one = tfk.fk_filter_apply(torch.from_numpy(world["recs"]["conditioned"]),
                              world["mask"]).numpy()
    np.testing.assert_allclose(got, one, rtol=0, atol=REL * np.abs(one).max())


def _knife_env(design, xin, kw):
    """The port's envelopes of the same step at a mesh of one."""
    m1 = make_mesh(shape=(1,), axis_names=("time",), devices=["cpu"])
    return tts.make_sharded_mf_step_time(design, m1, **dict(kw, outputs="full"))(
        torch.from_numpy(xin))[2].numpy()


@pytest.mark.parametrize("name", list(STEPS))
def test_time_split_step_matches_jax(world, name):
    meta, recs = world["meta"], world["recs"]
    bank, xin, kw = _step_kw(name, meta, recs)
    design = convert.design_from_arrays(world["dd"][bank])
    got = world["ranks"][0][name]
    jt, jc, je, jp, jthr = world["jax"][name]
    np.testing.assert_allclose(got["thres"], jthr, rtol=REL)
    np.testing.assert_array_equal(world["ranks"][1][name]["thres"], got["thres"])
    for key, want in (("trf_fk", jt), ("corr", jc), ("env", je)):
        np.testing.assert_allclose(got[key], want, rtol=0, atol=REL * np.abs(want).max())
    env = _knife_env(design, xin, kw)
    factors, scope = design.resolve_threshold_policy()
    base = np.broadcast_to(np.asarray(got["thres"], np.float32), factors.shape)
    total = 0
    for t, name_t in enumerate(design.template_names):
        a = tpeaks.sparse_to_pick_times(jp.positions[t], jp.selected[t])
        g = tpeaks.sparse_to_pick_times(got["picks"]["positions"][t],
                                        got["picks"]["selected"][t])
        thr = float(base[t]) * float(factors[t])
        assert not unexplained_differences(a, g, env[t], thr), name_t
        total += g.shape[1]
    assert total > 0


@pytest.mark.parametrize("name", list(LONG))
def test_long_record_over_a_time_mesh_matches_jax(world, name):
    """Both ranks return the same result; the straddling call is picked;
    thresholds rtol 1e-5 and picks up to knife edges against JAX's."""
    jres = world["jax"][f"long_{name}"]
    got = world["ranks"][0][f"long_{name}"]
    other = world["ranks"][1][f"long_{name}"]
    assert got["n_samples"] == jres.n_samples == 2 * 1536 and got["t0"] == str(jres.t0_utc)
    assert other["t0"] == got["t0"]
    ch, onset = world["straddle"]
    kw = LONG[name]
    meta = jio.get_acquisition_parameters(world["paths"][0], "optasense")
    from das4whales_tpu_torch.io.stream import stream_strain_blocks
    from das4whales_tpu_torch.models.matched_filter import design_matched_filter

    blocks = list(stream_strain_blocks(world["paths"], [0, NX, 1], as_numpy=True,
                                       wire=kw["wire"]))
    rec = np.concatenate([b.trace for b in blocks], axis=-1)
    design = design_matched_filter(rec.shape, [0, NX, 1], blocks[0].metadata)
    skw = dict(fused_bandpass=kw.get("fused_bandpass", True), halo=kw.get("halo", 512))
    if kw["wire"] == "raw":
        skw.update(wire="raw", scale_factor=meta.scale_factor,
                   cond_segments=[b.trace.shape[-1] for b in blocks],
                   cond_means=np.stack([tlr._host_means(b.trace) for b in blocks], axis=1))
    env = _knife_env(design, rec, skw)
    for i, pname in enumerate(jres.picks):
        np.testing.assert_allclose(got["thresholds"][pname], jres.thresholds[pname], rtol=REL)
        np.testing.assert_array_equal(other["picks"][pname], got["picks"][pname])
        bad = unexplained_differences(jres.picks[pname], got["picks"][pname], env[i],
                                      got["thresholds"][pname], REL)
        assert not bad, f"{pname}: picks differ beyond rounding at {bad}"
    hf = got["picks"]["HF"]
    assert np.any(np.abs(hf[1][hf[0] == ch] - onset) < 120), "the straddling call was missed"


def test_the_timeshard_rung_needs_a_world_of_several(world):
    """The planner offers ``("timeshard", 1)`` in the two-rank world and
    never in a world of one."""
    assert ("timeshard", 1) in world["ranks"][0]["ladder"]["rungs"]
    lad = DownshiftLadder(None, "", batch=1, stages=("file", "tiled", "timeshard", "host"))
    assert ("timeshard", 1) not in lad.rungs(trace_shape=(NX, NS))
    assert tts.viable_time_mesh_size((NX, NS), 1) is None
    assert tts.viable_time_mesh_size((NX, NS), 4) == 4 == jts.viable_time_mesh_size((NX, NS), 4)
    assert tts.ladder_time_mesh((NX, NS)) is None
