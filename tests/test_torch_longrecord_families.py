"""Port parity, the long record's other families:
``workflows.longrecord.detect_long_record(family="spectro"|"gabor")`` on
a mesh of one (in this process, ``mesh=None``) and over a ``(time=2)``
mesh of gloo CPU ranks, and ``family="learned"`` over the same mesh,
against the JAX package's on CPU meshes of one and of two devices
(float32).

Files: two consecutive 64 x 2048 OptaSense files at 200 Hz and 4.084 m
(``io.synth`` calls with their moveout, one straddling the file
boundary). The Gabor family runs at ``tests/test_gabor_timeshard.py``'s
settings (``bin_factor=0.5, ksize=6``, thresholds 2000 / 10). Contract:
thresholds rtol 1e-5; picks equal up to rounding knife edges of the
port's own correlograms or envelopes at a mesh of one
(``detect_long_record(keep_envelopes=True)``, ``utils.parity.
unexplained_differences``);
the learned picks up to knife edges of its scores (1e-4,
``test_torch_learned.py``'s); every rank returns the same result.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from das4whales_tpu import io as jio
from das4whales_tpu.io.synth import SyntheticCall, SyntheticScene, synthesize_scene, to_raw_counts
from das4whales_tpu.parallel.mesh import make_mesh as jmake_mesh
from das4whales_tpu.workflows import longrecord as jlr
from das4whales_tpu_torch import convert
from das4whales_tpu_torch.io.stream import stream_strain_blocks
from das4whales_tpu_torch.models import learned as tl
from das4whales_tpu_torch.parallel.mesh import make_mesh
from das4whales_tpu_torch.utils.parity import (
    unexplained_differences,
    unexplained_learned_differences,
)
from das4whales_tpu_torch.workflows import longrecord as tlr
from torch_mesh_worker import run_pool
from tests.torch_threads import one_torch_thread  # noqa: F401

P = 2
NX, NS_FILE, FS, DX = 64, 2048, 200.0, 4.084
SEL = [0, NX, 1]
REL = 1e-5
KNIFE = 1e-4
GABOR = dict(bin_factor=0.5, ksize=6, threshold1=2000.0, threshold2=10.0)
FAMILIES = {"spectro": {}, "gabor": GABOR}


def _files(d):
    calls = [SyntheticCall(t0=4.0, x0_m=30 * DX, amplitude=2.0),
             SyntheticCall(t0=9.9, x0_m=20 * DX, amplitude=2.0, fmin=14.7, fmax=21.8,
                           duration=0.78)]
    scene = SyntheticScene(nx=NX, ns=2 * NS_FILE, dx=DX, noise_rms=0.05, seed=31, calls=calls)
    raw = to_raw_counts(synthesize_scene(scene), scene.metadata)
    return [jio.write_optasense(str(d / f"seg{k}.h5"), raw[:, k * NS_FILE:(k + 1) * NS_FILE],
                                fs=FS, dx=DX) for k in range(2)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    paths = _files(tmp_path_factory.mktemp("fam"))
    model, _ = tl.load_pretrained()
    params = convert.learned_params_to_arrays(model)
    ax = dict(shape=(P,), axis_names=("time",))
    cases = [dict(name=fam, fn="longrecord", args=dict(files=paths, sel=SEL, kw=dict(
        family=fam, family_kwargs=kw)), **ax) for fam, kw in FAMILIES.items()]
    cases.append(dict(name="learned", fn="longrecord", args=dict(
        files=paths, sel=SEL, kw=dict(family="learned", model=params)), **ax))
    with ThreadPoolExecutor(1) as ex:
        fut = ex.submit(run_pool, cases, P, tmp_path_factory.mktemp("fam_pool"))
        jax_out = _jax_side(paths, params)
        one = {fam: tlr.detect_long_record(paths, SEL, family=fam, family_kwargs=kw,
                                           device="cpu", keep_envelopes=True)
               for fam, kw in FAMILIES.items()}
        ranks = fut.result()
    blocks = list(stream_strain_blocks(paths, SEL, as_numpy=True))
    record = np.concatenate([b.trace for b in blocks], axis=-1)
    margins = {fam: (list(r.thresholds), r.envelopes, r.pos_scale, r.thresholds)
               for fam, r in one.items()}
    return dict(paths=paths, params=params, record=record, jax=jax_out, one=one,
                ranks=ranks, margins=margins)


def _jax_side(paths, params):
    meta = jio.get_acquisition_parameters(paths[0], "optasense")
    out = {}
    with jax.enable_x64(False):
        for p in (1, P):
            m = jmake_mesh(shape=(p,), axis_names=("time",), devices=jax.devices()[:p])
            for fam, kw in FAMILIES.items():
                out[(fam, p)] = jlr.detect_long_record(paths, SEL, meta, mesh=m, family=fam,
                                                       family_kwargs=kw)
        m = jmake_mesh(shape=(P,), axis_names=("time",), devices=jax.devices()[:P])
        jparams = jax.tree_util.tree_map(jax.numpy.asarray, params)
        from das4whales_tpu.models import learned as jl

        out[("learned", P)] = jlr.detect_long_record(
            paths, SEL, meta, mesh=m, family="learned",
            family_kwargs={"params": jparams, "cfg": jl.LearnedConfig()})
    return out


def _assert_family(world, fam, got, jres):
    names, env, pos_scale, thr_one = world["margins"][fam]
    assert got["n_samples"] == jres.n_samples == 2 * NS_FILE
    total = 0
    for i, name in enumerate(names):
        np.testing.assert_allclose(got["thresholds"][name], jres.thresholds[name], rtol=REL)
        np.testing.assert_allclose(got["thresholds"][name], thr_one[name], rtol=REL)
        a, g = jres.picks[name], got["picks"][name]
        assert np.all(g[1] % pos_scale == 0)
        bad = unexplained_differences(a // [[1], [pos_scale]], g // [[1], [pos_scale]],
                                      env[i], thr_one[name], REL)
        assert not bad, f"{fam} {name}: picks differ beyond rounding at {bad}"
        total += g.shape[1]
    assert total > 0


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_family_on_a_mesh_of_one_matches_jax(world, fam):
    res = world["one"][fam]
    got = dict(picks=res.picks, thresholds=res.thresholds, n_samples=res.n_samples)
    _assert_family(world, fam, got, world["jax"][(fam, 1)])
    for name, pk in res.picks.items():
        np.testing.assert_array_equal(res.pick_times_s[name], pk[1] / FS)


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_family_over_a_time_mesh_matches_jax(world, fam):
    got, other = world["ranks"][0][fam], world["ranks"][1][fam]
    assert other["t0"] == got["t0"] == str(world["jax"][(fam, P)].t0_utc)
    for name in got["picks"]:
        np.testing.assert_array_equal(other["picks"][name], got["picks"][name])
    _assert_family(world, fam, got, world["jax"][(fam, P)])


def test_learned_over_a_mesh_matches_jax(world):
    got, other = world["ranks"][0]["learned"], world["ranks"][1]["learned"]
    jres = world["jax"][("learned", P)]
    np.testing.assert_array_equal(other["picks"]["CALL"], got["picks"]["CALL"])
    assert got["thresholds"] == jres.thresholds == {"CALL": 0.5}
    assert got["n_samples"] == jres.n_samples
    cfg = tl.LearnedConfig()
    m1 = make_mesh(shape=(1,), axis_names=("channel",), devices=["cpu"])
    score_fn, put = tl.make_sharded_inference(world["params"], cfg, m1)
    scores = score_fn(put(world["record"])).numpy()
    centers = tl.window_centers(scores.shape[1], cfg)
    bad = unexplained_learned_differences(jres.picks["CALL"], got["picks"]["CALL"], scores,
                                          centers, 0.5, KNIFE)
    assert not bad, f"picks differ beyond rounding at {bad}"
    assert got["picks"]["CALL"].shape[1] > 0


def test_the_time_split_step_picks_by_shape():
    """The time-split mf step takes the pick kernel's shared-memory form
    where one CTA's shared memory for a row of the record fits the card,
    and names the kernel's long-row form where it does not — by shape,
    before any launch (the card's library and its limit stood in for by
    the kernel's layout and the H100's 227 KB opt-in). No row goes to the
    plain picker on a card."""
    from das4whales_tpu_torch.ops import fused_picks
    from das4whales_tpu_torch.parallel import timeshard as tts

    def layout(T, K, method, nb=128):   # csrc/fused_picks.cu make_layout
        K = min(int(K), T)
        words = T + 2 * (-(-T // nb)) + (-(-T // 32)) + 4 * K + (K + 256 if method else 0) + 16
        return (4 * words + 15) // 16 * 16

    mp = pytest.MonkeyPatch()
    mp.setattr(fused_picks, "smem_bytes",
               lambda T, K, method, nb=128: layout(T, K, method == "topk", nb))
    mp.setattr(fused_picks, "smem_limit", lambda device: 227 * 1024)
    try:
        card = torch.device("cuda", 0)
        assert tts.pick_route(24000, 512, "topk", card) == "fused_picks"
        assert tts.pick_route(16384, 256, "topk", card) == "fused_picks"
        assert tts.pick_route(60000, 512, "topk", card) == "fused_picks_long"
        assert tts.pick_route(720000, 256, "pack", card) == "fused_picks_long"
        assert tts.pick_route(60000, 512, "topk", "cpu") == "fused_picks"
    finally:
        mp.undo()
