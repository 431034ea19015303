"""Port parity, the sharded matched-filter step: ``parallel.pipeline.
make_sharded_mf_step`` on gloo CPU ranks against the JAX package's on a
CPU mesh of the same shape — ``(file=1, channel=2)`` over two ranks and
``(file=2, channel=2)`` over four — with JAX's design carried across
(``convert.design_from_arrays``), float32, ``pick_mode`` set explicitly.

Both pools of ranks run beside the JAX oracle, once a module
(``tests/torch_mesh_worker.py``); each test asserts one case. Contract:
``trf_fk`` and correlograms within 1e-5·max; thresholds rtol 1e-5; pick
sets equal up to rounding knife edges of the port's envelopes
(``utils.parity.unexplained_differences``); dense masks equal where no
knife edge explains a flip. The lockstep escalation case saturates only
rank 0's rows at K0 and checks that every rank reruns.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from das4whales_tpu import config as jcfg
from das4whales_tpu.io.synth import SyntheticCall, SyntheticScene, synthesize_scene, to_raw_counts
from das4whales_tpu.models import templates as jtpl
from das4whales_tpu.models.matched_filter import design_matched_filter as jdesign
from das4whales_tpu.parallel.mesh import make_mesh as jmake_mesh
from das4whales_tpu.parallel.pipeline import input_sharding as jinput_sharding
from das4whales_tpu.parallel.pipeline import make_sharded_mf_step as jstep
from das4whales_tpu.workflows import campaign as jcampaign
from das4whales_tpu_torch import convert
from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector
from das4whales_tpu_torch.ops import peaks as tpeaks
from das4whales_tpu_torch.utils.parity import envelopes, unexplained_differences
from torch_mesh_worker import run_pool
from tests.torch_threads import one_torch_thread  # noqa: F401

NX, NS, B = 32, 1000, 2
REL = 1e-5
PAIR = jtpl.TemplateBank(
    name="pair", entries=(("HF", jcfg.FIN_HF_NOTE), ("LF", jcfg.FIN_LF_NOTE)),
    threshold_scope="per_template",
)

#: name -> (mesh shape, bank, wire, step kwargs)
CASES = {
    "full_fused": ((1, 2), "fin", "conditioned", dict(outputs="full")),
    "picks_raw": ((1, 2), "fin", "raw", dict(outputs="picks")),
    "full_staged_dense": ((1, 2), "fin", "conditioned",
                          dict(outputs="full", fused_bandpass=False, pick_mode="dense")),
    "per_template": ((1, 2), "pair", "conditioned", dict(outputs="full")),
    "tile8_pack": ((1, 2), "fin", "raw", dict(outputs="picks", pick_tile=8,
                                              pick_method="pack", max_peaks=64)),
    "mesh2x2": ((2, 2), "fin", "raw", dict(outputs="full")),
}
#: the JAX step each case is held to (the tiling and the pack method change
#: no pick where no row saturates: JAX's own invariance test)
JAX_OF = {"tile8_pack": "picks_raw"}


def _scenes():
    out = {}
    for wire in ("raw", "conditioned"):
        blocks = []
        for b in range(B):
            calls = [SyntheticCall(t0=1.0 + b, x0_m=(NX / 2 + 5 * b) * 2.042, amplitude=2.0)]
            scene = SyntheticScene(nx=NX, ns=NS, noise_rms=0.05, seed=11 + b, calls=calls)
            raw = to_raw_counts(synthesize_scene(scene), scene.metadata)
            if wire == "raw":
                blocks.append(raw)
            else:
                blocks.append(((raw - raw.mean(axis=1, keepdims=True))
                               * scene.metadata.scale_factor).astype(np.float32))
        out[wire] = np.stack(blocks)
    return scene.metadata, out


def _designs(meta):
    with jax.enable_x64(False):
        out = {}
        for name, bank in (("fin", "fin"), ("pair", PAIR)):
            d = jdesign((NX, NS), [0, NX, 1], meta, templates=bank)
            out[name] = (d, {f: np.array(getattr(d, f)) if not isinstance(
                getattr(d, f), (str, tuple, int, float)) else getattr(d, f)
                for f in convert.DESIGN_FIELDS})
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    meta, blocks = _scenes()
    designs = _designs(meta)
    cases = {2: [], 4: []}
    for name, (shape, bank, wire, kw) in CASES.items():
        kw = dict(kw, **({"wire": "raw", "scale_factor": meta.scale_factor}
                         if wire == "raw" else {}))
        cases[shape[0] * shape[1]].append(dict(
            name=name, fn="mf_step", shape=shape, axis_names=("file", "channel"),
            args=dict(design=designs[bank][1], batch=blocks[wire], kw=kw)))
    cases[2].append(dict(name="adaptive", fn="adaptive", shape=(1, 2),
                         axis_names=("file", "channel"),
                         args=dict(design=designs["fin"][1], batch=blocks["conditioned"],
                                   kw={}, saturate_rank=0)))
    with ThreadPoolExecutor(2) as ex:
        futs = {p: ex.submit(run_pool, cases[p], p, tmp_path_factory.mktemp(f"mf{p}"))
                for p in (2, 4)}
        jax_out = _jax_side(meta, blocks, designs)
        ranks = {p: f.result() for p, f in futs.items()}
    return meta, blocks, designs, jax_out, ranks


def _jmesh(shape):
    n = shape[0] * shape[1]
    return jmake_mesh(shape=shape, axis_names=("file", "channel"), devices=jax.devices()[:n])


def _np_tree(x):
    return jax.tree_util.tree_map(lambda a: np.array(a), x)


def _jax_side(meta, blocks, designs):
    out = {}
    with jax.enable_x64(False):
        for name, (shape, bank, wire, kw) in CASES.items():
            if name in JAX_OF:
                continue
            mesh = _jmesh(shape)
            kw = dict(kw, **({"wire": "raw", "scale_factor": meta.scale_factor}
                             if wire == "raw" else {}))
            step = jstep(designs[bank][0], mesh, **kw)
            x = jax.device_put(jnp.asarray(blocks[wire]), jinput_sharding(mesh))
            out[name] = _np_tree(step(x))
        mesh = _jmesh((1, 2))
        k0, full = jcampaign._adaptive_sharded_steps(jstep, designs["fin"][0], mesh)
        x = jax.device_put(jnp.asarray(blocks["conditioned"]), jinput_sharding(mesh))
        sp, thres = full(x)        # the rerun every rank of the port takes
        out["adaptive"] = (_np_tree(sp), np.array(thres),
                           bool(np.array(k0(x)[0].saturated).sum()))
    return out


def _picks_of(positions, selected, t, b):
    return tpeaks.sparse_to_pick_times(np.asarray(positions)[t, b], np.asarray(selected)[t, b])


def _check_picks(meta, design, x, wire, fused, jpicks, tpicks, thr, names):
    det = MatchedFilterDetector.from_design(design, meta, wire=wire, fused_bandpass=fused,
                                            device="cpu")
    total = 0
    for b in range(B):
        env = envelopes(det, x[b])
        for t, name in enumerate(names):
            a = _picks_of(jpicks.positions, jpicks.selected, t, b)
            g = _picks_of(tpicks["positions"], tpicks["selected"], t, b)
            bad = unexplained_differences(a, g, env[t], float(thr[t, b]))
            assert not bad, f"file {b} {name}: picks differ beyond rounding at {bad[:10]}"
            total += g.shape[1]
    assert total > 0, "parity over an empty pick set proves nothing"


def _thresholds(thres, factors, scope):
    """``[nT, B]`` factored thresholds from a step's pre-factor base."""
    base = np.asarray(thres, np.float32)
    if scope != "per_template":
        base = np.broadcast_to(base[None, :], (len(factors), B))
    return base * np.asarray(factors, np.float32)[:, None]


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_jax(world, name):
    meta, blocks, designs, jax_out, ranks = world
    shape, bank, wire, kw = CASES[name]
    p = shape[0] * shape[1]
    jd, dd = designs[bank]
    design = convert.design_from_arrays(dd)
    got = ranks[p][0][name]
    for r in range(1, p):      # every rank gathers the same global outputs
        np.testing.assert_array_equal(ranks[p][r][name]["thres"], got["thres"])
    jres = jax_out[JAX_OF.get(name, name)]
    jpicks, jthres = jres[-2], jres[-1]
    np.testing.assert_allclose(got["thres"], jthres, rtol=REL)
    if kw.get("outputs") == "full":
        for i, key in enumerate(("trf_fk", "corr", "env")):
            want = jres[i]
            np.testing.assert_allclose(got[key], want, rtol=0, atol=REL * np.abs(want).max())
    factors, scope = design.resolve_threshold_policy()
    thr = _thresholds(got["thres"], factors, scope)
    fused = kw.get("fused_bandpass", True)
    if kw.get("pick_mode") == "dense":
        det = MatchedFilterDetector.from_design(design, meta, wire=wire, fused_bandpass=fused,
                                                device="cpu")
        for b in range(B):
            env = envelopes(det, blocks[wire][b])
            for t in range(len(design.template_names)):
                flips = np.argwhere(got["mask"][t, b] != jpicks[t, b])
                bad = unexplained_differences(flips.T[:, :0], flips.T, env[t], float(thr[t, b]))
                assert not bad, f"dense mask flips beyond rounding at {bad[:10]}"
        assert got["mask"].any()
        return
    _check_picks(meta, design, blocks[wire], wire, fused, jpicks, got["picks"], thr,
                 design.template_names)
    if name not in JAX_OF:
        np.testing.assert_array_equal(got["picks"]["saturated"], np.asarray(jpicks.saturated))
    else:
        assert not got["picks"]["saturated"].any()


def test_escalation_runs_in_lockstep(world):
    """Rank 0's K0 rows are flagged saturated, rank 1's are not; the MAX
    over the mesh makes BOTH ranks rerun at full capacity, once, and the
    picks are JAX's full-capacity step's."""
    meta, blocks, designs, jax_out, ranks = world
    for r in range(2):
        got = ranks[2][r]["adaptive"]
        assert got["escalated"] and got["full_calls"] == 1
    assert ranks[2][0]["adaptive"]["sat_k0"] and not ranks[2][1]["adaptive"]["sat_k0"]
    jsp, jthres, jsat = jax_out["adaptive"]
    assert not jsat               # on its own the scene would not escalate
    got = ranks[2][0]["adaptive"]
    np.testing.assert_allclose(got["thres"], jthres, rtol=REL)
    design = convert.design_from_arrays(designs["fin"][1])
    thr = _thresholds(got["thres"], *design.resolve_threshold_policy())
    _check_picks(meta, design, blocks["conditioned"], "conditioned", True, jsp, got["picks"],
                 thr, design.template_names)
