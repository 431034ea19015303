"""Port parity, the learned family over a device mesh:
``models.learned.make_sharded_train_step`` and ``fit(mesh=...)`` on a
``(batch=2)`` mesh and ``make_sharded_inference`` on a ``(channel=2)``
mesh of gloo CPU ranks, against the JAX package's on CPU meshes of the
same shape (float32), and the three entries on a mesh of one in this
process.

The scenes are ``tests/test_learned.py``'s (32 x 3000 at 8 m). Contract
(``test_torch_learned.py``'s tolerances): five data-parallel AdamW steps
from JAX's initial parameters on identical windows — losses within
``LOSS_REL``, parameters within ``PARAM_ABS``, and the replicas bitwise
equal on both ranks; ``fit``'s loss history within ``FIT_REL`` (the
packages' features differ by their STFT engines) with bitwise replicas;
the sharded scores within ``SCORE_ABS`` of JAX's (both on the rFFT
engine, which JAX's sharded inference fixes) and of the port's
one-device scores on that engine.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from das4whales_tpu.io.synth import SyntheticCall, SyntheticScene, synthesize_scene
from das4whales_tpu.models import learned as jl
from das4whales_tpu.parallel.mesh import make_mesh as jmake_mesh
from das4whales_tpu_torch import convert
from das4whales_tpu_torch.models import learned as tl
from das4whales_tpu_torch.parallel.mesh import make_mesh
from torch_mesh_worker import run_pool
from tests.torch_threads import one_torch_thread  # noqa: F401

P = 2
LOSS_REL = 1e-5
PARAM_ABS = 1e-5
FIT_REL = 1e-3
SCORE_ABS = 1e-5
STEPS, ROWS, SEED = 5, 128, 3
FIT = dict(epochs=4, batch=512, seed=0)
CFG = tl.LearnedConfig()
JCFG = jl.LearnedConfig()


def _scene(seed, amps, nx=32, ns=3000):
    calls = [SyntheticCall(t0=3.0 + 4.5 * k, x0_m=100.0 + 60 * k, amplitude=a)
             for k, a in enumerate(amps)]
    return SyntheticScene(nx=nx, ns=ns, dx=8.0, noise_rms=0.08, calls=calls, seed=seed)


def _as_dict(scene) -> dict:
    d = dataclasses.asdict(scene)
    d["calls"] = [dict(c) for c in d["calls"]]
    return d


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    scene = _scene(7, [0.9])
    with jax.enable_x64(False):
        win, centers = jl.window_features(synthesize_scene(scene).astype(np.float32), JCFG,
                                          engine="rfft")
        x = np.array(win).reshape(-1, 32, 8)[:STEPS * ROWS]
        y = np.asarray(jl.window_labels(scene, np.asarray(centers), JCFG)).reshape(-1)[
            :STEPS * ROWS].astype(np.float32)
    train = [_scene(s, [0.6, 0.9]) for s in range(2)]
    model, _ = tl.load_pretrained()
    params = convert.learned_params_to_arrays(model)
    block = synthesize_scene(_scene(55, [0.8])).astype(np.float32)
    cases = [dict(name="train", fn="learned_train", shape=(P,), axis_names=("batch",),
                  args=dict(x=x, y=y, steps=STEPS, rows=ROWS, seed=SEED)),
             dict(name="fit", fn="learned_fit", shape=(P,), axis_names=("batch",),
                  args=dict(scenes=[_as_dict(s) for s in train], kw=FIT)),
             dict(name="infer", fn="learned_inference", shape=(P,), axis_names=("channel",),
                  args=dict(params=params, block=block))]
    with ThreadPoolExecutor(1) as ex:
        fut = ex.submit(run_pool, cases, P, tmp_path_factory.mktemp("learned"))
        jax_out = _jax_side(x, y, train, params, block)
        ranks = fut.result()
    return dict(x=x, y=y, train=train, params=params, block=block, jax=jax_out, ranks=ranks)


def _jax_side(x, y, train, params, block):
    out = {}
    with jax.enable_x64(False):
        bm = jmake_mesh(shape=(P,), axis_names=("batch",), devices=jax.devices()[:P])
        p, o, tx = jl.init_train_state(JCFG, seed=SEED)
        step, put = jl.make_sharded_train_step(bm)
        losses = []
        for s in range(STEPS):
            wb, lb = put(x[ROWS * s:ROWS * (s + 1)], y[ROWS * s:ROWS * (s + 1)])
            p, o, loss = step(p, o, tx, wb, lb)
            losses.append(float(loss))
        out["train"] = (losses, {k: {kk: np.array(v) for kk, v in sub.items()}
                                 for k, sub in p.items()})
        _, out["fit"] = jl.fit(JCFG, train, mesh=bm, **FIT)
        cm = jmake_mesh(shape=(P,), axis_names=("channel",), devices=jax.devices()[:P])
        jparams = jax.tree_util.tree_map(jnp.asarray, params)
        score_fn, put = jl.make_sharded_inference(jparams, JCFG, cm)
        out["infer"] = np.array(score_fn(put(block)))
    return out


def _assert_params(got, want, atol):
    for k in want:
        for kk in want[k]:
            np.testing.assert_allclose(got[k][kk], want[k][kk], rtol=0, atol=atol)


def _assert_bitwise_replicas(ranks, name):
    a, b = ranks[0][name]["params"], ranks[1][name]["params"]
    for k in a:
        for kk in a[k]:
            np.testing.assert_array_equal(a[k][kk], b[k][kk])


def test_sharded_train_step_matches_jax(world):
    jlosses, jparams = world["jax"]["train"]
    got = world["ranks"][0]["train"]
    assert got["local_rows"] == ROWS // P
    np.testing.assert_allclose(got["losses"], jlosses, rtol=LOSS_REL)
    assert world["ranks"][1]["train"]["losses"] == got["losses"]
    _assert_params(got["params"], jparams, PARAM_ABS)
    _assert_bitwise_replicas(world["ranks"], "train")


def test_fit_over_a_mesh_matches_jax(world):
    got = world["ranks"][0]["fit"]
    assert len(got["history"]) == FIT["epochs"]
    np.testing.assert_allclose(got["history"], world["jax"]["fit"], rtol=FIT_REL)
    assert world["ranks"][1]["fit"]["history"] == got["history"]
    _assert_bitwise_replicas(world["ranks"], "fit")
    assert got["history"][-1] < got["history"][0]


def test_sharded_inference_matches_jax_and_one_device(world):
    got = world["ranks"][0]["infer"]["scores"]
    want = world["jax"]["infer"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_ABS)
    np.testing.assert_array_equal(world["ranks"][1]["infer"]["scores"], got)
    det = tl.LearnedDetector(world["params"], CFG, device="cpu")
    win, _ = tl.window_features(torch.from_numpy(world["block"]), CFG, engine="rfft")
    one = tl.score_windows(det.model, win.reshape(-1, *win.shape[-2:])).reshape(
        win.shape[:2]).numpy()
    np.testing.assert_allclose(got, one, rtol=0, atol=SCORE_ABS)


def test_the_entries_on_a_mesh_of_one_are_the_one_device_routes(world):
    """Without ranks a mesh is one device and its collectives identities:
    the sharded step is ``train_step``, ``fit(mesh=)`` is ``fit``, the
    sharded scores are the one-device scores."""
    m1 = make_mesh(shape=(1,), axis_names=("batch",), devices=["cpu"])
    x, y = world["x"], world["y"]
    a, oa = tl.init_train_state(CFG, seed=SEED, device="cpu")
    b, ob = tl.init_train_state(CFG, seed=SEED, device="cpu")
    step, put = tl.make_sharded_train_step(m1)
    for s in range(2):
        sl = slice(ROWS * s, ROWS * (s + 1))
        a, oa, la = tl.train_step(a, oa, torch.from_numpy(x[sl]), torch.from_numpy(y[sl]))
        b, ob, lb = step(b, ob, *put(x[sl], y[sl]))
        assert float(la) == float(lb)
    _assert_params(convert.learned_params_to_arrays(b), convert.learned_params_to_arrays(a), 0)
    _, h1 = tl.fit(CFG, world["train"], epochs=1, batch=512, device="cpu")
    _, hm = tl.fit(CFG, world["train"], epochs=1, batch=512, mesh=m1)
    assert h1 == hm
    cm = make_mesh(shape=(1,), axis_names=("channel",), devices=["cpu"])
    score_fn, put = tl.make_sharded_inference(world["params"], CFG, cm)
    # the CPU's convolution picks its algorithm by the batch's size
    np.testing.assert_allclose(score_fn(put(world["block"])).numpy(),
                               world["ranks"][0]["infer"]["scores"], rtol=0, atol=SCORE_ABS)
