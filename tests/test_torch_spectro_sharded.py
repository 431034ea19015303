"""Port parity, the spectro family over a device mesh:
``parallel.spectro.make_sharded_spectro_step`` on a ``(file=1,
channel=2)`` mesh and ``make_sharded_spectro_step_time`` on a ``(time=2)``
mesh of gloo CPU ranks, against the JAX package's on CPU meshes of the
same shape (float32), both ``outputs``.

The scene is JAX's time-split test's size (32 x 6400 at 200 Hz, so that
the hop of 8 samples divides each rank's 3200), with one call inside a
shard and one straddling the shard boundary at sample 3200. The ranks
run once a module (``tests/torch_mesh_worker.py``); each test asserts
one case. Contract: correlograms within 1e-5·max of JAX's (shard
boundaries included); picks equal up to rounding knife edges of the
port's own correlograms (``utils.parity.unexplained_differences``). The
factories' validation errors are JAX's.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from das4whales_tpu.config import AcquisitionMetadata as JMeta
from das4whales_tpu.parallel import spectro as jsp
from das4whales_tpu.parallel.mesh import make_mesh as jmake_mesh
from das4whales_tpu_torch.config import AcquisitionMetadata
from das4whales_tpu_torch.ops import peaks as tpeaks
from das4whales_tpu_torch.parallel import spectro as tsp
from das4whales_tpu_torch.parallel.mesh import Mesh
from das4whales_tpu_torch.utils.parity import unexplained_differences
from torch_mesh_worker import run_pool
from tests.torch_threads import one_torch_thread  # noqa: F401

P = 2
NX, NS, B = 32, 6400, 2
META = dict(fs=200.0, dx=2.042, nx=NX, ns=NS)
REL = 1e-5
THR = 14.0
#: case -> (step, mesh shape, axis names, outputs)
CASES = {
    "channel_full": ("spectro_step", (1, P), ("file", "channel"), "full"),
    "channel_picks": ("spectro_step", (1, P), ("file", "channel"), "picks"),
    "time_full": ("spectro_step_time", (P,), ("time",), "full"),
    "time_picks": ("spectro_step_time", (P,), ("time",), "picks"),
}


def _chirp():
    t = np.arange(0, 0.68, 1 / 200.0)
    sing = -17.8 * 0.68 / (28.8 - 17.8)
    return (np.cos(2 * np.pi * (-sing * 28.8) * np.log(np.abs(1 - t / sing)))
            * np.hanning(len(t))).astype(np.float32)


def _batch():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, NX, NS)).astype(np.float32) * 1e-9
    c = _chirp()
    for f, (ch, onset) in enumerate(((16, 1000), (8, 3150))):
        x[f, ch, onset:onset + len(c)] += 5e-9 * c
        x[f, 31 - ch, 3150:3150 + len(c)] += 4e-9 * c     # straddles the boundary
    return x


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    x = _batch()
    cases = []
    for name, (fn, shape, axes, outputs) in CASES.items():
        args = dict(meta=META, kw=dict(outputs=outputs))
        args.update(batch=x) if fn == "spectro_step" else args.update(record=x[1])
        cases.append(dict(name=name, fn=fn, args=args, shape=shape, axis_names=axes))
    with ThreadPoolExecutor(1) as ex:
        fut = ex.submit(run_pool, cases, P, tmp_path_factory.mktemp("spectro"))
        jax_out = _jax_side(x)
        ranks = fut.result()
    return dict(x=x, jax=jax_out, ranks=ranks)


def _jax_side(x):
    meta = JMeta(**META)
    out = {}
    with jax.enable_x64(False):
        for name, (fn, shape, axes, outputs) in CASES.items():
            m = jmake_mesh(shape=shape, axis_names=axes, devices=jax.devices()[:P])
            if fn == "spectro_step":
                step, names = jsp.make_sharded_spectro_step(meta, m, outputs=outputs)
                res = step(jnp.asarray(x))
            else:
                step, names = jsp.make_sharded_spectro_step_time(meta, m, outputs=outputs)
                res = step(jnp.asarray(x[1]))
            out[name] = (names, jax.tree_util.tree_map(np.array, res))
    return out


def _corr_one_rank(name, x):
    """The port's own correlograms of the case at a mesh of one (the
    knife-edge margin)."""
    fn, _, axes, _ = CASES[name]
    meta = AcquisitionMetadata(**META)
    if fn == "spectro_step":
        m = Mesh(axes, (1, 1), np.zeros((1, 1), int), 0, torch.device("cpu"), None)
        return tsp.make_sharded_spectro_step(meta, m)[0](torch.from_numpy(x))[0].numpy()
    m = Mesh(axes, (1,), np.zeros(1, int), 0, torch.device("cpu"), None)
    return tsp.make_sharded_spectro_step_time(meta, m)[0](torch.from_numpy(x[1]))[0].numpy()


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_spectro_steps_match_jax(world, name):
    fn, _, _, outputs = CASES[name]
    names, res = world["jax"][name]
    jpicks = res if outputs == "picks" else res[1]
    got = world["ranks"][0][name]
    assert tuple(got["names"]) == tuple(names) == ("HF", "LF")
    for r in range(1, P):
        for f in ("positions", "selected"):
            np.testing.assert_array_equal(world["ranks"][r][name]["picks"][f], got["picks"][f])
    if outputs == "full":
        want = res[0]
        assert got["corr"].shape == want.shape
        np.testing.assert_allclose(got["corr"], want, rtol=0, atol=REL * np.abs(want).max())
    corr = _corr_one_rank(name, world["x"])
    lead = [(slice(None),)] if fn == "spectro_step_time" else [(slice(None), b)
                                                               for b in range(B)]
    total = 0
    for t in range(len(names)):
        for idx in lead:
            sel = (t,) + idx[1:]
            a = tpeaks.sparse_to_pick_times(jpicks.positions[sel], jpicks.selected[sel])
            g = tpeaks.sparse_to_pick_times(got["picks"]["positions"][sel],
                                            got["picks"]["selected"][sel])
            assert not unexplained_differences(a, g, corr[sel], THR), (name, t, idx)
            total += g.shape[1]
    assert total > 0


def test_the_straddling_call_is_picked_by_the_time_split_step(world):
    got = world["ranks"][0]["time_full"]["picks"]
    hf = tpeaks.sparse_to_pick_times(got["positions"][0], got["selected"][0])
    # the frame of the call's onset, 3150 samples, at a hop of 8
    for ch in (8, 23):
        assert np.any(np.abs(hf[1][hf[0] == ch] - 3150 // 8) < 60), ch


def test_validation_errors_are_jaxs():
    """The time-split factory's divisibility checks and the outputs
    check, on meshes of two (no rank is started: they raise first)."""
    m2 = Mesh(("time",), (P,), np.arange(P), 0, torch.device("cpu"), None)
    with jax.enable_x64(False):
        jm2 = jmake_mesh(shape=(P,), axis_names=("time",), devices=jax.devices()[:P])
        for ns, match in ((6401, "divisible"), (6404, "MULTIPLE of the frame hop"),
                          (160, "halo")):
            for fac, mesh, Meta in ((jsp.make_sharded_spectro_step_time, jm2, JMeta),
                                    (tsp.make_sharded_spectro_step_time, m2,
                                     AcquisitionMetadata)):
                with pytest.raises(ValueError, match=match):
                    fac(Meta(**dict(META, ns=ns)), mesh)
        for fac, mesh, Meta in ((jsp.make_sharded_spectro_step, jm2, JMeta),
                                (tsp.make_sharded_spectro_step, m2, AcquisitionMetadata),
                                (jsp.make_sharded_spectro_step_time, jm2, JMeta),
                                (tsp.make_sharded_spectro_step_time, m2, AcquisitionMetadata)):
            with pytest.raises(ValueError, match="outputs"):
                fac(Meta(**META), mesh, outputs="both")
