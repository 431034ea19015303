"""Port parity, the Gabor family over a device mesh:
``parallel.gabor.make_sharded_gabor_step`` on a ``(file=2)`` mesh and
``make_sharded_gabor_step_time`` on a ``(time=2)`` mesh of gloo CPU ranks,
against the JAX package's on CPU meshes of the same shape (float32), on
JAX's design and float32 notes (``convert.gabor_detector_to_arrays``:
with x64 off JAX synthesizes its notes in float32).

Scenes: JAX's own tests' (``tests/test_gabor_sharded.py``, two 64 x 2000
files; ``tests/test_gabor_timeshard.py``, 256 x 4096 with moveout calls,
one straddling the shard boundary, at ``bin_factor=0.5, ksize=6`` and
thresholds 2000 / 10). Contract: correlograms within 1e-5·max of JAX's;
thresholds rtol 1e-5; picks equal up to rounding knife edges of the
port's own envelopes (``utils.parity.unexplained_differences``). The
factories' validation errors are JAX's, among them the binning grain:
at P = 2 the canonical 22050 channels fail it (11025 x 0.1).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from das4whales_tpu.config import AcquisitionMetadata as JMeta
from das4whales_tpu.models.gabor import GaborDetector as JGaborDetector
from das4whales_tpu.parallel import gabor as jgb
from das4whales_tpu.parallel.mesh import make_mesh as jmake_mesh
from das4whales_tpu_torch import convert
from das4whales_tpu_torch.config import AcquisitionMetadata
from das4whales_tpu_torch.ops import peaks as tpeaks
from das4whales_tpu_torch.ops import spectral
from das4whales_tpu_torch.parallel import gabor as tgb
from das4whales_tpu_torch.parallel.mesh import Mesh
from das4whales_tpu_torch.utils.parity import unexplained_differences
from torch_mesh_worker import run_pool
from tests.torch_threads import one_torch_thread  # noqa: F401

P = 2
REL = 1e-5
FILE = dict(fs=200.0, dx=2.042, nx=64, ns=2000)
TIME = dict(fs=200.0, dx=2.042, nx=256, ns=4096)
KW = dict(bin_factor=0.5, ksize=6, threshold1=2000.0, threshold2=10.0)


def _chirp():
    t = np.arange(0, 0.68, 1 / 200.0)
    sing = -17.8 * 0.68 / (28.8 - 17.8)
    return (np.cos(2 * np.pi * (-sing * 28.8) * np.log(np.abs(1 - t / sing)))
            * np.hanning(len(t))).astype(np.float32)


def _files():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((P, FILE["nx"], FILE["ns"])).astype(np.float32) * 1e-9
    c = _chirp()
    for f in range(P):
        x[f, 16 + 4 * f, 400:400 + len(c)] += 5e-9 * c
    return x


def _record():
    rng = np.random.default_rng(9)
    nx, ns = TIME["nx"], TIME["ns"]
    x = rng.standard_normal((nx, ns)).astype(np.float32) * 1e-9
    c = _chirp()
    # moveout across channels; the middle call straddles the shard
    # boundary at sample 2048
    for ch0, onset in ((40, 800), (128, 2000), (200, 3000)):
        for dch in range(-12, 13):
            s = onset + abs(dch) * 4
            if 0 <= ch0 + dch < nx and s + len(c) < ns:
                x[ch0 + dch, s:s + len(c)] += 4e-9 * c
    return x


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    files, record = _files(), _record()
    with jax.enable_x64(False):
        jf = convert.gabor_detector_to_arrays(
            JGaborDetector(JMeta(**FILE), [0, FILE["nx"], 1]))
        jt = convert.gabor_detector_to_arrays(
            JGaborDetector(JMeta(**TIME), [0, TIME["nx"], 1], **KW))
    cases = [dict(name="file", fn="gabor_step", shape=(P,), axis_names=("file",),
                  args=dict(meta=FILE, sel=[0, FILE["nx"], 1], batch=files,
                            kw=dict(fields=jf))),
             dict(name="time_full", fn="gabor_step_time", shape=(P,), axis_names=("time",),
                  args=dict(meta=TIME, sel=[0, TIME["nx"], 1], record=record,
                            kw=dict(KW, fields=jt))),
             dict(name="time_picks", fn="gabor_step_time", shape=(P,), axis_names=("time",),
                  args=dict(meta=TIME, sel=[0, TIME["nx"], 1], record=record,
                            kw=dict(KW, fields=jt, outputs="picks")))]
    with ThreadPoolExecutor(1) as ex:
        fut = ex.submit(run_pool, cases, P, tmp_path_factory.mktemp("gabor"))
        jax_out = _jax_side(files, record)
        ranks = fut.result()
    return dict(files=files, record=record, jf=jf, jt=jt, jax=jax_out, ranks=ranks)


def _jax_side(files, record):
    out = {}
    with jax.enable_x64(False):
        fm = jmake_mesh(shape=(P,), axis_names=("file",), devices=jax.devices()[:P])
        step, names = jgb.make_sharded_gabor_step(JMeta(**FILE), [0, FILE["nx"], 1], fm)
        out["file"] = (names, jax.tree_util.tree_map(np.array, step(
            jax.device_put(jnp.asarray(files), jgb.gabor_input_sharding(fm)))))
        tm = jmake_mesh(shape=(P,), axis_names=("time",), devices=jax.devices()[:P])
        for name, outputs in (("time_full", "full"), ("time_picks", "picks")):
            step, names = jgb.make_sharded_gabor_step_time(
                JMeta(**TIME), [0, TIME["nx"], 1], tm, outputs=outputs, **KW)
            out[name] = (names, jax.tree_util.tree_map(np.array, step(jnp.asarray(record))))
    return out


def _one(axes):
    return Mesh(axes, (1,), np.zeros(1, int), 0, torch.device("cpu"), None)


def _envelopes(corr: np.ndarray) -> np.ndarray:
    return spectral.envelope_sqrt(torch.from_numpy(corr), dim=-1).numpy()


def _assert_picks(names, jpicks, got, env, thr, lead):
    total = 0
    for t, name in enumerate(names):
        for idx in lead:
            sel = (t,) + idx
            a = tpeaks.sparse_to_pick_times(jpicks.positions[sel], jpicks.selected[sel])
            g = tpeaks.sparse_to_pick_times(got["positions"][sel], got["selected"][sel])
            th = float(thr[idx] if np.ndim(thr) else thr) * (0.9 if name == "HF" else 1.0)
            bad = unexplained_differences(a, g, env[sel], th)
            assert not bad, (name, idx, bad)
            total += g.shape[1]
    return total


def test_file_sharded_step_matches_jax(world):
    names, (jc, jp, jthr) = world["jax"]["file"]
    got = world["ranks"][0]["file"]
    assert tuple(got["names"]) == tuple(names)
    np.testing.assert_array_equal(world["ranks"][1]["file"]["thres"], got["thres"])
    np.testing.assert_allclose(got["thres"], jthr, rtol=REL)
    assert got["corr"].shape == jc.shape == (2, P, FILE["nx"], FILE["ns"])
    np.testing.assert_allclose(got["corr"], jc, rtol=0, atol=REL * np.abs(jc).max())
    # the knife-edge margin: the port's own step at a mesh of one
    jf = world["jf"]
    step, _ = tgb.make_sharded_gabor_step(
        AcquisitionMetadata(**FILE), [0, FILE["nx"], 1], _one(("file",)),
        design=convert.gabor_design_from_arrays(jf), note_arrays=jf["notes"])
    env = _envelopes(step(torch.from_numpy(world["files"]))[0].numpy())
    assert _assert_picks(names, jp, got["picks"], env, got["thres"],
                         [(b,) for b in range(P)]) > 0
    # every file's call picked on its channel
    hf = names.index("HF")
    for f in range(P):
        assert got["picks"]["selected"][hf, f, 16 + 4 * f].any(), f


@pytest.mark.parametrize("name", ["time_full", "time_picks"])
def test_time_split_step_matches_jax(world, name):
    names, res = world["jax"][name]
    jp, jthr = res[-2], res[-1]
    got = world["ranks"][0][name]
    assert float(world["ranks"][1][name]["thres"]) == float(got["thres"])
    np.testing.assert_allclose(float(got["thres"]), float(jthr), rtol=REL)
    if name == "time_full":
        jc = res[0]
        np.testing.assert_allclose(got["corr"], jc, rtol=0, atol=REL * np.abs(jc).max())
    jt = world["jt"]
    step, _ = tgb.make_sharded_gabor_step_time(
        AcquisitionMetadata(**TIME), [0, TIME["nx"], 1], _one(("time",)), ksize=KW["ksize"],
        design=convert.gabor_design_from_arrays(jt), note_arrays=jt["notes"])
    env = _envelopes(step(torch.from_numpy(world["record"]))[0].numpy())
    assert _assert_picks(names, jp, got["picks"], env, got["thres"], [()]) > 0
    # the call straddling the boundary at sample 2048 is picked near its centre row
    hf = tpeaks.sparse_to_pick_times(got["picks"]["positions"][0],
                                     got["picks"]["selected"][0])
    assert np.any((np.abs(hf[0] - 128) <= 2) & (np.abs(hf[1] - 2068) < 200))


def test_validation_errors_are_jaxs():
    """Every check of JAX's time-split factory, raised alike on meshes of
    two (no rank is started: they raise first)."""
    m2 = Mesh(("time",), (P,), np.arange(P), 0, torch.device("cpu"), None)
    canonical = dict(fs=200.0, dx=2.042, nx=22050, ns=12000)
    checks = [(TIME, dict(KW, channel_halo=21), "granularity"),
              (TIME, dict(KW, outputs="both"), "outputs"),
              (dict(TIME, nx=255), KW, "divisible"),
              (TIME, dict(KW, channel_halo=128), "must be in"),
              (dict(TIME, nx=250), dict(KW, bin_factor=0.3, channel_halo=21),
               "C/P=125 times bin_factor"),
              (canonical, {}, "C/P=11025 times bin_factor=0.1")]
    with jax.enable_x64(False):
        jm2 = jmake_mesh(shape=(P,), axis_names=("time",), devices=jax.devices()[:P])
        for meta, kw, match in checks:
            for fac, mesh, Meta in ((jgb.make_sharded_gabor_step_time, jm2, JMeta),
                                    (tgb.make_sharded_gabor_step_time, m2,
                                     AcquisitionMetadata)):
                with pytest.raises(ValueError, match=match):
                    fac(Meta(**meta), [0, meta["nx"], 1], mesh, **kw)
