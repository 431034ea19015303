"""Port parity, the campaigns over a mesh: ``run_campaign_sharded`` at
``(file=2, channel=1)`` and, on the raw wire, ``(file=1, channel=2)``, and
``run_campaign_multiprocess`` over a world of two gloo CPU ranks, against
the JAX package's ``run_campaign_sharded`` on CPU meshes of the same
shapes; the streams' ``stream_file_batches`` tail policies; and ``campaign
--sharded`` in a world of one (the command line, in process) against
JAX's.

The file set: four clean OptaSense files of 64 x 1000 samples and a
corrupt one (``failed`` at the probe). The port's ranks run the JAX
design, from the checkpoint JAX's ``save_design`` wrote (``design=``).
Contract: manifests equal record by record (path, status, rung, family,
attempts, error; not wall times), a resume settles nothing, only rank 0
writes, and pick sets equal up to rounding knife edges of the port's
envelopes (``utils.parity``).
"""

from __future__ import annotations

import os
import warnings
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

from das4whales_tpu.__main__ import main as jmain
from das4whales_tpu.io.synth import SyntheticCall, SyntheticScene, write_synthetic_file
from das4whales_tpu.models.matched_filter import MatchedFilterDetector as JaxDetector
from das4whales_tpu.parallel.mesh import make_mesh as jmake_mesh
from das4whales_tpu.utils import artifacts as jartifacts
from das4whales_tpu.utils.checkpoint import save_design as jsave_design
from das4whales_tpu.workflows import campaign as jcampaign
from das4whales_tpu_torch.__main__ import main as tmain
from das4whales_tpu_torch.io.stream import stream_file_batches, stream_strain_blocks
from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector
from das4whales_tpu_torch.utils.checkpoint import load_design
from das4whales_tpu_torch.utils.parity import envelopes, unexplained_differences
from das4whales_tpu_torch.workflows import campaign
from torch_mesh_worker import run_pool
from tests.torch_threads import one_torch_thread  # noqa: F401

NX, NS = 64, 1000
SEL = [0, NX, 1]
CLEAN = ("f0", "f1", "f2", "f3")
ORDER = ("f0", "f1", "bad", "f2", "f3")
#: name -> (JAX mesh shape, port case, campaign kwargs)
RUNS = {
    "sharded_files": ((2, 1), "campaign_sharded", {}),
    "sharded_channels_raw": ((1, 2), "campaign_sharded", {"wire": "raw"}),
    "multiprocess": ((2, 1), "campaign_multiprocess", {}),
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("camp_sharded")
    paths = {}
    for k, name in enumerate(CLEAN):
        scene = SyntheticScene(nx=NX, ns=NS, noise_rms=0.05, seed=400 + k, calls=[
            SyntheticCall(t0=0.8 + 0.4 * k, x0_m=(16 + 8 * k) * 2.042, amplitude=2.0)])
        paths[name] = write_synthetic_file(str(d / f"{name}.h5"), scene)
    (d / "bad.h5").write_bytes(b"\x00 not an hdf5 file " * 64)
    paths["bad"] = str(d / "bad.h5")
    meta = SyntheticScene(nx=NX, ns=NS).metadata
    with jax.enable_x64(False):
        jd = JaxDetector(meta, SEL, (NX, NS), pick_mode="sparse", keep_correlograms=False,
                         mf_engine="fft", fk_engine="fft")
        ckpt = jsave_design(str(d / "design.npz"), jd.design)
    files = [paths[n] for n in ORDER]
    cases = []
    for name, (shape, fn, kw) in RUNS.items():
        args = dict(files=files, sel=SEL, outdir=str(d / f"t_{name}"),
                    kw=dict(kw, design=ckpt))
        if fn == "campaign_multiprocess":
            args["kw"] = dict(design=ckpt)
        cases.append(dict(name=name, fn=fn, shape=shape, axis_names=("file", "channel"),
                          args=args))
    for tail in ("pad", "drop"):
        cases.append(dict(name=f"stream_{tail}", fn="stream", shape=(2, 1),
                          axis_names=("file", "channel"),
                          args=dict(files=[paths[n] for n in CLEAN[:3]], sel=SEL, batch=2,
                                    tail=tail)))
    with ThreadPoolExecutor(1) as ex:
        fut = ex.submit(run_pool, cases, 2, d / "pool")
        jax_out = {}
        with jax.enable_x64(False):
            for name, (shape, _fn, kw) in RUNS.items():
                mesh = jmake_mesh(shape=shape, axis_names=("file", "channel"),
                                  devices=jax.devices()[:2])
                jcampaign.run_campaign_sharded(files, SEL, str(d / f"j_{name}"), mesh,
                                               elastic=False, **kw)
                jax_out[name] = str(d / f"j_{name}")
        ranks = fut.result()
    return dict(dir=d, paths=paths, files=files, meta=meta, ckpt=ckpt, jax=jax_out,
                ranks=ranks)


def _manifest(outdir):
    return jartifacts.read_records(os.path.join(str(outdir), "manifest.jsonl"))


def _norm(rec):
    out = {k: v for k, v in rec.items() if k not in ("wall_s", "span_id", "n_picks", "health")}
    for key in ("picks_file", "path"):
        if out.get(key):
            out[key] = os.path.basename(out[key])
    return out


def _same_picks(world, port_recs, jax_recs, wire="conditioned"):
    design = load_design(world["ckpt"])
    det = MatchedFilterDetector.from_design(design, world["meta"], device="cpu")
    total = 0
    for pr, jr in zip(port_recs, jax_recs):
        if pr["status"] != "done":
            continue
        blk = next(stream_strain_blocks([pr["path"]], SEL, as_numpy=True))
        env = envelopes(det, blk.trace)
        tp = campaign.load_picks(pr["picks_file"])
        jp = jcampaign.load_picks(jr["picks_file"])
        with np.load(pr["picks_file"]) as z:
            tthr = dict(zip(z["template_names"].tolist(), z["thresholds"].tolist()))
        with np.load(jr["picks_file"]) as z:
            jthr = dict(zip(z["template_names"].tolist(), z["thresholds"].tolist()))
        for i, name in enumerate(design.template_names):
            thr = tthr[name]
            np.testing.assert_allclose(thr, jthr[name], rtol=1e-5)
            bad = unexplained_differences(jp[name], tp[name], env[i], thr)
            assert not bad, f"{os.path.basename(pr['path'])} {name}: {bad[:10]}"
            total += tp[name].shape[1]
    assert total > 0


@pytest.mark.parametrize("name", list(RUNS))
def test_mesh_campaign_matches_jax_record_for_record(world, name):
    tdir = world["dir"] / f"t_{name}"
    # the first run's records (a resume follows in the sharded cases)
    trecs, jrecs = _manifest(tdir)[:len(ORDER)], _manifest(world["jax"][name])
    rung = "multihost" if name == "multiprocess" else "sharded"
    # JAX's multi-process campaign needs a multi-process JAX runtime: its
    # oracle is the sharded campaign on the same mesh, whose rung is named
    # "sharded"
    assert [_norm(r) for r in trecs] == [_norm(dict(r, rung=rung) if r.get("rung") else r)
                                         for r in jrecs]
    assert [r["status"] for r in trecs] == ["failed"] + ["done"] * 4    # the probe first
    assert all(r["rung"] == rung for r in trecs if r["status"] == "done")
    _same_picks(world, [r for r in trecs if "path" in r], [r for r in jrecs if "path" in r])
    # every rank returned the same records; only rank 0 wrote (one line a file)
    a, b = (world["ranks"][r][name]["records"] for r in range(2))
    assert [(x["path"], x["status"], x["n_picks"]) for x in a] == \
        [(x["path"], x["status"], x["n_picks"]) for x in b]
    assert len(jrecs) == len(ORDER)


@pytest.mark.parametrize("name", ["sharded_files", "sharded_channels_raw"])
def test_a_resume_settles_nothing(world, name):
    for r in range(2):
        resume = world["ranks"][r][name]["resume"]
        assert [x["status"] for x in resume] == ["skipped"] * 4 + ["failed"]
    assert len(_manifest(world["dir"] / f"t_{name}")) == len(ORDER) + 1   # bad.h5 again


@pytest.mark.parametrize("tail", ["pad", "drop"])
def test_stream_file_batches_tail_policies_on_a_mesh(world, tail):
    """Three files, batch 2 over a (file=2) mesh: each rank reads its own
    slot; ``pad`` yields a second batch with one real file, ``drop`` only
    the first."""
    got = world["ranks"][0][f"stream_{tail}"]["batches"]
    mine = [n for _stack, n in got]
    assert mine == ([1, 1] if tail == "pad" else [1])
    assert [n for _s, n in world["ranks"][1][f"stream_{tail}"]["batches"]] == \
        ([1, 0] if tail == "pad" else [1])
    want = [next(stream_strain_blocks([world["paths"][n]], SEL, as_numpy=True)).trace
            for n in CLEAN[:3]]
    np.testing.assert_array_equal(got[0][0], np.stack(want[:2]))
    if tail == "pad":
        np.testing.assert_array_equal(got[1][0][0], want[2])
        assert not got[1][0][1].any()


def test_stream_file_batches_without_a_mesh(world):
    files = [world["paths"][n] for n in CLEAN[:3]]
    with pytest.raises(ValueError, match="tail='error'"):
        stream_file_batches(files, SEL, batch=2, tail="error", device="cpu")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = list(stream_file_batches(files, SEL, batch=2, tail="drop", device="cpu"))
    assert len(out) == 1 and "dropping 1" in str(w[0].message)
    (stack, blocks), = out
    assert tuple(stack.shape) == (2, NX, NS) and len(blocks) == 2
    with pytest.raises(ValueError, match="batch must be"):
        stream_file_batches(files, SEL, batch=0)


def test_campaign_sharded_verb_in_a_world_of_one(world, tmp_path, capsys):
    """``campaign --sharded`` without torchrun's variables is a mesh of
    one; its records match JAX's ``--sharded`` run (on JAX's 8-device
    channel mesh) and its picks match up to knife edges."""
    files = [world["paths"][n] for n in ("f0", "bad", "f1")]
    rt = tmain(["campaign", *files, "--sharded", "--device", "cpu", "--no-figure",
                "--outdir", str(tmp_path / "t")])
    out = capsys.readouterr().out
    with jax.enable_x64(False):
        rj = jmain(["campaign", *files, "--sharded", "--outdir", str(tmp_path / "j")])
    assert rt == rj == 3                       # one file failed
    assert "campaign: 2 done, 1 failed, 0 skipped" in out
    assert (tmp_path / "t" / "summary.json").exists()
    assert not (tmp_path / "t" / "density.png").exists()
    trecs, jrecs = _manifest(tmp_path / "t"), _manifest(tmp_path / "j")
    assert [_norm(r) for r in trecs] == [_norm(r) for r in jrecs]
    assert tmain(["campaign", *files, "--sharded", "--bank", "fin", "--device", "cpu"]) == 2
