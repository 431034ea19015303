"""Port parity, the elastic mesh downshift: ``run_campaign_sharded(
elastic=True)`` over a world of two gloo CPU ranks at ``(file=1,
channel=2)``, against the JAX package's ``run_campaign_sharded`` on a CPU
mesh of the same shape.

Six clean OptaSense files of 64 x 1000 samples in batches of two; the
ranks run JAX's design (``design=``). Three cases, in one pool of ranks,
each on a process group of its own:

* a non-loss failure: both ranks raise an injected ``RuntimeError`` at
  the second batch; both check in, so the campaign re-raises it on both
  (JAX re-raises when every device probes healthy) and no
  ``mesh_downshift`` is recorded;
* the same failure on rank 1 alone: rank 0 waits in its collective until
  the group's timeout, then checks in within the check-in's wait (the
  timeout plus the probe deadline), so both re-raise and nothing is
  rebuilt;
* a device loss: rank 1 dies (``os._exit``) at the second batch; rank 0's
  next collective fails, rank 1 never checks in, and the survivor goes on
  alone on a ``(1, 1)`` mesh — only the second batch reruns, every file is
  ``done`` once at rung ``sharded``, exactly one ``mesh_downshift``
  event (2 -> 1), ``fsck_outdir`` clean, picks against JAX's up to
  rounding knife edges of the port's envelopes (``utils.parity``).

The probe deadline is cut to 3 s in the ranks
(``campaign._DEVICE_PROBE_DEADLINE_S``, JAX's module-level knob too) and
the process group's collective timeout to ``GROUP_TIMEOUT_S``.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest

from das4whales_tpu.io.synth import SyntheticCall, SyntheticScene, write_synthetic_file
from das4whales_tpu.models.matched_filter import MatchedFilterDetector as JaxDetector
from das4whales_tpu.parallel.mesh import make_mesh as jmake_mesh
from das4whales_tpu.utils.checkpoint import save_design as jsave_design
from das4whales_tpu.workflows import campaign as jcampaign
from das4whales_tpu_torch import fsck
from das4whales_tpu_torch.io.stream import stream_strain_blocks
from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector
from das4whales_tpu_torch.utils.checkpoint import load_design
from das4whales_tpu_torch.utils.parity import envelopes, unexplained_differences
from das4whales_tpu_torch.workflows import campaign
from torch_mesh_worker import run_pool
from tests.torch_threads import one_torch_thread  # noqa: F401

NX, NS, N_FILES = 64, 1000, 6
SEL = [0, NX, 1]
SHAPE = (1, 2)
#: the ranks' collective timeout: the lone failure's peer waits it out
GROUP_TIMEOUT_S = 10.0


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("elastic")
    files = []
    for k in range(N_FILES):
        scene = SyntheticScene(nx=NX, ns=NS, noise_rms=0.05, seed=700 + k, calls=[
            SyntheticCall(t0=0.8 + 0.3 * k, x0_m=(12 + 8 * k) * 2.042, amplitude=2.0)])
        files.append(write_synthetic_file(str(d / f"f{k}.h5"), scene))
    meta = SyntheticScene(nx=NX, ns=NS).metadata
    with jax.enable_x64(False):
        jd = JaxDetector(meta, SEL, (NX, NS), pick_mode="sparse", keep_correlograms=False,
                         mf_engine="fft", fk_engine="fft")
        ckpt = jsave_design(str(d / "design.npz"), jd.design)
    kw = dict(design=ckpt, batch=2)
    ax = dict(shape=SHAPE, axis_names=("file", "channel"))
    cases = [dict(name="healthy", fn="campaign_elastic", args=dict(
                 files=files, sel=SEL, outdir=str(d / "healthy"), kw=kw, fail_at=2), **ax),
             dict(name="alone", fn="campaign_elastic", fresh_group=True, args=dict(
                 files=files, sel=SEL, outdir=str(d / "alone"), kw=kw, fail_at=2, raiser=1),
                  **ax),
             dict(name="loss", fn="campaign_elastic", fresh_group=True, args=dict(
                 files=files, sel=SEL, outdir=str(d / "loss"), kw=kw, fail_at=2, victim=1),
                  **ax)]
    with ThreadPoolExecutor(1) as ex:
        fut = ex.submit(run_pool, cases, 2, d / "pool", timeout_s=GROUP_TIMEOUT_S,
                        expect_rc={1: 3})
        with jax.enable_x64(False):
            mesh = jmake_mesh(shape=SHAPE, axis_names=("file", "channel"),
                              devices=jax.devices()[:2])
            jcampaign.run_campaign_sharded(files, SEL, str(d / "jax"), mesh, elastic=False,
                                           batch=2)
        ranks = fut.result()
    return dict(dir=d, files=files, meta=meta, ckpt=ckpt, ranks=ranks)


def _manifest(outdir):
    from das4whales_tpu_torch.utils import artifacts

    return artifacts.read_records(os.path.join(str(outdir), "manifest.jsonl"))


def test_a_failure_with_every_rank_alive_re_raises(world):
    """Every rank checks in: not a device loss, so each re-raises the
    step's own error and nothing is rebuilt."""
    for r in range(2):
        assert "injected step failure" in world["ranks"][r]["healthy"]["error"], r
    events = [e for e in _manifest(world["dir"] / "healthy") if e.get("event")]
    assert not [e for e in events if e["event"] == "mesh_downshift"]
    done = [r for r in _manifest(world["dir"] / "healthy") if r.get("status") == "done"]
    assert len(done) == 2           # the first batch's files, before the failure


def test_a_failure_on_one_rank_alone_re_raises_on_every_rank(world):
    """Rank 1 fails alone; rank 0, blocked in the batch's collective,
    times out and checks in too: not a device loss, so both raise, no
    rank returns a campaign it did not finish, and nothing is rebuilt."""
    assert "injected step failure" in world["ranks"][1]["alone"]["error"]
    assert world["ranks"][0]["alone"]["error"]         # its collective's timeout
    assert "records" not in world["ranks"][0]["alone"]
    events = [e for e in _manifest(world["dir"] / "alone") if e.get("event")]
    assert not [e for e in events if e["event"] == "mesh_downshift"]


def test_a_lost_rank_downshifts_the_mesh_and_the_survivor_finishes(world):
    got = world["ranks"][0]["loss"]
    assert "loss" not in world["ranks"][1]   # the victim died in that case
    recs = got["records"]
    assert [(os.path.basename(r["path"]), r["status"], r["rung"]) for r in recs] == [
        (f"f{k}.h5", "done", "sharded") for k in range(N_FILES)]
    lines = _manifest(world["dir"] / "loss")
    assert sorted(os.path.basename(r["path"]) for r in lines if "path" in r) == \
        [f"f{k}.h5" for k in range(N_FILES)]     # each file recorded once
    downs = [e for e in got["events"] if e["event"] == "mesh_downshift"]
    assert len(downs) == 1
    assert (downs[0]["from_devices"], downs[0]["to_devices"]) == (2, 1)
    assert "mesh collective" in downs[0]["error"]
    assert not fsck.fsck_outdir(str(world["dir"] / "loss"))
    # picks against JAX's campaign on the same mesh shape, up to knife edges
    design = load_design(world["ckpt"])
    det = MatchedFilterDetector.from_design(design, world["meta"], device="cpu")
    jrecs = {os.path.basename(r["path"]): r for r in _manifest(world["dir"] / "jax")
             if "path" in r}
    total = 0
    for r in recs:
        jr = jrecs[os.path.basename(r["path"])]
        blk = next(stream_strain_blocks([r["path"]], SEL, as_numpy=True))
        env = envelopes(det, blk.trace)
        tp, jp = campaign.load_picks(r["picks_file"]), jcampaign.load_picks(jr["picks_file"])
        with np.load(r["picks_file"]) as z:
            thr = dict(zip(z["template_names"].tolist(), z["thresholds"].tolist()))
        for i, name in enumerate(design.template_names):
            bad = unexplained_differences(jp[name], tp[name], env[i], thr[name])
            assert not bad, f"{os.path.basename(r['path'])} {name}: {bad[:10]}"
            total += tp[name].shape[1]
    assert total > 0
