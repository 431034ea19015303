"""Port parity, the campaign layer: ``run_campaign_batched`` and
``run_campaign`` of das4whales_tpu_torch (``device="cpu"``) against
das4whales_tpu's (float32, x64 off, ``pick_mode="sparse"``,
``mf_engine="fft"``, ``fk_engine="fft"``) on the same files.

The file set: five clean OptaSense files (four of 64 x 1000 samples, one
of 64 x 900), a corrupt one (garbage bytes: ``failed``) and a float32 one
with NaNs (``quarantined``), in one pow2 bucket of 1024 samples. The
port's matched filter runs on the JAX design itself, loaded from the
checkpoint JAX's ``save_design`` wrote (``design=``): in float32 mode JAX
synthesizes its templates in float32, about 1e-5 off the port's float64
ones. Contract: manifests equal record by record — path, status, rung,
family, attempts, error, health counts, the downshift and counters
events — except wall times and span ids (and the pick engine named in a
downshift event's ``engines``: each package names its own); pick sets
equal or differing only on rounding knife edges (``utils.parity``).
Within the port, picks are bitwise equal at every rung on one device:
``batched:4``, ``batched:2``, ``file``, ``tiled`` and ``host``.
"""

from __future__ import annotations

import os
import time

import jax
import numpy as np
import pytest
import torch

from das4whales_tpu import faults as jfaults
from das4whales_tpu.io.hdf5 import write_optasense as jwrite_optasense
from das4whales_tpu.io.synth import SyntheticCall, SyntheticScene, write_synthetic_file
from das4whales_tpu.models.matched_filter import MatchedFilterDetector as JaxDetector
from das4whales_tpu.utils.checkpoint import save_design as jsave_design
from das4whales_tpu.utils import artifacts as jartifacts
from das4whales_tpu.workflows import campaign as jcampaign
from das4whales_tpu_torch import convert, faults
from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector
from das4whales_tpu_torch.utils.parity import envelopes, unexplained_differences
from das4whales_tpu_torch.workflows import campaign
from tests.torch_threads import one_torch_thread  # noqa: F401

NX = 64
SEL = [0, NX, 1]
T_BUCKET = 1024
CLEAN = ("f0", "f1", "f2", "f3")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The files, the JAX design at the bucket shape and its checkpoint."""
    d = tmp_path_factory.mktemp("campaign_files")
    paths = {}
    for k, name in enumerate(CLEAN + ("f4",)):
        ns = 900 if name == "f4" else 1000
        scene = SyntheticScene(nx=NX, ns=ns, noise_rms=0.05, seed=300 + k, calls=[
            SyntheticCall(t0=0.8 + 0.3 * k, x0_m=(16 + 8 * k) * 2.042, amplitude=2.0),
            SyntheticCall(t0=3.0, x0_m=(48 - 4 * k) * 2.042, amplitude=2.0,
                          fmin=14.7, fmax=21.8, duration=0.78)])
        paths[name] = write_synthetic_file(str(d / f"{name}.h5"), scene)
    (d / "bad.h5").write_bytes(b"\x00 not an hdf5 file " * 64)
    paths["bad"] = str(d / "bad.h5")
    raw = np.random.default_rng(5).normal(0.0, 300.0, (NX, 1000)).astype(np.float32)
    raw[7, 100:103] = np.nan
    paths["nan"] = jwrite_optasense(str(d / "nan.h5"), raw, fs=200.0, dx=2.042,
                                    raw_dtype=np.float32)
    meta = SyntheticScene(nx=NX, ns=1000).metadata
    designs = {}
    with jax.enable_x64(False):
        for ns in (T_BUCKET, 1000):
            jd = JaxDetector(meta, SEL, (NX, ns), pick_mode="sparse", keep_correlograms=False,
                             mf_engine="fft", fk_engine="fft")
            designs[ns] = (jd, jsave_design(str(d / f"design_{ns}.npz"), jd.design))
    return dict(dir=d, paths=paths, meta=meta, designs=designs)


def _files(data, names):
    return [data["paths"][n] for n in names]


JAX_KW = dict(mf_engine="fft", fk_engine="fft", persistent_cache=False)


def _jax_batched(files, outdir, **kw):
    with jax.enable_x64(False):
        return jcampaign.run_campaign_batched(files, SEL, str(outdir), **JAX_KW, **kw)


def _port_batched(data, files, outdir, **kw):
    return campaign.run_campaign_batched(files, SEL, str(outdir), device="cpu",
                                         design=data["designs"][T_BUCKET][1], **kw)


def _manifest(outdir):
    """The manifest as the JAX package's reader sees it."""
    return jartifacts.read_records(os.path.join(str(outdir), "manifest.jsonl"))


def _norm(rec):
    """A manifest record without what may differ between packages: wall
    time, span id, the artifact's directory, the health floats (compared
    apart), pick counts (knife edges) and the pick engine's name."""
    out = {k: v for k, v in rec.items()
           if k not in ("wall_s", "span_id", "health", "n_picks")}
    if out.get("picks_file"):
        out["picks_file"] = os.path.basename(out["picks_file"])
    if "path" in out:
        out["path"] = os.path.basename(out["path"])
    if "engines" in out:
        out["engines"] = {k: v for k, v in out["engines"].items() if k != "pick_engine"}
    return out


def _same_health(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], float) and k.startswith(("rms", "chan_rms", "bin_rms")) or (
                isinstance(a[k], list) and a[k] and isinstance(a[k][0], float)):
            np.testing.assert_allclose(np.asarray(b[k], float), np.asarray(a[k], float),
                                       rtol=1e-5, atol=1e-30)
        else:
            assert a[k] == b[k], k


def _assert_manifests_match(jdir, tdir):
    jm, tm = _manifest(jdir), _manifest(tdir)
    assert [_norm(r) for r in jm] == [_norm(r) for r in tm]
    for a, b in zip(jm, tm):
        _same_health(a.get("health", {}), b.get("health", {}))
        assert set(a.get("n_picks", {})) == set(b.get("n_picks", {}))
    return jm, tm


def _assert_picks_match(data, jm, tm, ns_design=T_BUCKET):
    """Every done file's saved picks: JAX's and the port's up to knife
    edges (the port's envelopes of the padded block decide the edge)."""
    td = MatchedFilterDetector.from_design(
        convert.design_from_arrays({f: getattr(data["designs"][ns_design][0].design, f)
                                    for f in convert.DESIGN_FIELDS}),
        data["meta"], device="cpu")
    from das4whales_tpu_torch.io.hdf5 import load_das_data

    n = 0
    for a, b in zip(jm, tm):
        if a.get("status") != "done":
            continue
        pa, pb = jcampaign.load_picks(a["picks_file"]), campaign.load_picks(b["picks_file"])
        blk = load_das_data(a["path"], SEL, data["meta"], device="cpu")
        tr = np.zeros((NX, ns_design), np.float32)
        tr[:, : blk.trace.shape[1]] = blk.trace.numpy()
        env = envelopes(td, tr)
        for i, name in enumerate(pa):
            if not np.array_equal(pa[name], pb[name]):
                bad = unexplained_differences(pa[name], pb[name], env[i],
                                              _thresholds(b["picks_file"])[name])
                assert not bad, f"{a['path']} {name}: picks differ beyond rounding at {bad}"
            n += pb[name].shape[1]
    assert n > 0


def _thresholds(picks_file):
    with np.load(picks_file) as z:
        return dict(zip([str(s) for s in z["template_names"]], z["thresholds"].tolist()))


@pytest.fixture(scope="module")
def batched_runs(data, tmp_path_factory):
    """Both packages' batched campaigns over the whole file set, then a
    resume of each."""
    files = _files(data, ("f0", "f1", "bad", "f2", "nan", "f3", "f4"))
    out = tmp_path_factory.mktemp("batched")
    jres = _jax_batched(files, out / "jax", batch=2)
    tres = _port_batched(data, files, out / "port", batch=2)
    jres2 = _jax_batched(files, out / "jax", batch=2)
    tres2 = _port_batched(data, files, out / "port", batch=2)
    return dict(files=files, out=out, jres=jres, tres=tres, jres2=jres2, tres2=tres2)


def test_batched_campaign_matches_jax(data, batched_runs):
    out = batched_runs["out"]
    jm, tm = _assert_manifests_match(out / "jax", out / "port")
    status = {os.path.basename(r["path"]): (r["status"], r["rung"]) for r in tm}
    assert status == {"f0.h5": ("done", "batched:2"), "f1.h5": ("done", "batched:2"),
                      "bad.h5": ("failed", ""), "f2.h5": ("done", "batched:2"),
                      "nan.h5": ("quarantined", "batched:2"),
                      "f3.h5": ("done", "batched:2"), "f4.h5": ("done", "batched:2")}
    _assert_picks_match(data, jm, tm)


def test_batched_campaign_resume_matches_jax(batched_runs):
    jr, tr = batched_runs["jres2"], batched_runs["tres2"]
    assert [(os.path.basename(r.path), r.status) for r in jr.records] == \
        [(os.path.basename(r.path), r.status) for r in tr.records]
    # done and quarantined settle; the corrupt file is tried again
    assert tr.n_skipped == 6 and tr.n_failed == 1 and tr.n_done == 0


def test_summaries_read_either_outdir(batched_runs):
    out = batched_runs["out"]
    for d in (out / "jax", out / "port"):
        sj, st = jcampaign.summarize_campaign(str(d)), campaign.summarize_campaign(str(d))
        assert set(sj) == set(st)
        for k in sj:
            if k == "density":
                assert sj[k].keys() == st[k].keys()
                for name in sj[k]:
                    np.testing.assert_array_equal(sj[k][name], st[k][name])
            else:
                assert sj[k] == st[k], k
    sj, st = (campaign.summarize_campaign(str(out / d)) for d in ("jax", "port"))
    assert (sj["n_done"], sj["n_failed"], sj["n_quarantined"]) == \
        (st["n_done"], st["n_failed"], st["n_quarantined"]) == (5, 1, 1)


def test_max_failures_aborts_as_in_jax(data, tmp_path):
    files = _files(data, ("f0", "bad", "f1"))
    with pytest.raises(jcampaign.CampaignAborted):
        _jax_batched(files, tmp_path / "jax", batch=2, max_failures=0)
    with pytest.raises(campaign.CampaignAborted):
        _port_batched(data, files, tmp_path / "port", batch=2, max_failures=0)
    _assert_manifests_match(tmp_path / "jax", tmp_path / "port")


def test_per_file_campaign_matches_jax(data, tmp_path):
    files = _files(data, ("f0", "bad", "f1", "nan", "f2"))
    jd, path = data["designs"][1000]
    with jax.enable_x64(False):
        jcampaign.run_campaign(files, SEL, str(tmp_path / "jax"), detector=jd)
    td = MatchedFilterDetector.from_design(
        campaign._load_design(path), data["meta"], device="cpu")
    tres = campaign.run_campaign(files, SEL, str(tmp_path / "port"), detector=td)
    jm, tm = _assert_manifests_match(tmp_path / "jax", tmp_path / "port")
    assert [(r.status, r.rung) for r in tres.records] == [
        ("done", "file"), ("failed", ""), ("done", "file"), ("quarantined", "file"),
        ("done", "file")]
    _assert_picks_match(data, jm, tm, ns_design=1000)
    # resume: the settled files are skipped, the corrupt one runs again
    again = campaign.run_campaign(files, SEL, str(tmp_path / "port"), detector=td)
    assert [r.status for r in again.records] == ["skipped"] * 4 + ["failed"]


def _chaos_seed():
    """The first seed whose schedule over the clean files holds an oom, a
    corrupt file, a NaN file and a transient fault."""
    names = [f"{n}.h5" for n in CLEAN + ("f4",)]
    for seed in range(500):
        plan = jfaults.FaultPlan(seed, rate=0.9, kinds=CHAOS_KINDS)
        kinds = {getattr(plan.spec_for(n), "kind", None) for n in names}
        if {"oom", "truncated", "nan"} <= kinds and kinds & {"oserror", "transfer"}:
            return seed
    raise AssertionError("no seed covers the four fault classes")


CHAOS_KINDS = ("oserror", "truncated", "transfer", "nan", "oom")


def test_chaos_schedule_matches_jax(data, tmp_path):
    seed = _chaos_seed()
    files = _files(data, CLEAN + ("f4",))
    jplan = jfaults.FaultPlan(seed, rate=0.9, kinds=CHAOS_KINDS)
    tplan = faults.FaultPlan(seed, rate=0.9, kinds=CHAOS_KINDS)
    for f in files:
        js, ts = jplan.spec_for(f), tplan.spec_for(f)
        assert (js is None) == (ts is None)
        if js is not None:
            assert (js.kind, js.site, js.n_times, js.ok_rung) == \
                (ts.kind, ts.site, ts.n_times, ts.ok_rung)
    jpol = jfaults.RetryPolicy(max_attempts=3, base_delay_s=0.0, max_delay_s=0.0)
    tpol = faults.RetryPolicy(max_attempts=3, base_delay_s=0.0, max_delay_s=0.0)
    jres = _jax_batched(files, tmp_path / "jax", batch=2, retry=jpol, fault_plan=jplan)
    tres = _port_batched(data, files, tmp_path / "port", batch=2, retry=tpol,
                         fault_plan=tplan)
    jm, tm = _assert_manifests_match(tmp_path / "jax", tmp_path / "port")
    got = {os.path.basename(r.path): r.status for r in tres.records}
    want = {os.path.basename(f): tplan.expected_disposition(f, tpol) for f in files}
    assert got == want == {os.path.basename(r.path): r.status for r in jres.records}
    assert any(r.get("event") == "downshift" for r in tm)
    _assert_picks_match(data, jm, tm)


def _picks_by_file(res):
    return {os.path.basename(r.path): campaign.load_picks(r.picks_file)
            for r in res.records if r.status == "done"}


def test_picks_bitwise_across_rungs(data, tmp_path):
    """One design, one device: the same per-file picks at batched:4,
    batched:2, the per-file rung, the tiled view and the host view (the
    last two reached through pinned oom faults, each move a downshift
    event)."""
    files = _files(data, CLEAN)
    runs = {
        "batched:4": _port_batched(data, files, tmp_path / "b4", batch=4),
        "batched:2": _port_batched(data, files, tmp_path / "b2", batch=2),
        "file": _port_batched(data, files, tmp_path / "b1", batch=1),
    }
    for ok, label in ((("tiled", 1), "tiled"), (("host", 1), "host")):
        plan = faults.FaultPlan(0, pinned={
            os.path.basename(f): faults.FaultSpec("oom", "dispatch", 10**9, ok) for f in files})
        runs[label] = _port_batched(data, files, tmp_path / label, batch=4, fault_plan=plan)
        moves = [(e["from"], e["to"]) for e in _manifest(tmp_path / label)
                 if e.get("event") == "downshift"]
        want = [("batched:4", "batched:2"), ("batched:2", "file"), ("file", "tiled")]
        assert moves == want + ([("tiled", "host")] if label == "host" else [])
    ref = _picks_by_file(runs["batched:4"])
    assert len(ref) == 4
    for label, res in runs.items():
        assert {r.rung for r in res.records} == {label}
        got = _picks_by_file(res)
        for name in ref:
            for t in ref[name]:
                np.testing.assert_array_equal(got[name][t], ref[name][t], err_msg=label)


def test_wedged_dispatch_times_out_that_file_only(data, tmp_path):
    """The dispatch watchdog: a wedged dispatch of one file fails the slab
    (the slab's files then run one by one at the per-file rung), and only
    that file ends ``timeout``; the wedged worker is abandoned.

    Which file times out must not depend on the host's load: the
    per-file program is warmed first and honest dispatches of it timed,
    one intra-op thread throughout (on a loaded host a 64 x 1024 block
    runs no faster on more); the deadline has a tenfold margin over their
    median (2 s at least, 15 s at most), and the wedge lasts four
    deadlines, so an abandoned worker wakes only after the per-file runs
    are done."""
    from das4whales_tpu_torch.io.hdf5 import load_das_data
    from das4whales_tpu_torch.utils.checkpoint import load_design

    files = _files(data, CLEAN)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        det = MatchedFilterDetector.from_design(load_design(data["designs"][T_BUCKET][1]),
                                                data["meta"], device="cpu")
        block = np.zeros((NX, T_BUCKET), np.float32)
        block[:, :1000] = load_das_data(files[0], SEL, data["meta"], device="cpu").trace.numpy()
        det.detect_picks(block)
        honest = []
        for _ in range(3):
            t0 = time.perf_counter()
            det.detect_picks(block)
            honest.append(time.perf_counter() - t0)
        deadline = min(15.0, max(2.0, 10.0 * float(np.median(honest))))
        plan = faults.FaultPlan(0, rate=0.0, hang_s=4.0 * deadline, pinned={
            "f1.h5": faults.FaultSpec("hang_dispatch", "dispatch", 10**9)})
        res = _port_batched(data, files, tmp_path / "hang", batch=4, fault_plan=plan,
                            dispatch_deadline_s=deadline)
    finally:
        torch.set_num_threads(threads)
    assert [(r.status, r.rung) for r in res.records] == [
        ("done", "file"), ("timeout", "file"), ("done", "file"), ("done", "file")]
    counters = [e for e in _manifest(tmp_path / "hang") if e.get("event") == "counters"]
    assert counters and counters[-1]["watchdog_timeouts"] == 1
    assert "DispatchDeadlineExceeded" in res.records[1].error


def test_timeshard_rung_is_absent_and_raises_on_one_device(data, monkeypatch):
    from das4whales_tpu_torch.workflows.planner import DownshiftLadder, MatchedFilterProgram

    class _Rz:
        def tally(self, *a):
            pass

    ladder = DownshiftLadder(_Rz(), "", batch=4, write=False)
    assert ("timeshard", 1) not in ladder.rungs()
    # the rung needs a world of several ranks (tests/test_torch_timeshard.py):
    # a process alone lists none, however many cards its host has
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    assert ("timeshard", 1) not in ladder.rungs(trace_shape=(NX, T_BUCKET))
    td = MatchedFilterDetector.from_design(campaign._load_design(
        data["designs"][T_BUCKET][1]), data["meta"], device="cpu")
    with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED: no viable time-shard mesh") as ei:
        MatchedFilterProgram(td).detect(("timeshard", 1), np.zeros((NX, T_BUCKET), np.float32))
    assert faults.classify_failure(ei.value) == "resource"


def test_batched_dispatch_is_pipelined_at_depth_2(data, tmp_path, monkeypatch):
    """Depth 2: two slabs stay dispatched and unresolved, so slab k+1's
    (and k+2's) program is dispatched before slab k's fetch, and each
    fetch resolves its own slab, in file order."""
    from das4whales_tpu_torch.parallel.batch import BatchedMatchedFilterDetector

    log = []
    orig = BatchedMatchedFilterDetector.dispatch_batch

    def spy(self, *args, **kw):
        k = sum(1 for e in log if e[0] == "dispatch")
        log.append(("dispatch", k))
        handle = orig(self, *args, **kw)
        resolve = handle.resolve

        def probed():
            log.append(("resolve", k))
            return resolve()

        handle.resolve = probed
        return handle

    monkeypatch.setattr(BatchedMatchedFilterDetector, "dispatch_batch", spy)
    files = _files(data, CLEAN + ("f4",))
    res = _port_batched(data, files, tmp_path / "piped", batch=2, dispatch_depth=2)
    assert [r.status for r in res.records] == ["done"] * 5
    assert log == [("dispatch", 0), ("dispatch", 1), ("dispatch", 2), ("resolve", 0),
                   ("resolve", 1), ("resolve", 2)]
    log.clear()
    _port_batched(data, files, tmp_path / "serial", batch=2, dispatch_depth=1)
    # depth 1: each slab dispatched and fetched in turn, on the synchronous path
    assert log == [("dispatch", 0), ("resolve", 0), ("dispatch", 1), ("resolve", 1),
                   ("dispatch", 2), ("resolve", 2)]


def test_host_view_is_the_detector_on_the_cpu(data):
    """The host rung's view: the same design and settings with
    ``device="cpu"``, channel-tiled, cached; bitwise the CPU detector's
    picks."""
    design = campaign._load_design(data["designs"][T_BUCKET][1])
    det = MatchedFilterDetector.from_design(design, data["meta"], max_peaks=128,
                                            wire="raw", device="cpu")
    view = det.host_view()
    assert view is det.host_view() and view is not det
    assert view.device.type == "cpu" and view.design is design
    assert (view.max_peaks, view.wire, view.fused_bandpass, view.pick_pack_cap) == (
        128, "raw", True, det.pick_pack_cap)
    assert view.channel_tile == det.effective_channel_tile
    block = np.random.default_rng(7).integers(-2000, 2000, (NX, T_BUCKET), dtype=np.int32)
    a = det.tiled_view().detect_picks(block, with_health=True)
    b = view.detect_picks(block, with_health=True)
    for name in a.picks:
        np.testing.assert_array_equal(a.picks[name], b.picks[name])
    assert a.thresholds == b.thresholds and a.health == b.health


SPECTRO_NX, SPECTRO_NS = 32, 2000


SPECTRO_NX, SPECTRO_NS = 32, 2000


def test_spectro_family_matches_jax(tmp_path):
    """Three 32 x 2000 files (10 s: the LF hat kernel needs them) through
    the spectro family's batched campaign; the family buckets exactly."""
    files = []
    for k in range(3):
        scene = SyntheticScene(nx=SPECTRO_NX, ns=SPECTRO_NS, noise_rms=0.05, seed=40 + k, calls=[
            SyntheticCall(t0=3.0, x0_m=16 * 2.042, amplitude=1.0),
            SyntheticCall(t0=6.5, x0_m=8 * 2.042, amplitude=0.8, fmin=14.7, fmax=21.8,
                          duration=0.78)])
        files.append(write_synthetic_file(str(tmp_path / f"s{k}.h5"), scene))
    kw = dict(family="spectro", batch=2, threshold=4.0)
    with jax.enable_x64(False):
        jcampaign.run_campaign_batched(files, [0, SPECTRO_NX, 1], str(tmp_path / "jax"),
                                       stft_engine="rfft", persistent_cache=False, **kw)
    tres = campaign.run_campaign_batched(files, [0, SPECTRO_NX, 1], str(tmp_path / "port"),
                                         device="cpu", **kw)
    jm, tm = _manifest(tmp_path / "jax"), _manifest(tmp_path / "port")
    assert [_norm(r) for r in jm] == [_norm(r) for r in tm]
    assert [(r.status, r.rung, r.family) for r in tres.records] == \
        [("done", "batched:2", "spectro")] * 3
    total = 0
    for a, b in zip(jm, tm):
        assert a["health"] == b["health"]       # host stats: one numpy definition
        pa, pb = jcampaign.load_picks(a["picks_file"]), campaign.load_picks(b["picks_file"])
        for name in pa:
            # equal, or off by a knife edge: a pick apart is at most one
            # pick per file here
            d = {tuple(p) for p in pa[name].T.tolist()} ^ {tuple(p) for p in pb[name].T.tolist()}
            assert len(d) <= 1, (name, sorted(d))
            total += pb[name].shape[1]
    assert total > 0


GABOR_NX, GABOR_NS = 64, 2000
GABOR_KW = dict(bin_factor=0.25)       # the reference's thresholds, 9100 / 150


@pytest.fixture(scope="module")
def gabor_data(tmp_path_factory):
    """Three 64 x 2000 files with an HF and an LF call each, a corrupt
    one, JAX's prefilter design at that shape (its checkpoint) and JAX's
    float32 notes: the port's family runs on both, so the packages
    differ only by rounding."""
    from das4whales_tpu.models.gabor import GaborDetector as JaxGabor

    d = tmp_path_factory.mktemp("gabor_files")
    files = []
    for k in range(3):
        scene = SyntheticScene(nx=GABOR_NX, ns=GABOR_NS, noise_rms=0.05, seed=60 + k, calls=[
            SyntheticCall(t0=2.0 + 0.5 * k, x0_m=(16 + 8 * k) * 2.042, amplitude=1.0),
            SyntheticCall(t0=6.0, x0_m=(48 - 4 * k) * 2.042, amplitude=1.0, fmin=14.7,
                          fmax=21.8, duration=0.78)])
        files.append(write_synthetic_file(str(d / f"g{k}.h5"), scene))
    (d / "gbad.h5").write_bytes(b"\x00 not an hdf5 file " * 64)
    files.insert(2, str(d / "gbad.h5"))
    meta = SyntheticScene(nx=GABOR_NX, ns=GABOR_NS).metadata
    sel = [0, GABOR_NX, 1]
    with jax.enable_x64(False):
        jd = JaxDetector(meta, sel, (GABOR_NX, GABOR_NS), mf_engine="fft", fk_engine="fft")
        notes = {k: np.array(v) for k, v in JaxGabor(meta, sel, **GABOR_KW).notes.items()}
    return dict(files=files, sel=sel, meta=meta,
                design=jsave_design(str(d / "gabor_design.npz"), jd.design),
                port_kw=dict(GABOR_KW, note_arrays=notes))


def _assert_gabor_picks(jm, tm):
    """Saved picks of every done file: equal, or every pick in the
    symmetric difference on a rounding knife edge of the port's own
    correlogram envelope (``utils.parity``) at the saved threshold."""
    from das4whales_tpu_torch.io.hdf5 import load_das_data
    from das4whales_tpu_torch.ops import spectral
    from das4whales_tpu_torch.workflows.gabordetect import campaign_detector

    meta = SyntheticScene(nx=GABOR_NX, ns=GABOR_NS).metadata
    sel = [0, GABOR_NX, 1]
    n = 0
    for a, b in zip(jm, tm):
        if a.get("status") != "done":
            continue
        pa, pb = jcampaign.load_picks(a["picks_file"]), campaign.load_picks(b["picks_file"])
        thr = _thresholds(b["picks_file"])
        if all(np.array_equal(pa[k], pb[k]) for k in pa):
            n += sum(v.shape[1] for v in pb.values())
            continue
        ad = campaign_detector(meta, sel, (GABOR_NX, GABOR_NS), device="cpu", **GABOR_KW)
        blk = load_das_data(a["path"], sel, meta, device="cpu")
        corr = ad.det.correlograms(ad.prefilter.filter_block(blk.trace))[3]
        for name in pa:
            env = spectral.envelope_sqrt(corr[name]).numpy()
            bad = unexplained_differences(pa[name], pb[name], env, thr[name])
            assert not bad, f"{a['path']} {name}: picks differ beyond rounding at {bad}"
            n += pb[name].shape[1]
    assert n > 0


class _JaxPinnedPlan(jfaults.FaultPlan):
    """JAX's chaos plan with a chosen fault for named files (the port's
    ``FaultPlan(pinned=...)``; JAX's plan draws only)."""

    def __init__(self, pinned):
        super().__init__(0, rate=0.0)
        self.pinned = pinned

    def spec_for(self, path):
        return self.pinned.get(os.path.basename(path))


def _gabor_oom_plan(mod, files):
    """Every clean file's dispatch runs out of memory until the host rung."""
    pinned = {os.path.basename(f): mod.FaultSpec("oom", "dispatch", 10**9, ("host", 1))
              for f in files if "gbad" not in f}
    return _JaxPinnedPlan(pinned) if mod is jfaults else mod.FaultPlan(0, pinned=pinned)


def _gabor_port_kw(gabor_data):
    return dict(family="gabor", batch=2, device="cpu", design=gabor_data["design"],
                **gabor_data["port_kw"])


@pytest.fixture(scope="module")
def gabor_port_batched(gabor_data, tmp_path_factory):
    """The port's healthy batched Gabor campaign over the file set, run
    once for the module: the JAX comparison and the per-file comparison
    read the same run."""
    out = tmp_path_factory.mktemp("gabor_port") / "port"
    res = campaign.run_campaign_batched(gabor_data["files"], gabor_data["sel"], str(out),
                                        **_gabor_port_kw(gabor_data))
    return dict(res=res, out=out)


@pytest.mark.parametrize("oom", [False, True], ids=["healthy", "oom_to_host"])
def test_gabor_family_batched_matches_jax(gabor_data, gabor_port_batched, tmp_path, oom):
    """``run_campaign_batched(family="gabor")`` at batch 2 on both packages:
    manifests equal record by record (status, rung, family, attempts,
    error, health, the downshift events); with a pinned oom at every
    dispatch the ladder walks ``batched:2 -> file -> host`` on both."""
    files, sel = gabor_data["files"], gabor_data["sel"]
    jkw = dict(family="gabor", batch=2, persistent_cache=False, **GABOR_KW)
    if oom:
        jkw["fault_plan"] = _gabor_oom_plan(jfaults, files)
    with jax.enable_x64(False):
        jcampaign.run_campaign_batched(files, sel, str(tmp_path / "jax"), **jkw)
    if oom:
        port = tmp_path / "port"
        tres = campaign.run_campaign_batched(files, sel, str(port),
                                             fault_plan=_gabor_oom_plan(faults, files),
                                             **_gabor_port_kw(gabor_data))
    else:
        port, tres = gabor_port_batched["out"], gabor_port_batched["res"]
    jm, tm = _assert_manifests_match(tmp_path / "jax", port)
    rung = "host" if oom else "batched:2"
    assert [(r.status, r.rung, r.family) for r in tres.records] == [
        ("done", rung, "gabor"), ("done", rung, "gabor"), ("failed", "", "gabor"),
        ("done", rung, "gabor")]
    moves = [(e["from"], e["to"]) for e in tm if e.get("event") == "downshift"]
    assert moves == ([("batched:2", "file"), ("file", "host")] if oom else [])
    _assert_gabor_picks(jm, tm)


def test_gabor_family_serial_batched_is_bitwise_the_per_file_campaign(gabor_data,
                                                                    gabor_port_batched,
                                                                    tmp_path):
    """Within the port, one device: the serial facade's saved picks equal
    the per-file ``run_campaign(family="gabor")``'s bit for bit, and that
    campaign's manifest equals JAX's ``run_campaign`` on its Gabor
    adapter; a pinned oom there moves ``file -> host``."""
    from das4whales_tpu.workflows.gabordetect import campaign_detector as jcampaign_detector

    files, sel, meta = gabor_data["files"], gabor_data["sel"], gabor_data["meta"]
    tkw = dict(device="cpu", design=gabor_data["design"], **gabor_data["port_kw"])
    batched = gabor_port_batched["res"]
    with jax.enable_x64(False):
        jdet = jcampaign_detector(meta, sel, (GABOR_NX, GABOR_NS), **GABOR_KW)
        jcampaign.run_campaign(files, sel, str(tmp_path / "jax"), detector=jdet)
    per_file = campaign.run_campaign(files, sel, str(tmp_path / "port"), family="gabor", **tkw)
    jm, tm = _assert_manifests_match(tmp_path / "jax", tmp_path / "port")
    assert [(r.status, r.rung, r.family) for r in per_file.records] == [
        ("done", "file", "gabor")] * 2 + [("failed", "", "gabor"), ("done", "file", "gabor")]
    _assert_gabor_picks(jm, tm)
    a, b = _picks_by_file(batched), _picks_by_file(per_file)
    assert len(a) == 3
    for name in a:
        for t in a[name]:
            np.testing.assert_array_equal(a[name][t], b[name][t])
    with jax.enable_x64(False):
        jcampaign.run_campaign(files, sel, str(tmp_path / "jax_oom"), detector=jdet,
                               fault_plan=_gabor_oom_plan(jfaults, files))
    host = campaign.run_campaign(files, sel, str(tmp_path / "port_oom"), family="gabor",
                                 fault_plan=_gabor_oom_plan(faults, files), **tkw)
    _assert_manifests_match(tmp_path / "jax_oom", tmp_path / "port_oom")
    assert [r.rung for r in host.records] == ["host", "host", "", "host"]
    c = _picks_by_file(host)
    for name in a:
        for t in a[name]:
            np.testing.assert_array_equal(c[name][t], a[name][t])


LEARNED_NX, LEARNED_NS = 32, 3000


@pytest.fixture(scope="module")
def learned_files(tmp_path_factory):
    """Three 32 x 3000 files in the geometry of JAX's learned tests (8 m
    channels, noise 0.08) with one call each, and a corrupt one."""
    d = tmp_path_factory.mktemp("learned_files")
    files = []
    for k in range(3):
        scene = SyntheticScene(nx=LEARNED_NX, ns=LEARNED_NS, dx=8.0, noise_rms=0.08,
                               seed=80 + k, calls=[SyntheticCall(
                                   t0=3.0 + 2.0 * k, x0_m=100.0 + 40.0 * k, amplitude=0.8)])
        files.append(write_synthetic_file(str(d / f"l{k}.h5"), scene))
    (d / "lbad.h5").write_bytes(b"\x00 not an hdf5 file " * 64)
    files.insert(2, str(d / "lbad.h5"))
    return files


def _assert_learned_picks(jm, tm):
    """Saved picks of every done file: equal, or every pick in the
    symmetric difference on a knife edge (1e-4) of the port's own scores
    of that file at the saved threshold."""
    from das4whales_tpu_torch.io.hdf5 import load_das_data
    from das4whales_tpu_torch.models.learned import LearnedDetector, load_pretrained
    from das4whales_tpu_torch.utils.parity import unexplained_learned_differences

    det = LearnedDetector(*load_pretrained(), device="cpu")
    meta = SyntheticScene(nx=LEARNED_NX, ns=LEARNED_NS, dx=8.0).metadata
    n = 0
    for a, b in zip(jm, tm):
        if a.get("status") != "done":
            continue
        pa, pb = jcampaign.load_picks(a["picks_file"]), campaign.load_picks(b["picks_file"])
        thr = _thresholds(b["picks_file"])
        assert thr == {"CALL": 0.5}
        res = det(load_das_data(a["path"], [0, LEARNED_NX, 1], meta, device="cpu").trace)
        bad = unexplained_learned_differences(pa["CALL"], pb["CALL"], res.scores, res.centers,
                                              thr["CALL"], 1e-4)
        assert not bad, f"{a['path']}: picks differ beyond rounding at {bad}"
        n += pb["CALL"].shape[1]
    assert n > 0


@pytest.mark.parametrize("oom", [False, True], ids=["healthy", "oom_to_host"])
def test_learned_family_batched_matches_jax(learned_files, tmp_path, oom):
    """``run_campaign_batched(family="learned")`` (the pretrained
    ``fin_cnn``) at batch 2 on both packages: manifests equal record by
    record; with a pinned oom at every dispatch the ladder walks
    ``batched:2 -> file -> tiled -> host`` on both."""
    files, sel = learned_files, [0, LEARNED_NX, 1]
    jkw = dict(family="learned", batch=2, persistent_cache=False)
    tkw = dict(family="learned", batch=2, device="cpu")
    if oom:
        jkw["fault_plan"] = _gabor_oom_plan(jfaults, files)
        tkw["fault_plan"] = _gabor_oom_plan(faults, files)
    with jax.enable_x64(False):
        jcampaign.run_campaign_batched(files, sel, str(tmp_path / "jax"), **jkw)
    tres = campaign.run_campaign_batched(files, sel, str(tmp_path / "port"), **tkw)
    jm, tm = _assert_manifests_match(tmp_path / "jax", tmp_path / "port")
    rung = "host" if oom else "batched:2"
    assert [(r.status, r.rung, r.family) for r in tres.records] == [
        ("done", rung, "learned"), ("done", rung, "learned"), ("failed", "", "learned"),
        ("done", rung, "learned")]
    moves = [(e["from"], e["to"]) for e in tm if e.get("event") == "downshift"]
    assert moves == ([("batched:2", "file"), ("file", "tiled"), ("tiled", "host")]
                     if oom else [])
    _assert_learned_picks(jm, tm)


def test_learned_family_per_file_campaign_matches_jax(learned_files, tmp_path):
    """``run_campaign(family="learned")`` against JAX's ``run_campaign`` on
    its ``LearnedDetector``: manifests equal record by record, picks up
    to knife edges; within the port the serial facade's saved picks are
    the per-file campaign's bit for bit."""
    from das4whales_tpu.models import learned as jlearned

    files, sel = learned_files, [0, LEARNED_NX, 1]
    with jax.enable_x64(False):
        jdet = jlearned.LearnedDetector(*jlearned.load_pretrained())
        jcampaign.run_campaign(files, sel, str(tmp_path / "jax"), detector=jdet)
    per_file = campaign.run_campaign(files, sel, str(tmp_path / "port"), family="learned",
                                     device="cpu")
    jm, tm = _assert_manifests_match(tmp_path / "jax", tmp_path / "port")
    assert [(r.status, r.rung, r.family) for r in per_file.records] == [
        ("done", "file", "learned")] * 2 + [("failed", "", "learned"), ("done", "file", "learned")]
    _assert_learned_picks(jm, tm)
    batched = campaign.run_campaign_batched(files, sel, str(tmp_path / "b"), family="learned",
                                            batch=2, serial=True, device="cpu")
    a, b = _picks_by_file(batched), _picks_by_file(per_file)
    assert len(a) == 3
    for name in a:
        np.testing.assert_array_equal(a[name]["CALL"], b[name]["CALL"])


def test_compact_batch_picks_matches_jax():
    rng = np.random.default_rng(3)
    pos = rng.integers(0, 1200, (2, 3, 5, 4)).astype(np.int32)
    sel = rng.random((2, 3, 5, 4)) < 0.5
    with jax.enable_x64(False):
        want = [np.array(x) for x in jcampaign._compact_batch_picks(pos, sel, 1000, 16)]
    got = campaign._compact_batch_picks(torch.from_numpy(pos), torch.from_numpy(sel), 1000, 16)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), w)


def test_probe_healthy_matches_jax(data):
    pairs = [(p, None) for p in _files(data, ("f0", "bad", "f4", "f1"))]
    jfailed, tfailed = [], []
    jh, _ = jcampaign._probe_healthy(pairs, "optasense", lambda p, e: jfailed.append(p))
    th, spec0 = campaign._probe_healthy(pairs, "optasense", lambda p, e: tfailed.append(p))
    assert [p for p, _ in jh] == [p for p, _ in th] == _files(data, ("f0", "f1"))
    assert jfailed == tfailed == _files(data, ("bad", "f4"))
    assert (spec0.meta.nx, spec0.meta.ns) == (NX, 1000)


def test_design_checkpoint_gives_the_same_picks(data, tmp_path):
    """A design written by JAX's save_design, loaded by the port, then
    saved by the port and loaded again: bitwise the same picks as the
    design carried across field by field."""
    from das4whales_tpu_torch.utils.checkpoint import load_design, save_design

    jd, path = data["designs"][T_BUCKET]
    loaded = load_design(path)
    again = load_design(save_design(str(tmp_path / "port_design"), loaded))
    carried = convert.design_from_arrays({f: getattr(jd.design, f)
                                          for f in convert.DESIGN_FIELDS})
    rng = np.random.default_rng(9)
    block = rng.normal(0, 1e-9, (NX, T_BUCKET)).astype(np.float32)
    ref = MatchedFilterDetector.from_design(carried, data["meta"], device="cpu").detect_picks(block)
    for design in (loaded, again):
        got = MatchedFilterDetector.from_design(design, data["meta"], device="cpu").detect_picks(block)
        assert got.thresholds == ref.thresholds
        for name in ref.picks:
            np.testing.assert_array_equal(got.picks[name], ref.picks[name])


def test_not_in_slice_settings_raise(data, tmp_path):
    """What the campaign module still leaves to later items raises, naming
    it; ``preflight``, ``cost_cards`` and ``quality`` are taken by both
    entries (``tests/test_torch_preflight.py`` runs them)."""
    import inspect

    for entry in (campaign.run_campaign_batched, campaign.run_campaign):
        params = inspect.signature(entry).parameters
        assert {"preflight", "cost_cards", "quality"} <= set(params)
    # the mesh campaigns run (tests/test_torch_campaign_sharded.py) with
    # JAX's signatures; the elastic mesh downshift (tests/test_torch_elastic.py)
    # re-raises a step failure where every rank checks in: on a mesh of one
    # it always does, as JAX's re-raises when every device probes healthy
    for fn, jfn in ((campaign.run_campaign_sharded, jcampaign.run_campaign_sharded),
                    (campaign.run_campaign_multiprocess,
                     jcampaign.run_campaign_multiprocess)):
        params = list(inspect.signature(fn).parameters)
        assert params[:len(inspect.signature(jfn).parameters)] == \
            list(inspect.signature(jfn).parameters)
    from das4whales_tpu_torch.parallel import pipeline
    from das4whales_tpu_torch.parallel.mesh import make_mesh

    def lost(*a, **k):
        def step(x):
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
        return step

    files = _files(data, CLEAN[:2])
    mesh = make_mesh(devices=["cpu"])
    orig = pipeline.make_sharded_mf_step
    pipeline.make_sharded_mf_step = lost
    try:
        with pytest.raises(RuntimeError, match="illegal memory access"):
            campaign.run_campaign_sharded(files, SEL, str(tmp_path / "e"), mesh)
        assert not any(r.get("event") == "mesh_downshift" for r in jartifacts.read_records(
            os.path.join(str(tmp_path / "e"), "manifest.jsonl")))
        with pytest.raises(RuntimeError, match="illegal memory access"):
            campaign.run_campaign_sharded(files, SEL, str(tmp_path / "f"), mesh, elastic=False)
    finally:
        pipeline.make_sharded_mf_step = orig
    assert not os.path.exists(tmp_path / "x" / "manifest.jsonl")
