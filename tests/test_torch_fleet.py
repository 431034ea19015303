"""Port parity, the self-healing fleet: ``fleet/`` (supervisor, router) and
the ``fleet`` verb of das4whales_tpu_torch, with its ``serve`` workers on
the CPU (``"device": "cpu"``, one intra-op thread each), against
das4whales_tpu's fleet contracts (``tests/test_fleet.py``) and its
standalone campaign on the same files.

Contracts pinned here:

* ``faults.Backoff`` draws the JAX package's schedule (jitter bounds,
  cap, deadline truncation, ``RetryPolicy`` delegating to it);
* the two worker-side migration verbs: ``POST /drain/<tenant>`` leaves a
  complete settled manifest; ``POST /adopt`` fscks first (a corrupt
  directory answers 409 and is not registered), and a resume across
  services is bitwise the standalone run;
* the quick chaos drill: 2 worker subprocesses x 2 tenants under paced
  replay survive one graceful rebalance and one SIGKILL of the worker
  holding both tenants — every file done exactly once fleet-wide, each
  tenant's picks bitwise its standalone port campaign, its file records
  those of the JAX package's standalone ``run_campaign_batched`` (status,
  rung, attempts; picks up to rounding knife edges, ``utils.parity``), a
  client cursor stream through the router with no gaps and no
  duplicates, ``fsck`` clean, no orphan tmps;
* the fleet layer is invisible when unused: a single-process service
  gives the same manifest and bitwise picks before and after a
  ``FleetSupervisor`` is imported and constructed;
* the verb: a one-worker CPU fleet runs to settled (exit 0), an unknown
  registry key fails loudly as in the JAX package;
* fencing matches the port's own worker command only: a JAX worker's
  command line is never fenced (the reference's substring match would).

The kill matrix (each worker SIGKILLed, a SIGSTOP wedge, the supervisor
SIGKILLed and restarted over the same root) is marked ``slow``, as the JAX
package's is; ``tests/torch_fleet_worker.py`` is its driver.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest

from das4whales_tpu import faults as jfaults
from das4whales_tpu.fleet import supervisor as jsup
from das4whales_tpu.io.synth import SyntheticCall, SyntheticScene, write_synthetic_file
from das4whales_tpu.models.matched_filter import MatchedFilterDetector as JaxDetector
from das4whales_tpu.utils.checkpoint import save_design as jsave_design
from das4whales_tpu.workflows import campaign as jcampaign
from das4whales_tpu_torch import convert, faults, fsck
from das4whales_tpu_torch.fleet import (FleetConfig, FleetRouter, FleetSupervisor,
                                        load_fleet_config, settled_files)
from das4whales_tpu_torch.fleet import supervisor as tsup
from das4whales_tpu_torch.service import DetectionService, ServiceConfig, TenantSpec
from das4whales_tpu_torch.utils import artifacts
from das4whales_tpu_torch.workflows import campaign

from tests.conftest import CHAOS_N_FILES, CHAOS_NS, CHAOS_NX, CHAOS_SEL
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DRIVER = os.path.join(ROOT, "tests", "torch_fleet_worker.py")
NX, NS, SEL = CHAOS_NX, CHAOS_NS, CHAOS_SEL
JAX_KW = dict(mf_engine="fft", fk_engine="fft", persistent_cache=False)


def _make_files(tmp_path_factory, n, seed0, tag):
    d = tmp_path_factory.mktemp(tag)
    paths = []
    for k in range(n):
        scene = SyntheticScene(nx=NX, ns=NS, noise_rms=0.05, seed=seed0 + k,
                               calls=[SyntheticCall(t0=1.0 + 0.4 * k, x0_m=NX / 2 * 2.042,
                                                    amplitude=2.0)])
        paths.append(write_synthetic_file(str(d / f"{tag}{k}.h5"), scene))
    return paths


@pytest.fixture(scope="module")
def second_files(tmp_path_factory):
    return _make_files(tmp_path_factory, 3, 700, "ff")


@pytest.fixture(scope="module")
def design(tmp_path_factory):
    """JAX's design at the files' shape and its checkpoint: every port
    worker and standalone run loads it, so no process designs its own."""
    meta = SyntheticScene(nx=NX, ns=NS).metadata
    with jax.enable_x64(False):
        jd = JaxDetector(meta, SEL, (NX, NS), pick_mode="sparse", keep_correlograms=False,
                         mf_engine="fft", fk_engine="fft")
        path = jsave_design(str(tmp_path_factory.mktemp("fleet_design") / "d.npz"), jd.design)
    return dict(jd=jd, path=path, meta=meta)


@pytest.fixture(scope="module")
def refs(chaos_file_set, second_files, design, tmp_path_factory):
    """Per tenant: the port's standalone ``run_campaign_batched`` picks (the
    bitwise oracle) and the JAX package's standalone campaign (records and
    picks, the cross-package oracle)."""
    base = tmp_path_factory.mktemp("fleetref")
    out = {}
    for name, files in (("a", chaos_file_set), ("b", second_files)):
        res = campaign.run_campaign_batched(files, SEL, str(base / name), batch=2,
                                            bucket="exact", device="cpu",
                                            design=design["path"])
        assert res.n_failed == 0
        with jax.enable_x64(False):
            jres = jcampaign.run_campaign_batched(files, SEL, str(base / f"jax_{name}"),
                                                  batch=2, bucket="exact", **JAX_KW)
        assert jres.n_failed == 0
        out[name] = dict(
            picks={r.path: campaign.load_picks(r.picks_file)
                   for r in res.records if r.status == "done"},
            jax_records=_file_records(str(base / f"jax_{name}")),
            jax_picks={r.path: jcampaign.load_picks(r.picks_file) for r in jres.records})
    return out


def _file_records(outdir):
    return [r for r in artifacts.read_records(os.path.join(outdir, "manifest.jsonl"))
            if "path" in r]


def _tenant(name, files, design, **kw):
    t = {"name": name, "files": list(files), "channels": SEL, "batch": 2, "bucket": "exact",
         "admission": False, "detector_kwargs": {"design": design["path"]}}
    t.update(kw)
    return t


def _worker_env():
    """The workers run this checkout's port on one intra-op thread each."""
    return {"PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def _assert_bitwise(outdir, files, reference):
    done = {}
    for rec in _file_records(outdir):
        if rec.get("status") == "done":
            done.setdefault(rec["path"], []).append(rec)
    assert set(done) == set(files)
    for path, recs in done.items():
        assert len(recs) == 1, f"{path} settled done {len(recs)} times"
        got, ref = campaign.load_picks(recs[0]["picks_file"]), reference[path]
        assert set(got) == set(ref)
        for name in ref:
            np.testing.assert_array_equal(got[name], ref[name])


def _assert_fsck_clean(outdir):
    assert fsck.startup_check(outdir, label=f"verify {outdir}") == {
        "orphan_tmps": 0, "torn_tail": 0, "corrupt_records": 0}
    assert fsck.fsck_outdir(outdir) == []


def _assert_records_match_jax(outdir, ref, design):
    """The fleet tenant's settled file records against the JAX package's
    standalone campaign: status, rung and attempts equal in file order,
    picks equal up to rounding knife edges on the port's own envelopes."""
    from das4whales_tpu_torch.io.hdf5 import load_das_data
    from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector
    from das4whales_tpu_torch.utils.parity import envelopes, unexplained_differences

    got = [r for r in _file_records(outdir) if r.get("status") == "done"]
    key = ("status", "rung", "attempts")
    assert [(os.path.basename(r["path"]),) + tuple(r.get(k) for k in key) for r in got] == [
        (os.path.basename(r["path"]),) + tuple(r.get(k) for k in key)
        for r in ref["jax_records"]]
    td = MatchedFilterDetector.from_design(
        convert.design_from_arrays({f: getattr(design["jd"].design, f)
                                    for f in convert.DESIGN_FIELDS}), design["meta"],
        device="cpu")
    n = 0
    for r in got:
        pa, pb = ref["jax_picks"][r["path"]], campaign.load_picks(r["picks_file"])
        with np.load(r["picks_file"]) as z:
            thr = dict(zip([str(s) for s in z["template_names"]], z["thresholds"].tolist()))
        env = envelopes(td, load_das_data(r["path"], SEL, design["meta"], device="cpu").trace)
        for i, name in enumerate(pa):
            if not np.array_equal(pa[name], pb[name]):
                bad = unexplained_differences(pa[name], pb[name], env[i], thr[name])
                assert not bad, f"{r['path']} {name}: picks differ beyond rounding at {bad}"
            n += pb[name].shape[1]
    assert n > 0


# --------------------------------------------------------- Backoff units

@pytest.mark.parametrize("kw", [
    dict(base_s=0.1, factor=2.0, jitter=0.25, cap_s=10.0, seed=3),
    dict(base_s=1.0, factor=4.0, jitter=0.5, cap_s=2.0),
    dict(base_s=0.5, factor=2.0, jitter=0.2, cap_s=4.0, deadline_s=3.0, seed=11),
], ids=["growth", "cap", "deadline"])
def test_backoff_schedule_matches_jax(kw):
    """``faults.Backoff`` is the JAX package's schedule, delay for delay:
    jitter within its bounds around the capped base, deterministic by
    (seed, key, attempt) and decorrelated across keys, the cap bounding
    the base and not the jitter, the deadline truncating a delay and
    ending :meth:`delays`; ``RetryPolicy`` delegates to the same
    schedule."""
    bo, jbo = faults.Backoff(**kw), jfaults.Backoff(**kw)
    for key in ("k", "other"):
        for attempt in range(1, 13):
            d = bo.delay_s(attempt, key=key)
            assert d == jbo.delay_s(attempt, key=key)
            base = min(kw["base_s"] * kw["factor"] ** (attempt - 1), kw["cap_s"])
            cut = kw.get("deadline_s", float("inf"))
            assert min(base * (1 - kw["jitter"]), cut) <= d <= min(base * (1 + kw["jitter"]), cut)
            assert d <= kw["cap_s"] * (1 + kw["jitter"])
    assert bo.delay_s(3, key="k") == bo.delay_s(3, key="k") != bo.delay_s(3, key="other")
    if "deadline_s" in kw:
        seq = list(bo.delays(key="g"))
        assert seq == list(jbo.delays(key="g")) and seq
        assert sum(seq) <= kw["deadline_s"] + 1e-9
        assert bo.delay_s(9, "k", elapsed_s=kw["deadline_s"] - 0.5) == pytest.approx(0.5)
        assert bo.delay_s(9, "k", elapsed_s=kw["deadline_s"] + 1.0) == 0.0
    else:
        unbounded = bo.delays(key="g")
        assert [next(unbounded) for _ in range(50)] == [
            d for d, _ in zip(jbo.delays(key="g"), range(50))]
    pol = faults.RetryPolicy(max_attempts=4, base_delay_s=kw["base_s"],
                             max_delay_s=kw["cap_s"], jitter=kw["jitter"],
                             seed=kw.get("seed", 0))
    for key in ("file-a", "file-b"):
        for attempt in (1, 2, 3, 7):
            assert pol.delay_s(key, attempt) == pol.backoff().delay_s(attempt, key)


# ------------------------------------------- drain/adopt worker verbs

def _post(url, payload=None, timeout=30.0):
    body = json.dumps(payload).encode() if payload is not None else b""
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read() or b"{}")
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read() or b"{}")


def _service(tenants, outdir):
    svc = DetectionService(ServiceConfig(tenants=[TenantSpec(**t) for t in tenants],
                                         outdir=str(outdir), device="cpu")).start()
    run = threading.Thread(target=svc.run, kwargs={"until_idle": False}, daemon=True)
    run.start()
    return svc, run


def _stop(svc, run):
    svc.request_stop()
    run.join(timeout=60)
    svc.stop()


def test_drain_and_adopt_verbs(chaos_file_set, refs, design, tmp_path):
    """Migration's two worker-side verbs, in-process: drain tenant 'a' off
    a live service mid-replay (settled manifest flushed, footprint card
    written, tenant gone from the registry), adopt the SAME outdir on a
    second service, which finishes ONLY the pending files — exactly once,
    bitwise the standalone run; a corrupt directory answers 409 and a bad
    spec 400, neither registered."""
    outdir_a = str(tmp_path / "tenants" / "a")
    spec = _tenant("a", chaos_file_set, design, realtime_factor=8.0, outdir=outdir_a)
    svc, run = _service([spec], tmp_path / "w0")
    try:
        assert _post(f"{svc.api.url}/drain/nope")[0] == 404
        deadline = time.monotonic() + 60
        while not settled_files(outdir_a):
            assert time.monotonic() < deadline, "no file settled"
            time.sleep(0.05)
        code, summary = _post(f"{svc.api.url}/drain/a?timeout_s=60")
        assert code == 200, summary
        assert (summary["tenant"], summary["outdir"]) == ("a", outdir_a)
        assert svc.tenant("a") is None
        n_first = len(settled_files(outdir_a))
        assert 1 <= n_first < CHAOS_N_FILES, "the drain must land mid-replay"
        card = json.loads(open(os.path.join(outdir_a, "cost_card.json")).read())
        assert {"priced", "peak_bytes", "predicted_wall_s"} <= set(card)
    finally:
        _stop(svc, run)
    svc2, run2 = _service([], tmp_path / "w1")
    try:
        bad = str(tmp_path / "tenants" / "bad")
        os.makedirs(bad)
        with open(os.path.join(bad, "manifest.jsonl"), "w") as fh:
            fh.write('{"path": "x", "status": "done"}\n')
            fh.write("garbage-interior-line\n")
            fh.write('{"path": "y", "status": "done"}\n')
        code, body = _post(f"{svc2.api.url}/adopt",
                           {"spec": _tenant("bad", [], design), "outdir": bad})
        assert code == 409, body
        assert svc2.tenant("bad") is None
        code, body = _post(f"{svc2.api.url}/adopt", {"spec": {"name": "x", "bogus_key": 1}})
        assert code == 400, body
        assert svc2.tenant("x") is None
        code, body = _post(f"{svc2.api.url}/adopt",
                           {"spec": _tenant("a", chaos_file_set, design), "outdir": outdir_a})
        assert code == 200, body
        assert (body["settled"], body["pending"]) == (n_first, CHAOS_N_FILES - n_first)
        deadline = time.monotonic() + 120
        while len(settled_files(outdir_a)) < CHAOS_N_FILES:
            assert time.monotonic() < deadline, "adopted tenant stalled"
            time.sleep(0.05)
    finally:
        _stop(svc2, run2)
    _assert_bitwise(outdir_a, chaos_file_set, refs["a"]["picks"])
    _assert_fsck_clean(outdir_a)


def test_settled_statuses_mirror_campaign(chaos_file_set, refs, tmp_path):
    """The control plane's import-light settled definition tracks the
    campaign's (the port's and the JAX package's), and reads a manifest
    as ``load_settled`` does."""
    assert tuple(tsup.SETTLED_STATUSES) == tuple(campaign._SETTLED_STATUSES) == tuple(
        jsup.SETTLED_STATUSES)
    out = tmp_path / "m"
    out.mkdir()
    recs = [{"path": "a", "status": "failed"}, {"path": "a", "status": "done"},
            {"path": "b", "status": "quarantined"}, {"path": "c", "status": "done"},
            {"path": "c", "status": "timeout"}, {"event": "counters"}]
    for r in recs:
        artifacts.append_record(str(out / "manifest.jsonl"), r)
    assert settled_files(str(out)) == campaign.load_settled(str(out)) == {"a", "b"}


# ------------------------------------------------- the quick chaos drill

def _stream_picks(url, tenant, n_expect, out, errors):
    """A client's cursor stream through the router: long-poll /picks, resume
    from the last cursor, retry 503 and connection errors."""
    cursor = 0
    deadline = time.monotonic() + 300
    try:
        while time.monotonic() < deadline:
            if sum(1 for r in out if r.get("status") == "done") >= n_expect:
                return
            try:
                with urllib.request.urlopen(
                        f"{url}/picks/{tenant}?cursor={cursor}&wait_s=1", timeout=15) as r:
                    body = r.read().decode()
            except urllib.error.HTTPError as exc:
                exc.read()
                if exc.code == 503:
                    time.sleep(0.2)
                    continue
                raise
            except (urllib.error.URLError, OSError, TimeoutError):
                time.sleep(0.2)
                continue
            for line in body.splitlines():
                rec = json.loads(line)
                out.append(rec)
                cursor = rec["cursor"]
        errors.append(f"stream timed out at cursor {cursor}")
    except Exception as exc:  # noqa: BLE001 — surfaces in the test
        errors.append(f"stream died: {exc!r}")


def _get(url, timeout=10.0):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


@pytest.mark.chaos
def test_fleet_quick_drill(chaos_file_set, second_files, refs, design, tmp_path):
    """2 worker subprocesses x 2 tenants under paced replay: one graceful
    rebalance of tenant 'a' while a client streams its picks through the
    router, then SIGKILL of the worker holding both tenants; the fleet
    converges — exactly once, bitwise the standalone campaigns, records as
    the JAX package's, the cursor stream gap- and duplicate-free, fsck
    clean everywhere, both triggers in the ledger, every worker gone
    after ``stop``."""
    cfg = FleetConfig(
        tenants=[_tenant("a", chaos_file_set, design, realtime_factor=6.0),
                 _tenant("b", second_files, design, realtime_factor=6.0)],
        root=str(tmp_path / "fleet"), workers=2, health_interval_s=0.25,
        probe_timeout_s=1.5, dead_after=3, spawn_timeout_s=120.0, drain_timeout_s=60.0,
        cost_cards=False, worker_env=_worker_env(), device="cpu")
    sup = FleetSupervisor(cfg)
    router = None
    recs_a: list = []
    errors: list = []
    try:
        sup.start()
        st = sup.status()
        assert len(st["workers"]) == 2
        owners = st["assignments"]
        assert set(owners) == {"a", "b"} and owners["a"] != owners["b"], owners
        router = FleetRouter(sup, host=cfg.host, port=0).start()
        streamer = threading.Thread(target=_stream_picks,
                                    args=(router.url, "a", CHAOS_N_FILES, recs_a, errors),
                                    daemon=True)
        streamer.start()
        mig = sup.migrate("a", trigger="rebalance")
        assert mig["dst"] != mig["src"]
        dst = mig["dst"]
        if sup.status()["assignments"]["b"] != dst:
            sup.migrate("b", dst=dst, trigger="rebalance")
        victim = next(w for w in sup.workers() if w.name == dst)
        os.kill(victim.pid, signal.SIGKILL)
        assert sup.wait_until_settled(timeout_s=240), (sup.status(), errors)
        streamer.join(timeout=60)
        assert not errors, errors
        codes = {p: _get(router.url + p)[0] for p in ("/fleet", "/livez", "/readyz",
                                                        "/metrics", "/picks/nope")}
        assert codes == {"/fleet": 200, "/livez": 200, "/readyz": 200, "/metrics": 200,
                         "/picks/nope": 404}
        metrics_text = _get(router.url + "/metrics")[1]
        assert "das_fleet_migrations_total" in metrics_text
        assert 'worker="' in metrics_text
    finally:
        if router is not None:
            router.stop()
        sup.stop()
    for w in sup.workers():
        assert w.proc.poll() is not None, f"worker {w.name} outlived stop()"
    for name, files in (("a", chaos_file_set), ("b", second_files)):
        outdir = os.path.join(cfg.root, "tenants", name)
        _assert_bitwise(outdir, files, refs[name]["picks"])
        _assert_fsck_clean(outdir)
        _assert_records_match_jax(outdir, refs[name], design)
    cursors = [r["cursor"] for r in recs_a]
    assert cursors == list(range(1, len(cursors) + 1))
    done_paths = [r["path"] for r in recs_a if r.get("status") == "done"]
    assert sorted(done_paths) == sorted(chaos_file_set), "gap or duplicate in the stream"
    assert artifacts.sweep_orphan_tmps(cfg.root, remove=False) == []
    ledger = artifacts.read_records(os.path.join(cfg.root, "fleet.jsonl"))
    assert any(r.get("event") == "dead" and r["worker"] == dst for r in ledger)
    assert {r["trigger"] for r in ledger if r.get("event") == "migrate"} == {
        "rebalance", "failure"}
    # the ledger replays to the final assignment
    final = {}
    for r in ledger:
        if r.get("event") == "assign":
            final[r["tenant"]] = r["worker"]
    assert final["a"] == final["b"] != dst


# ------------------------------------------------- invisibility pin

def test_fleet_layer_invisible_when_unused(chaos_file_set, refs, design, tmp_path):
    """A single-process service gives the same manifest, bitwise the same
    picks, before and after a ``FleetSupervisor`` is imported and
    constructed (not started): the fleet spawns nothing and touches no
    service state until it is started."""
    def serve(tag):
        svc = DetectionService(ServiceConfig(
            tenants=[TenantSpec(**_tenant("a", chaos_file_set, design))],
            outdir=str(tmp_path / tag), device="cpu")).start()
        try:
            res = svc.run(until_idle=True)
        finally:
            svc.stop()
        assert res["a"].n_failed == 0
        return [{k: v for k, v in r.items() if k not in ("wall_s", "span_id", "picks_file")}
                for r in artifacts.read_records(str(tmp_path / tag / "a" / "manifest.jsonl"))]

    before = serve("before")
    sup = FleetSupervisor(FleetConfig(tenants=[_tenant("a", chaos_file_set, design)],
                                      root=str(tmp_path / "fleet"), device="cpu"))
    assert sup.workers() == [] and sup.status()["assignments"] == {}
    assert not os.path.exists(os.path.join(sup.root, "fleet.jsonl"))
    after = serve("after")
    assert after == before
    for tag in ("before", "after"):
        _assert_bitwise(str(tmp_path / tag / "a"), chaos_file_set, refs["a"]["picks"])


# ------------------------------------------------------------- the verb

def test_fleet_verb_runs_a_one_worker_cpu_fleet(chaos_file_set, refs, design, tmp_path,
                                                capsys):
    """``fleet CONFIG --until-settled --device cpu`` (the registry names no
    device, so ``--device`` is what keeps it off the card): one worker,
    exit 0, every file settled once, bitwise the standalone campaign."""
    from das4whales_tpu_torch.__main__ import main

    cfg = tmp_path / "fleet.json"
    cfg.write_text(json.dumps({
        "tenants": [_tenant("a", chaos_file_set, design)], "root": str(tmp_path / "f"),
        "workers": 2, "cost_cards": False, "worker_env": _worker_env(),
        "spawn_timeout_s": 120.0}))
    assert main(["fleet", str(cfg), "--until-settled", "--device", "cpu", "--workers", "1",
                 "--settle-timeout", "120"]) == 0
    assert "fleet: router at http://" in capsys.readouterr().err
    _assert_bitwise(str(tmp_path / "f" / "tenants" / "a"), chaos_file_set, refs["a"]["picks"])
    reg = json.loads((tmp_path / "f" / "workers" / "w0" / "registry.json").read_text())
    assert reg["device"] == "cpu" and not (tmp_path / "f" / "workers" / "w1").exists()


def test_unknown_fleet_key_fails_loudly_as_jax(tmp_path):
    """A typo'd registry key fails loudly in both packages, naming the key;
    a JAX registry (no ``device`` key) loads unchanged, on the card."""
    path = tmp_path / "fleet.json"
    path.write_text(json.dumps({"tenants": [{"name": "a"}], "workers": 2, "wrkers": 3}))
    for load in (jsup.load_fleet_config, load_fleet_config):
        with pytest.raises(ValueError, match="wrkers"):
            load(str(path))
    path.write_text(json.dumps({"tenants": [{"name": "a"}], "workers": 3,
                                "hbm_budget_gb": 16.0}))
    j, t = jsup.load_fleet_config(str(path)), load_fleet_config(str(path))
    assert (t.workers, t.hbm_budget_gb, t.device) == (j.workers, j.hbm_budget_gb, "cuda")
    with pytest.raises(ValueError, match="at least one worker"):
        FleetConfig(tenants=[], workers=0)


# -------------------------------------------------------------- fencing

def _sleeper(*argv):
    """A process whose command line carries ``argv`` after a sleep."""
    return subprocess.Popen([sys.executable, "-c", "import time; time.sleep(120)", *argv])


def test_fencing_matches_the_port_worker_command_only(tmp_path):
    """A restarted supervisor fences, from its replayed ledger, a pid whose
    command line is its own worker command — and never a JAX worker's
    (``-m das4whales_tpu serve``), another fleet's worker, or a pid that
    is gone. The JAX package's substring match would fence the first two
    (the reference fault the port does not reproduce)."""
    root = tmp_path / "fleet"
    reg = str(root / "workers" / "w0" / "registry.json")
    other = str(tmp_path / "other" / "workers" / "w0" / "registry.json")
    procs = {
        "port": _sleeper("-m", "das4whales_tpu_torch", "serve", reg),
        "jax": _sleeper("-m", "das4whales_tpu", "serve", reg),
        "other_fleet": _sleeper("-m", "das4whales_tpu_torch", "serve", other),
    }
    try:
        time.sleep(0.3)
        root.mkdir()
        for p in procs.values():
            artifacts.append_record(str(root / "fleet.jsonl"),
                                    {"event": "worker", "name": "w0", "port": 1, "pid": p.pid})
        artifacts.append_record(str(root / "fleet.jsonl"),
                                {"event": "worker", "name": "w1", "port": 2, "pid": 2**22 + 7})
        cmdlines = {k: open(f"/proc/{p.pid}/cmdline", "rb").read() for k, p in procs.items()}
        assert all(b"das4whales_tpu" in c for c in cmdlines.values())   # JAX's match
        assert {k: tsup.is_fleet_worker(c, str(root)) for k, c in cmdlines.items()} == {
            "port": True, "jax": False, "other_fleet": False}
        sup = FleetSupervisor(FleetConfig(tenants=[], root=str(root), device="cpu"))
        sup._replay_ledger()
        assert procs["port"].wait(timeout=10) == -signal.SIGKILL
        time.sleep(0.2)
        assert procs["jax"].poll() is None and procs["other_fleet"].poll() is None
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


# --------------------------------------------------- the slow kill matrix

def _write_fleet_config(tmp_path, tenants, root, **kw):
    cfg = {"tenants": tenants, "root": root, "workers": 2, "health_interval_s": 0.25,
           "probe_timeout_s": 1.5, "dead_after": 3, "spawn_timeout_s": 240.0,
           "drain_timeout_s": 60.0, "cost_cards": False, "worker_env": _worker_env(),
           "device": "cpu"}
    cfg.update(kw)
    path = str(tmp_path / "fleet_config.json")
    with open(path, "w") as fh:
        json.dump(cfg, fh)
    return path


def _launch_driver(cfg_path, timeout_s=300):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, DRIVER, cfg_path, str(timeout_s)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=env, cwd=ROOT)
    line = proc.stdout.readline()
    try:
        status = json.loads(line)
    except ValueError:
        out, err = proc.communicate(timeout=30)
        raise AssertionError(f"driver died before fleet-up: {line!r} {out!r} {err!r}")
    return proc, status


def _fleet_worker_pids(router_url):
    with urllib.request.urlopen(f"{router_url}/fleet", timeout=10) as r:
        st = json.loads(r.read())
    return {w["name"]: w["pid"] for w in st["workers"] if w["up"]}


@pytest.fixture(scope="module")
def matrix_files(tmp_path_factory):
    return {"a": _make_files(tmp_path_factory, 3, 800, "ma"),
            "b": _make_files(tmp_path_factory, 3, 820, "mb"),
            "c": _make_files(tmp_path_factory, 3, 840, "mc")}


@pytest.fixture(scope="module")
def matrix_refs(matrix_files, design, tmp_path_factory):
    base = tmp_path_factory.mktemp("matrixref")
    refs = {}
    for name, files in matrix_files.items():
        res = campaign.run_campaign_batched(files, SEL, str(base / name), batch=2,
                                            bucket="exact", device="cpu",
                                            design=design["path"])
        assert res.n_failed == 0
        refs[name] = {r.path: campaign.load_picks(r.picks_file)
                      for r in res.records if r.status == "done"}
    return refs


@pytest.mark.slow
@pytest.mark.chaos
@pytest.mark.parametrize("victim", ["w0", "w1", "wedge", "supervisor"])
def test_fleet_kill_matrix(victim, matrix_files, matrix_refs, design, tmp_path):
    """2 workers x 3 tenants, paced replay: SIGKILL each worker in turn,
    SIGSTOP-wedge one, and SIGKILL the supervisor itself (a restart over
    the same root replays the ledger, fences the orphaned workers and
    resumes). Every scenario converges: exactly once, bitwise, fsck
    clean, no orphan tmps, no worker left running."""
    tenants = [_tenant(n, f, design, realtime_factor=4.0) for n, f in matrix_files.items()]
    root = str(tmp_path / "fleet")
    cfg_path = _write_fleet_config(tmp_path, tenants, root)
    proc, status = _launch_driver(cfg_path)
    orphans = []
    try:
        router_url = status["router"]
        pids = _fleet_worker_pids(router_url)
        if victim in ("w0", "w1"):
            os.kill(pids[victim], signal.SIGKILL)
        elif victim == "wedge":
            os.kill(pids["w0"], signal.SIGSTOP)
        else:
            time.sleep(1.0)
            proc.kill()
            proc.wait(timeout=30)
            orphans = list(pids.values())
            proc, status = _launch_driver(cfg_path)
        out, err = proc.communicate(timeout=420)
        assert proc.returncode == 0, (victim, out, err[-3000:])
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate(timeout=30)
    for name, files in matrix_files.items():
        outdir = os.path.join(root, "tenants", name)
        _assert_bitwise(outdir, files, matrix_refs[name])
        _assert_fsck_clean(outdir)
    assert artifacts.sweep_orphan_tmps(root, remove=False) == []
    for pid in orphans:   # the restarted supervisor fenced every orphan
        assert not os.path.exists(f"/proc/{pid}") or open(
            f"/proc/{pid}/stat").read().rsplit(")", 1)[-1].split()[0] == "Z"
    if victim != "supervisor":
        dead = [r for r in artifacts.read_records(os.path.join(root, "fleet.jsonl"))
                if r.get("event") == "dead"]
        assert dead, "the health loop never declared the victim dead"
