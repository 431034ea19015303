"""Port parity, the streaming detection service: ``service/`` and the
``serve`` verb of das4whales_tpu_torch (``"device": "cpu"``) against
das4whales_tpu's service (float32, x64 off, ``mf_engine``/``fk_engine=
"fft"``) on the same files.

Two tenants share one scheduler: ``mf`` (the matched filter, on JAX's own
design loaded from its checkpoint, batch 2, exact buckets) over the
chaos file set and ``learned`` (the pretrained ``fin_cnn``, batch 2) over
three 32 x 3000 scenes. Contract: each tenant's manifest equals JAX's
service record by record (less wall times, span ids, pick counts and the
pick engine's name), its picks JAX's up to rounding knife edges
(``utils.parity``) and bitwise its own standalone port campaign; the
endpoints answer 200 throughout the run under hot polling with no lock
order inverted; an injected oom downshifts only its own tenant; an
injected pricer's admission pins the ladder as JAX's does; a real SIGTERM
drains, and a restart settles the rest, every file once.
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
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from das4whales_tpu import service as jservice
from das4whales_tpu.fleet import load_fleet_config as jload_fleet_config
from das4whales_tpu.io.synth import SyntheticCall, SyntheticScene, write_synthetic_file
from das4whales_tpu.models.matched_filter import MatchedFilterDetector as JaxDetector
from das4whales_tpu.service import ingest as jingest
from das4whales_tpu.utils import artifacts as jartifacts
from das4whales_tpu.utils import memory as jmemory
from das4whales_tpu.utils.checkpoint import save_design as jsave_design
from das4whales_tpu.workflows import campaign as jcampaign
from das4whales_tpu_torch import convert, faults
from das4whales_tpu_torch import service
from das4whales_tpu_torch.service import api as api_mod
from das4whales_tpu_torch.service import ingest
from das4whales_tpu_torch.telemetry import metrics as tmetrics
from das4whales_tpu_torch.utils import locks, memory
from das4whales_tpu_torch.workflows import campaign

from tests.conftest import CHAOS_NS, CHAOS_NX, CHAOS_SEL
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
SEL = CHAOS_SEL
LNX, LNS = 32, 3000
LSEL = [0, LNX, 1]
ENDPOINTS = ("/livez", "/readyz", "/metrics", "/tenants", "/slo", "/quality")


@pytest.fixture(scope="module")
def learned_set(tmp_path_factory):
    d = tmp_path_factory.mktemp("svc_learned")
    files = []
    for k in range(3):
        scene = SyntheticScene(nx=LNX, ns=LNS, dx=8.0, noise_rms=0.08, seed=90 + k,
                               calls=[SyntheticCall(t0=3.0 + 2.0 * k, x0_m=100.0 + 40.0 * k,
                                                    amplitude=0.8)])
        files.append(write_synthetic_file(str(d / f"s{k}.h5"), scene))
    return files


@pytest.fixture(scope="module")
def design(chaos_file_set, tmp_path_factory):
    """JAX's design at the chaos files' shape and its checkpoint."""
    meta = SyntheticScene(nx=CHAOS_NX, ns=CHAOS_NS).metadata
    with jax.enable_x64(False):
        jd = JaxDetector(meta, SEL, (CHAOS_NX, CHAOS_NS), pick_mode="sparse",
                         keep_correlograms=False, mf_engine="fft", fk_engine="fft")
        path = jsave_design(str(tmp_path_factory.mktemp("svc_design") / "d.npz"), jd.design)
    return dict(jd=jd, path=path, meta=meta)


def _specs(mod, files, lfiles, *, mf_kw, **kw):
    return [mod.TenantSpec(name="mf", files=list(files), channels=SEL, batch=2, bucket="exact",
                           admission=False, detector_kwargs=mf_kw, **kw),
            mod.TenantSpec(name="learned", files=list(lfiles), channels=LSEL, batch=2,
                           family="learned", admission=False, **kw)]


def _get(url, timeout=10.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return r.status, r.read().decode()


class _Poller:
    """A client thread polling every endpoint and one tenant's NDJSON
    stream with cursor resume while the service runs."""

    def __init__(self, url):
        self.url, self.codes, self.lines = url, [], []
        self.cursor = 0
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, name="svc-poller", daemon=True)

    def _run(self):
        while not self._stop.is_set():
            for ep in ENDPOINTS:
                self.codes.append((ep, _get(self.url + ep)[0]))
            code, body = _get(f"{self.url}/picks/mf?cursor={self.cursor}&wait_s=0.05")
            self.codes.append(("/picks", code))
            for line in body.splitlines():
                rec = json.loads(line)
                self.lines.append(rec)
                self.cursor = rec["cursor"]

    def __enter__(self):
        self._t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._t.join(30)


@pytest.fixture(scope="module")
def runs(chaos_file_set, learned_set, design, tmp_path_factory):
    """JAX's two-tenant service, the port's under hot polling (cost cards,
    quality and an SLO on), and each tenant's standalone port campaign."""
    out = tmp_path_factory.mktemp("svc_runs")
    with jax.enable_x64(False):
        jsvc = jservice.DetectionService(jservice.ServiceConfig(
            tenants=_specs(jservice, chaos_file_set, learned_set,
                           mf_kw=dict(mf_engine="fft", fk_engine="fft")),
            outdir=str(out / "jax"), persistent_cache=False)).start()
        try:
            jsvc.run(until_idle=True)
        finally:
            jsvc.stop()
    locks.reset_order_graph()
    tsvc = service.DetectionService(service.ServiceConfig(
        tenants=_specs(service, chaos_file_set, learned_set, mf_kw=dict(design=design["path"]),
                       slo_p95_s=60.0),
        outdir=str(out / "port"), device="cpu", cost_cards=True, quality=True)).start()
    try:
        with _Poller(tsvc.api.url) as poll:
            tres = tsvc.run(until_idle=True)
            time.sleep(0.2)
        final = {ep: _get(tsvc.api.url + ep) for ep in ENDPOINTS}
    finally:
        tsvc.stop()
    inversions = locks.inversions()
    std = {
        "mf": campaign.run_campaign_batched(chaos_file_set, SEL, str(out / "std_mf"), batch=2,
                                            bucket="exact", device="cpu",
                                            design=design["path"]),
        "learned": campaign.run_campaign_batched(learned_set, LSEL, str(out / "std_learned"),
                                                 batch=2, family="learned", device="cpu"),
    }
    return dict(out=out, tres=tres, poll=poll, final=final, inversions=inversions, std=std)


def _manifest(d):
    return jartifacts.read_records(os.path.join(str(d), "manifest.jsonl"))


def _norm(rec):
    out = {k: v for k, v in rec.items() if k not in ("wall_s", "span_id", "health", "n_picks")}
    for k in ("picks_file", "path"):
        if out.get(k):
            out[k] = os.path.basename(out[k])
    if "engines" in out:
        out["engines"] = {k: v for k, v in out["engines"].items() if k != "pick_engine"}
    return out


def _thresholds(picks_file):
    with np.load(picks_file) as z:
        return dict(zip([str(s) for s in z["template_names"]], z["thresholds"].tolist()))


def _assert_mf_knife_edges(design, jm, tm):
    from das4whales_tpu_torch.io.hdf5 import load_das_data
    from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector
    from das4whales_tpu_torch.utils.parity import envelopes, unexplained_differences

    td = MatchedFilterDetector.from_design(
        convert.design_from_arrays({f: getattr(design["jd"].design, f)
                                    for f in convert.DESIGN_FIELDS}), design["meta"],
        device="cpu")
    n = 0
    for a, b in zip(jm, tm):
        if a.get("status") != "done":
            continue
        pa, pb = jcampaign.load_picks(a["picks_file"]), campaign.load_picks(b["picks_file"])
        env = envelopes(td, load_das_data(a["path"], SEL, design["meta"], device="cpu").trace)
        for i, name in enumerate(pa):
            if not np.array_equal(pa[name], pb[name]):
                bad = unexplained_differences(pa[name], pb[name], env[i],
                                              _thresholds(b["picks_file"])[name])
                assert not bad, f"{a['path']} {name}: picks differ beyond rounding at {bad}"
            n += pb[name].shape[1]
    assert n > 0


def _assert_learned_knife_edges(jm, tm):
    from das4whales_tpu_torch.io.hdf5 import load_das_data
    from das4whales_tpu_torch.models.learned import LearnedDetector, load_pretrained
    from das4whales_tpu_torch.utils.parity import unexplained_learned_differences

    det = LearnedDetector(*load_pretrained(), device="cpu")
    meta = SyntheticScene(nx=LNX, ns=LNS, dx=8.0).metadata
    n = 0
    for a, b in zip(jm, tm):
        if a.get("status") != "done":
            continue
        pa, pb = jcampaign.load_picks(a["picks_file"]), campaign.load_picks(b["picks_file"])
        res = det(load_das_data(a["path"], LSEL, meta, device="cpu").trace)
        bad = unexplained_learned_differences(pa["CALL"], pb["CALL"], res.scores, res.centers,
                                              _thresholds(b["picks_file"])["CALL"], 1e-4)
        assert not bad, f"{a['path']}: picks differ beyond rounding at {bad}"
        n += pb["CALL"].shape[1]
    assert n > 0


def _same_health(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], float) or (isinstance(a[k], list) and a[k]
                                       and isinstance(a[k][0], float)):
            np.testing.assert_allclose(np.asarray(b[k], float), np.asarray(a[k], float),
                                       rtol=1e-5, atol=1e-30)
        else:
            assert a[k] == b[k], k


def test_two_tenant_service_matches_jax_record_for_record(runs, design):
    out = runs["out"]
    for name in ("mf", "learned"):
        jm, tm = _manifest(out / "jax" / name), _manifest(out / "port" / name)
        assert [_norm(r) for r in tm] == [_norm(r) for r in jm], name
        for a, b in zip(jm, tm):
            _same_health(a.get("health", {}), b.get("health", {}))
        assert [r.get("status") for r in tm if "path" in r] == ["done"] * len(
            [r for r in tm if "path" in r])
        (_assert_mf_knife_edges(design, jm, tm) if name == "mf"
         else _assert_learned_knife_edges(jm, tm))
    assert {k: (v.n_done, v.n_failed) for k, v in runs["tres"].items()} == {
        "mf": (4, 0), "learned": (3, 0)}


def test_each_tenant_is_bitwise_its_standalone_campaign(runs):
    for name, std in runs["std"].items():
        got = {r.path: r for r in runs["tres"][name].records}
        assert len(std.records) == len(got)
        for r in std.records:
            assert (got[r.path].status, got[r.path].rung) == (r.status, r.rung) == (
                "done", "batched:2")
            a, b = campaign.load_picks(r.picks_file), campaign.load_picks(got[r.path].picks_file)
            assert set(a) == set(b)
            for t in a:
                np.testing.assert_array_equal(a[t], b[t])


def test_endpoints_answer_throughout_and_no_lock_order_inverts(runs):
    poll = runs["poll"]
    assert poll.codes and all(code == 200 for _ep, code in poll.codes)
    assert {ep for ep, _ in poll.codes} >= set(ENDPOINTS) | {"/picks"}
    # cursor resume across polls: every mf manifest line once, in order
    lines = poll.lines
    assert [r["cursor"] for r in lines] == list(range(1, len(lines) + 1))
    assert len([r for r in lines if r.get("status") == "done"]) == 4
    assert runs["inversions"] == []
    metrics_text = runs["final"]["/metrics"][1]
    for name in ("das_lock_wait_seconds", "das_service_slabs_total", "das_pick_latency_seconds",
                 "das_slo_burn_rate", "das_quality_drift", "das_compiles_total"):
        assert name in metrics_text


def test_observatories_surface_per_tenant(runs):
    slo = json.loads(runs["final"]["/slo"][1])
    assert {r["tenant"] for r in slo["tenants"]} == {"mf", "learned"}
    assert all(r["state"] == "ok" and r["n_observed"] > 0 for r in slo["tenants"])
    q = json.loads(runs["final"]["/quality"][1])
    assert {r["tenant"] for r in q["tenants"]} == {"mf", "learned"}
    ready = json.loads(runs["final"]["/readyz"][1])
    assert ready["ok"] is True
    tenants = json.loads(runs["final"]["/tenants"][1])["tenants"]
    assert {t["tenant"]: t["n_done"] for t in tenants} == {"mf": 4, "learned": 3}
    out = runs["out"] / "port"
    cards = json.loads((out / "cost_cards.json").read_text())["cards"]
    assert {(c["bucket"].split("/")[0], c["program"]) for c in cards} >= {
        (f"{CHAOS_NX}x{CHAOS_NS}", "batched:2"), (f"{LNX}x{LNS}", "batched:2")}
    assert {r["tenant"] for r in json.loads((out / "quality.json").read_text())["tenants"]} == {
        "mf", "learned"}
    for name in ("mf", "learned"):
        summary = json.loads((out / name / "cost_card.json").read_text())
        assert summary["tenant"] == name and summary["priced"] is True


def _oom_plan(files):
    pinned = {os.path.basename(f): faults.FaultSpec("oom", "dispatch", 10**9, ("file", 1))
              for f in files}
    return faults.FaultPlan(0, pinned=pinned)


def test_injected_oom_downshifts_only_its_own_tenant(runs, chaos_file_set, learned_set, design,
                                                     tmp_path):
    """An oom on every ``mf`` dispatch above the per-file rung: ``mf``
    downshifts ``batched:2 -> file`` once (its own manifest), ``learned``
    stays at ``batched:2``; both tenants' picks bitwise the healthy run's."""
    svc = service.DetectionService(service.ServiceConfig(
        tenants=_specs(service, chaos_file_set, learned_set, mf_kw=dict(design=design["path"])),
        outdir=str(tmp_path), device="cpu"), fault_plans={"mf": _oom_plan(chaos_file_set)})
    svc.start()
    try:
        res = svc.run(until_idle=True)
    finally:
        svc.stop()
    assert [r.rung for r in res["mf"].records] == ["file"] * 4
    assert [r.rung for r in res["learned"].records] == ["batched:2"] * 3
    moves = {name: [(e["from"], e["to"]) for e in _manifest(tmp_path / name)
                    if e.get("event") == "downshift"] for name in ("mf", "learned")}
    assert moves == {"mf": [("batched:2", "file")], "learned": []}
    for name in ("mf", "learned"):
        healthy = {r.path: r.picks_file for r in runs["tres"][name].records}
        for r in res[name].records:
            a, b = campaign.load_picks(r.picks_file), campaign.load_picks(healthy[r.path])
            for t in a:
                np.testing.assert_array_equal(a[t], b[t])


def test_admission_pins_the_ladder_under_the_tenant_share_as_jax(chaos_file_set, design,
                                                                tmp_path, monkeypatch):
    """An injected pricer (a program at batch B peaks at B GiB) and a
    1.5 GiB share: both packages start the tenant at the per-file rung
    before any dispatch, ledgered as a preflight downshift naming the
    admission, and the manifests agree record for record."""
    def pricer(mod):
        def price(bdet, batch, dtype, *, with_health=False, health_clip=None):
            if mod is jmemory:
                return jmemory.MemoryStats(int(batch) * 2**30, 0, 0, 0)
            return memory.MemoryStats(int(batch) * 2**30, 0, 0)
        return price

    monkeypatch.setattr(jmemory, "batched_program_memory", pricer(jmemory))
    monkeypatch.setattr(memory, "batched_program_memory", pricer(memory))

    def spec(mod, **mf_kw):
        return mod.TenantSpec(name="a", files=list(chaos_file_set), channels=SEL, batch=2,
                              bucket="exact", admission=True, hbm_share_gb=1.5,
                              detector_kwargs=mf_kw)

    with jax.enable_x64(False):
        jsvc = jservice.DetectionService(jservice.ServiceConfig(
            tenants=[spec(jservice, mf_engine="fft", fk_engine="fft")],
            outdir=str(tmp_path / "jax"), persistent_cache=False)).start()
        try:
            jsvc.run(until_idle=True)
        finally:
            jsvc.stop()
    tsvc = service.DetectionService(service.ServiceConfig(
        tenants=[spec(service, design=design["path"])], outdir=str(tmp_path / "port"),
        device="cpu")).start()
    try:
        res = tsvc.run(until_idle=True)
    finally:
        tsvc.stop()
    jm, tm = _manifest(tmp_path / "jax" / "a"), _manifest(tmp_path / "port" / "a")
    assert [_norm(r) for r in tm] == [_norm(r) for r in jm]
    s = campaign.summarize_campaign(str(tmp_path / "port" / "a"))
    assert s["downshifts"] == 1
    ev = s["downshift_ledger"][0]
    assert ev.get("preflight") is True and ev["to"] == "file" and "admission" in ev["error"]
    assert [r.rung for r in res["a"].records] == ["file"] * 4


def test_slab_slicer_forms_jax_slabs(chaos_file_set, learned_set):
    from das4whales_tpu.io.stream import stream_strain_blocks as jstream
    from das4whales_tpu_torch.io.stream import stream_strain_blocks as tstream

    for files, sel, batch, bucket in ((chaos_file_set, SEL, 3, "pow2"),
                                      (list(learned_set) + list(chaos_file_set), SEL, 2,
                                       "exact")):
        got = {}
        for key, mod, stream in (("jax", jingest, jstream), ("port", ingest, tstream)):
            slicer = mod.SlabSlicer(batch=batch, bucket=bucket)
            slabs = []
            for path, blk in zip(files, stream(files, sel, as_numpy=True, engine="h5py")):
                slabs.extend(slicer.offer(mod.IngestItem(path=path, block=blk)))
            err = slicer.offer(mod.IngestItem(path="bad.h5", error=OSError("unreadable")))
            tail = slicer.flush_partial()
            got[key] = slabs + err + ([tail] if tail is not None else [])
        assert len(got["jax"]) == len(got["port"]) >= 3
        for a, b in zip(got["jax"], got["port"]):
            if isinstance(a, jingest.IngestItem):
                assert isinstance(b, ingest.IngestItem) and a.path == b.path
                continue
            np.testing.assert_array_equal(np.asarray(a.stack), np.asarray(b.stack))
            assert (a.paths, a.n_real, a.bucket_ns, a.index0) == (
                b.paths, b.n_real, b.bucket_ns, b.index0)


@pytest.mark.parametrize("policy", ["reject", "drop_oldest"])
def test_ring_buffer_policies_match_jax(policy):
    rng = np.random.default_rng(3)
    ops = rng.integers(0, 3, 60)
    rings = (jingest.RingBuffer(f"j-{policy}", capacity=3, policy=policy),
             ingest.RingBuffer(f"t-{policy}", capacity=3, policy=policy))
    trace = []
    for i, op in enumerate(ops):
        step = []
        for ring, mod in zip(rings, (jingest, ingest)):
            if op < 2:
                step.append(ring.push(mod.IngestItem(path=f"p{i}")))
            else:
                it = ring.pop()
                step.append(None if it is None else it.path)
            step.append(len(ring))
        assert step[:2] == step[2:]
        trace.append(step[0])
    assert (False in trace) == (policy == "reject")
    name = "das_ingest_rejected_total" if policy == "reject" else "das_ingest_dropped_total"
    assert tmetrics.REGISTRY.counter(name, labelnames=("tenant",)).value(
        tenant=f"t-{policy}") >= 1
    for ring in rings:
        ring.close()
    assert not rings[1].push(ingest.IngestItem(path="late"))
    assert rings[1].exhausted() == (len(rings[1]) == 0)


def test_ring_buffer_under_many_threads_loses_and_duplicates_nothing():
    """16 producers (``push_wait``) and 16 consumers on one small ring, with
    a shortened switch interval: every item comes out exactly once, and
    the ring's traced lock records no order inversion."""
    n_prod, per = 16, 200
    ring = ingest.RingBuffer("stress", capacity=4, policy="reject")
    got, got_lock = [], threading.Lock()
    done = threading.Event()

    def produce(p):
        for i in range(per):
            assert ring.push_wait(ingest.IngestItem(path=f"{p}-{i}"), timeout_s=30)

    def consume():
        while not done.is_set() or len(ring):
            it = ring.pop()
            if it is None:
                time.sleep(0)
                continue
            with got_lock:
                got.append(it.path)

    locks.reset_order_graph()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        cons = [threading.Thread(target=consume, name=f"c{k}") for k in range(16)]
        prods = [threading.Thread(target=produce, args=(p,), name=f"p{p}")
                 for p in range(n_prod)]
        for t in cons + prods:
            t.start()
        for t in prods:
            t.join(60)
        done.set()
        for t in cons:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in cons + prods)
    assert sorted(got) == sorted(f"{p}-{i}" for p in range(n_prod) for i in range(per))
    assert locks.inversions() == []


def test_http_ingest_backpressure_429(tmp_path):
    meta = {"fs": 200.0, "dx": 2.042, "nx": 4, "ns": 8}
    cfg = service.ServiceConfig(
        tenants=[service.TenantSpec(name="rej", channels=[0, 4, 1], ring_capacity=1,
                                    overflow="reject", metadata=meta),
                 service.TenantSpec(name="drop", channels=[0, 4, 1], ring_capacity=1,
                                    overflow="drop_oldest", metadata=meta)],
        outdir=str(tmp_path / "svc"), device="cpu")
    # API only: the scheduler never runs, so the second push meets a full ring
    svc = service.DetectionService(cfg)
    svc.api.start()
    try:
        block = np.zeros((4, 8), np.float32)

        def post(tenant):
            req = urllib.request.Request(
                f"{svc.api.url}/ingest/{tenant}", data=block.tobytes(),
                headers={"X-DAS-Shape": "4,8", "X-DAS-Dtype": "float32"}, method="POST")
            try:
                with urllib.request.urlopen(req, timeout=5) as r:
                    return r.status, dict(r.headers)
            except urllib.error.HTTPError as e:
                return e.code, dict(e.headers)

        assert post("rej")[0] == 202
        code, headers = post("rej")
        assert code == 429 and headers.get("Retry-After") == "1"
        assert post("drop")[0] == 202
        assert post("drop")[0] == 202
        drop = tmetrics.REGISTRY.counter("das_ingest_dropped_total", labelnames=("tenant",))
        assert drop.value(tenant="drop") >= 1
        assert post("nosuch")[0] == 404
        item = svc.tenant("rej").ring.pop()
        assert item.path == "rej-live-0" and item.block.trace.shape == (4, 8)
        assert item.block.metadata.fs == 200.0
    finally:
        svc.stop()


def test_ndjson_cursor_and_long_poll_under_a_concurrent_writer(tmp_path):
    """A reader long-polling the stream while a writer appends lines in two
    writes each: every record arrives once, in order; a torn tail is
    never surfaced; an idle poll waits out its ``wait_s``."""
    outdir = str(tmp_path)
    path = os.path.join(outdir, "manifest.jsonl")
    n = 40

    def writer():
        with open(path, "ab", buffering=0) as fh:
            for i in range(n):
                line = json.dumps({"seq": i, "pad": "x" * 40}).encode()
                fh.write(line[:11])
                time.sleep(0.001)
                fh.write(line[11:] + b"\n")
                time.sleep(0.001)

    w = threading.Thread(target=writer, name="manifest-writer")
    w.start()
    got, cursor = [], 0
    deadline = time.monotonic() + 30
    try:
        while len(got) < n and time.monotonic() < deadline:
            recs, cursor = api_mod._manifest_since(outdir, cursor, limit=7, wait_s=0.2)
            got.extend(recs)
            assert cursor == len(got)
    finally:
        w.join(5)
    assert [r["seq"] for r in got] == list(range(n))
    t0 = time.monotonic()
    recs, cur = api_mod._manifest_since(outdir, cursor, limit=7, wait_s=0.3)
    assert recs == [] and cur == cursor and time.monotonic() - t0 >= 0.25
    # the index lock is per manifest: holding one never stalls another
    other = tmp_path / "b"
    other.mkdir()
    (other / "manifest.jsonl").write_text(json.dumps({"seq": 0}) + "\n")
    with api_mod._index_for(path).lock:
        recs, cur = api_mod._manifest_since(str(other), 0, 10, 0.0)
    assert [r["seq"] for r in recs] == [0] and cur == 1


def _subprocess_env():
    # the service subprocesses run on the CPU on one intra-op thread
    return dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")


def _registry(tmp_path, tenants, name="reg.json"):
    path = tmp_path / name
    path.write_text(json.dumps({"outdir": str(tmp_path / "svc"), "port": 0, "device": "cpu",
                                "persistent_cache": False, "tenants": tenants}))
    return str(path)


def _serve(args, **kw):
    return subprocess.Popen([sys.executable, "-m", "das4whales_tpu_torch", "serve", *args],
                            cwd=str(ROOT), env=_subprocess_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, **kw)


@pytest.fixture(scope="module")
def drill_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("svc_drill")
    return [write_synthetic_file(str(d / f"d{k}.h5"), SyntheticScene(
        nx=CHAOS_NX, ns=CHAOS_NS, noise_rms=0.05, seed=400 + k,
        calls=[SyntheticCall(t0=1.0, x0_m=CHAOS_NX / 2 * 2.042, amplitude=2.0)]))
        for k in range(8)]


def test_sigterm_drains_and_a_restart_settles_every_file_once(drill_files, tmp_path):
    """A real SIGTERM to a ``serve`` process mid-run: it drains (in-flight
    slabs resolve, manifests flush) and exits 0; a restarted
    ``serve --until-idle`` skips the settled files at the source and
    finishes the rest — every file ``done`` exactly once."""
    tenant = {"name": "a", "files": drill_files, "channels": SEL, "batch": 2,
              "bucket": "exact", "realtime_factor": 12.0, "ring_capacity": 2}
    reg = _registry(tmp_path, [tenant])
    manifest = tmp_path / "svc" / "a" / "manifest.jsonl"
    proc = _serve([reg])
    try:
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline and proc.poll() is None:
            if manifest.exists() and manifest.read_text().count('"done"') >= 2:
                break
            time.sleep(0.02)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=90)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-2000:]
    first = [r for r in jartifacts.read_records(str(manifest)) if "path" in r]
    assert 0 < len(first) < len(drill_files), "the drain must land mid-run"
    tenant["realtime_factor"] = None
    reg2 = _registry(tmp_path, [tenant], "reg2.json")
    proc2 = _serve([reg2, "--until-idle"])
    out2, err2 = proc2.communicate(timeout=120)
    assert proc2.returncode == 0, err2[-2000:]
    assert f"{len(first)} skipped" in out2
    by_path: dict = {}
    for r in jartifacts.read_records(str(manifest)):
        if "path" in r:
            by_path.setdefault(r["path"], []).append(r["status"])
    assert sorted(by_path) == sorted(drill_files)
    assert all(sts == ["done"] for sts in by_path.values())


def test_serve_until_idle_runs_two_tenants_as_a_cpu_subprocess(chaos_file_set, learned_set,
                                                               design, tmp_path):
    reg = _registry(tmp_path, [
        {"name": "mf", "files": list(chaos_file_set), "channels": SEL, "batch": 2,
         "bucket": "exact", "detector_kwargs": {"design": design["path"]}},
        {"name": "learned", "files": list(learned_set), "channels": LSEL, "batch": 2,
         "family": "learned"}])
    proc = _serve([reg, "--until-idle", "--port", "0"])
    out, err = proc.communicate(timeout=180)
    assert proc.returncode == 0, err[-2000:]
    assert "tenant mf: 4 done, 0 failed" in out and "tenant learned: 3 done, 0 failed" in out
    for name, n in (("mf", 4), ("learned", 3)):
        assert len(campaign.load_settled(str(tmp_path / "svc" / name))) == n


def test_service_config_loader_round_trip(tmp_path):
    raw = {"outdir": str(tmp_path / "out"), "port": 0, "device": "cpu",
           "persistent_cache": "/nowhere", "tenants": [
               {"name": "a", "files": ["x.h5"], "channels": [0, 8, 1], "batch": 2,
                "overflow": "drop_oldest", "weight": 2.0, "family": "learned"}]}
    path = tmp_path / "svc.json"
    path.write_text(json.dumps(raw))
    cfg = service.load_service_config(str(path))
    t = cfg.tenants[0]
    assert (cfg.device, t.name, t.overflow, t.weight, t.bucket) == (
        "cpu", "a", "drop_oldest", 2.0, "exact")
    # a JAX registry (no device key, XLA's compile cache named) loads unchanged
    del raw["device"]
    path.write_text(json.dumps(raw))
    assert jservice.load_service_config(str(path)).persistent_cache == "/nowhere"
    assert service.load_service_config(str(path)).device is None
    raw["tenants"][0]["bogus_knob"] = 1
    path.write_text(json.dumps(raw))
    with pytest.raises(ValueError, match="bogus_knob"):
        service.load_service_config(str(path))
    path.write_text(json.dumps({"tenants": []}))
    with pytest.raises(ValueError, match="no tenants"):
        service.load_service_config(str(path))
    with pytest.raises(ValueError, match="unknown detector family"):
        service.TenantSpec(name="z", family="nope")


def test_other_cli_verbs_exit_nonzero_naming_their_item(capsys, tmp_path):
    """The campaign's mesh flags run, and without a card refuse naming it
    before reading a file (their runs: tests/test_torch_campaign_sharded.py
    and tests/test_torch_cli.py). The fleet verb
    runs, and its registry is checked as the JAX package's is before any
    worker starts: duplicate tenant names and zero workers fail naming
    the fault (running fleets: tests/test_torch_fleet.py). The other verbs
    run (tests/test_torch_cli*.py)."""
    from das4whales_tpu_torch.__main__ import main

    # the campaign's mesh flags run (tests/test_torch_campaign_sharded.py);
    # without a card they refuse naming it, before reading a file
    for argv in (["campaign", "x.h5", "--sharded"], ["campaign", "x.h5", "--multihost"]):
        if torch.cuda.is_available():
            break
        with pytest.raises(RuntimeError, match="CUDA device"):
            main(argv)
    cfg = tmp_path / "fleet.json"
    for raw, err in (({"tenants": [{"name": "a"}, {"name": "a"}]}, "duplicate tenant names"),
                     ({"tenants": [{"name": "a"}], "workers": 0}, "at least one worker")):
        cfg.write_text(json.dumps(dict(raw, root=str(tmp_path / "f"))))
        with pytest.raises(ValueError, match=err):
            jload_fleet_config(str(cfg))
        with pytest.raises(ValueError, match=err):
            main(["fleet", str(cfg), "--device", "cpu"])
        assert "Service and fleet" not in capsys.readouterr().err
    assert not (tmp_path / "f").exists()
