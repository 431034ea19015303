"""Port parity, the runtime guards: ``das4whales_tpu_torch.analysis``'s
probe-and-build guard, retrace forensics and seeded-interleaving guard.

* **Compile guard** — a "compile" of eager PyTorch is a priced program's
  cold probe (its recording run on the CPU) or a kernel library's build
  or load (``analysis/runtime.py``). Two same-shape ``detect_picks``
  calls probe at most once; a second pricing at the same key probes
  nothing; a batch change trips the guard, and ``torch_retrace_guard``
  names the argument that changed.
* **Race guard parity** — a seeded two-lock inversion raises
  ``LockOrderError`` and a torn iteration ``TornIterationError`` under
  both packages' guards, each over its own ``utils.locks``; one short run
  of the port's service under ``torch_race_guard``, with its endpoints
  polled from client threads (after ``tests/test_service.py``'s drill).
"""

from __future__ import annotations

import ctypes.util
import json
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from das4whales_tpu.analysis import concurrency_runtime as jcr
from das4whales_tpu.utils import locks as jlocks
from das4whales_tpu_torch.analysis import concurrency_runtime as tcr
from das4whales_tpu_torch.analysis import programs, runtime
from das4whales_tpu_torch.analysis.pytest_plugin import (  # noqa: F401
    torch_compile_guard,
    torch_race_guard,
    torch_retrace_guard,
)
from das4whales_tpu_torch.utils import build, locks, memory

from tests.conftest import CHAOS_NS, CHAOS_NX, CHAOS_SEL
from tests.torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def detector():
    from das4whales_tpu_torch.io.synth import SyntheticScene
    from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector

    return MatchedFilterDetector(SyntheticScene(nx=CHAOS_NX, ns=CHAOS_NS).metadata, CHAOS_SEL,
                                 (CHAOS_NX, CHAOS_NS), wire="raw", pick_mode="sparse",
                                 keep_correlograms=False, device="cpu")


# ---------------------------------------------------------------------------
# Compile guard and retrace forensics
# ---------------------------------------------------------------------------


def test_two_same_shape_detect_picks_probe_at_most_once(detector,
                                                        torch_compile_guard):  # noqa: F811
    raw = np.random.default_rng(0).integers(-2000, 2000, (CHAOS_NX, CHAOS_NS)).astype(np.int32)
    with torch_compile_guard.max_compiles(1, what="detect_picks"):
        a = detector.detect_picks(raw)
        b = detector.detect_picks(raw)
    for name in a.picks:
        assert np.array_equal(a.picks[name], b.picks[name])


def test_a_pricing_probes_cold_then_never_again(detector, torch_compile_guard):  # noqa: F811
    from das4whales_tpu_torch.parallel.batch import BatchedMatchedFilterDetector

    bdet = BatchedMatchedFilterDetector(detector, donate=False)
    memory.clear_probe_cache()
    try:
        an, cold = torch_compile_guard.count_compiles(
            memory.batched_program_analysis, bdet, 1, np.int32, capture_ops=True)
        again, warm = torch_compile_guard.count_compiles(
            memory.batched_program_analysis, bdet, 1, np.int32, capture_ops=True)
        with torch_compile_guard.forbid_recompile(what="warm pricing"):
            memory.batched_program_analysis(bdet, 1, np.int32, capture_ops=True)
    finally:
        memory.clear_probe_cache()
    assert (cold, warm) == (1, 0) and again.ops == an.ops


def test_a_batch_change_trips_the_guard_and_is_named(detector, torch_compile_guard,  # noqa: F811
                                                     torch_retrace_guard):  # noqa: F811
    from das4whales_tpu_torch.parallel.batch import BatchedMatchedFilterDetector

    bdet = BatchedMatchedFilterDetector(detector, donate=False)
    memory.clear_probe_cache()
    try:
        with pytest.raises(programs.RetraceError) as exc:
            with torch_retrace_guard(1, what="pricing") as g:
                price = g.watch(memory.batched_program_analysis, what="price")
                price(bdet, 1, np.int32, capture_ops=True)
                price(bdet, 1, np.int32, capture_ops=True)
                price(bdet, 2, np.int32, capture_ops=True)   # a new program key
        msg = str(exc.value)
        assert "arg[1]" in msg and "static value changed" in msg and "arg[2]" not in msg
        with pytest.raises(runtime.RecompileError, match="ceiling 0"):
            with torch_compile_guard.max_compiles(0, what="batch 4"):
                memory.batched_program_analysis(bdet, 4, np.int32, capture_ops=True)
    finally:
        memory.clear_probe_cache()


def test_signature_diff_names_shape_and_dtype():
    import torch

    prev = {"arg[0]": programs._arg_signature(torch.zeros(2, 3))}
    cur = {"arg[0]": programs._arg_signature(np.zeros((2, 4), np.int32))}
    (line,) = programs.signature_diff(prev, cur)
    assert "shape [2, 3] -> [2, 4]" in line and "dtype torch.float32 -> int32" in line


def test_a_kernel_library_load_counts_once(monkeypatch, torch_compile_guard):  # noqa: F811
    libc = ctypes.util.find_library("c") or "libc.so.6"
    monkeypatch.setattr(build, "build", lambda name: (Path(libc), 0.0, ""))
    name = f"guard-test-{time.monotonic_ns()}"
    _, first = torch_compile_guard.count_compiles(build.load, name)
    _, second = torch_compile_guard.count_compiles(build.load, name)
    assert (first, second) == (1, 0)


# ---------------------------------------------------------------------------
# Race guard parity: each package's guard over its own utils.locks
# ---------------------------------------------------------------------------

GUARDS = {"jax": (jcr, jlocks), "torch": (tcr, locks)}


@pytest.mark.parametrize("pkg", sorted(GUARDS))
def test_seeded_inversion_raises_lock_order_error(pkg):
    cr, lk = GUARDS[pkg]
    a, b = lk.new_lock(f"{pkg}-A"), lk.new_lock(f"{pkg}-B")
    with pytest.raises(cr.LockOrderError, match=f"{pkg}-A -> {pkg}-B"):
        with cr.race_guard(seed=1):
            with a:
                with b:
                    pass
            with b:
                with a:
                    pass
    lk.reset_order_graph()


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
@pytest.mark.parametrize("pkg", sorted(GUARDS))
def test_torn_iteration_raises(pkg):
    cr, _ = GUARDS[pkg]
    d = {i: i for i in range(3)}
    started, proceed = threading.Event(), threading.Event()

    def victim():
        it = iter(d)
        next(it)
        started.set()
        assert proceed.wait(5.0)
        next(it)       # d grew mid-iteration: RuntimeError

    with pytest.raises(cr.TornIterationError, match="changed size"):
        with cr.race_guard(seed=2):
            t = threading.Thread(target=victim, name="torn-victim")
            t.start()
            assert started.wait(5.0)
            d[99] = 99
            proceed.set()
            t.join(5.0)


def _get(url):
    with urllib.request.urlopen(url, timeout=10.0) as r:
        return r.status, r.read().decode()


def test_service_under_the_race_guard_with_hot_polling(chaos_file_set, tmp_path,
                                                       torch_race_guard):  # noqa: F811
    """The port's service over the chaos files under seeded interleaving,
    ``/tenants``, ``/metrics`` and ``/picks`` polled from a client thread
    each: every poll parses, cursors run 1..n, no lock order inverts, and
    the picks are bitwise the standalone batched campaign's."""
    from das4whales_tpu_torch import service
    from das4whales_tpu_torch.workflows import campaign

    ref = campaign.run_campaign_batched(chaos_file_set, CHAOS_SEL, str(tmp_path / "ref"),
                                        batch=2, bucket="exact", device="cpu")
    svc = service.DetectionService(service.ServiceConfig(
        tenants=[service.TenantSpec(name="a", files=list(chaos_file_set), channels=CHAOS_SEL,
                                    batch=2, bucket="exact", admission=False)],
        outdir=str(tmp_path / "svc"), device="cpu"))
    errors, polled, stop = [], {"/tenants": 0, "/metrics": 0, "/picks": 0}, threading.Event()

    def check(ep, body):
        if ep == "/tenants":
            assert {row["tenant"] for row in json.loads(body)["tenants"]} == {"a"}
        elif ep == "/metrics":
            assert "das_" in body
        else:
            lines = [json.loads(x) for x in body.splitlines()]
            assert [x["cursor"] for x in lines] == list(range(1, len(lines) + 1))

    with torch_race_guard(seed=0) as report:
        svc.start()

        def poll(ep, path):
            while not stop.is_set():
                try:
                    status, body = _get(svc.api.url + path)
                    assert status == 200
                    check(ep, body)
                    polled[ep] += 1
                except (urllib.error.URLError, OSError, AssertionError) as exc:
                    errors.append((ep, repr(exc)))
                    stop.set()
                time.sleep(0.002)

        pollers = [threading.Thread(target=poll, args=(ep, path), name=f"poll{ep.replace('/', '-')}")
                   for ep, path in (("/tenants", "/tenants"), ("/metrics", "/metrics"),
                                    ("/picks", "/picks/a?cursor=0"))]
        for t in pollers:
            t.start()
        try:
            results = svc.run(until_idle=True)
        finally:
            stop.set()
            for t in pollers:
                t.join(5)
            svc.stop()
        assert report.inversions() == []
    assert not errors, errors[:5]
    assert all(n > 0 for n in polled.values()), polled
    res = results["a"]
    assert res.n_done == len(chaos_file_set) and res.n_failed == 0
    want = {r.path: campaign.load_picks(r.picks_file) for r in ref.records}
    for r in res.records:
        got = campaign.load_picks(r.picks_file)
        assert set(got) == set(want[r.path])
        assert all(np.array_equal(got[k], want[r.path][k]) for k in got)
