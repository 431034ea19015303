"""Port parity, the observatories: ``telemetry.slo``, ``telemetry.quality``,
``telemetry.costs`` and ``utils.locks`` of das4whales_tpu_torch against
das4whales_tpu's on the same inputs (seeded numpy).

Contract: SLO burn rates and states equal JAX's on the same latency
series; ``file_quality`` records and the drift baselines' states equal,
their numbers within 1e-6 relative; the cost cards hold no TPU constant
and name the card whose peaks they use; the traced locks record the
same order graph and inversions.
"""

from __future__ import annotations

import math
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from das4whales_tpu.ops import health as jhealth
from das4whales_tpu.telemetry import quality as jquality
from das4whales_tpu.telemetry import slo as jslo
from das4whales_tpu.utils import locks as jlocks
from das4whales_tpu_torch.ops import health as thealth
from das4whales_tpu_torch.telemetry import costs, metrics, quality, slo
from das4whales_tpu_torch.utils import locks
from tests.torch_threads import one_torch_thread  # noqa: F401

REL = 1e-6


def _latencies(seed: int, n: int = 400):
    """A latency series with a slow regime in its middle third, and the
    monotonic stamps it arrives at (seconds)."""
    rng = np.random.default_rng(seed)
    lat = rng.gamma(2.0, 0.5, n)
    lat[n // 3 : 2 * n // 3] *= 6.0
    stamps = np.cumsum(rng.exponential(2.5, n))
    return lat.tolist(), stamps.tolist()


@pytest.mark.parametrize("seed,target,objective,windows", [
    (1, 2.0, 0.95, (60.0, 600.0)),
    (2, 5.0, 0.99, (30.0, 300.0)),
    (3, 1.0, 0.9, (60.0,)),
    (4, 50.0, 0.95, (60.0, 600.0)),
])
def test_slo_burn_rates_and_states_match_jax(seed, target, objective, windows):
    lat, stamps = _latencies(seed)
    a = jslo.TenantSLO(f"j{seed}", jslo.SLOPolicy(target, objective, windows))
    b = slo.TenantSLO(f"t{seed}", slo.SLOPolicy(target, objective, windows))
    states = set()
    for i, (x, now) in enumerate(zip(lat, stamps)):
        a.observe(x, now=now)
        b.observe(x, now=now)
        if i % 7 == 0:
            ra, rb = a.burn_rates(now), b.burn_rates(now)
            assert ra == rb
            assert a.state(now) == b.state(now)
            states.add(b.state(now))
    sa, sb = a.snapshot(stamps[-1]), b.snapshot(stamps[-1])
    sa.pop("tenant"), sb.pop("tenant")
    assert sa == sb
    # the series reach both ends of the verdicts
    assert states == {"ok"} if target >= 50 else "burning" in states


def test_slo_gauge_decays_and_latency_histogram_records():
    b = slo.TenantSLO("decay", slo.SLOPolicy(1.0, 0.95, (10.0,)))
    for t in range(5):
        b.observe(9.0, now=float(t))
    assert b.state(4.0) == "burning"
    assert b.burn_rates(100.0) == {10.0: 0.0}      # the breaches aged out
    assert b.state(100.0) == "ok"
    g = metrics.REGISTRY.gauge("das_slo_burn_rate", labelnames=("tenant", "window"))
    assert g.value(tenant="decay", window="10s") == 0.0
    slo.observe_pick_latency("decay", 0.25)
    h = metrics.snapshot()["das_pick_latency_seconds"]["values"]
    assert any(r["labels"].get("tenant") == "decay" and r["count"] >= 1 for r in h)
    assert slo.window_label(59.6) == jslo.window_label(59.6) == "60s"
    assert slo.DEFAULT_WINDOWS == jslo.DEFAULT_WINDOWS
    assert slo.DEFAULT_OBJECTIVE == jslo.DEFAULT_OBJECTIVE


def _close(a, b, where=""):
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _close(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{where}[{i}]")
    elif isinstance(a, float) and isinstance(b, float):
        if math.isnan(a):
            assert math.isnan(b), where
        else:
            assert abs(a - b) <= REL * max(abs(a), abs(b), 1e-30), (where, a, b)
    else:
        assert a == b, (where, a, b)


def _random_record(rng, k: int):
    names = ("HF", "LF", "B3")[: 1 + k % 3]
    picks = {n: rng.integers(0, 400, size=(2, int(rng.integers(0, 30)))) for n in names}
    thr = {n: float(rng.uniform(1e-3, 5.0)) for n in names}
    if k % 4 == 3:
        thr[names[0]] = float("nan")   # a template without a threshold
    stats = {"rms": float(rng.uniform(1e-11, 2.0)), "dead_frac": float(rng.uniform(0, 0.2))}
    factors = {n: float(rng.uniform(0.5, 2.0)) for n in names} if k % 2 else None
    return names, picks, thr, stats, factors


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_file_quality_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for k in range(12):
        _names, picks, thr, stats, factors = _random_record(rng, k)
        dur = None if k == 5 else float(rng.uniform(1, 120))
        kw = dict(duration_s=dur, thr_factors=factors,
                  thr_scope="per_template" if k % 3 else "global")
        a = jquality.file_quality(f"f{k}.h5", picks, thr, stats, **kw)
        b = quality.file_quality(f"f{k}.h5", picks, thr, stats, **kw)
        _close(a, b, f"record {k}")
    # a count mapping instead of pick arrays
    a = jquality.file_quality("c.h5", {"HF": 3, "LF": 0}, {"HF": 1.0}, {"rms": 0.1})
    b = quality.file_quality("c.h5", {"HF": 3, "LF": 0}, {"HF": 1.0}, {"rms": 0.1})
    _close(a, b)


def test_file_quality_from_the_health_profile_matches_jax():
    """The noise floor and dead fraction come from each package's health
    profile of the same block (two channels dead, a clipped run)."""
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1.5, (96, 700)).astype(np.float32)
    x[[5, 40]] = 0.0
    x[60, 10:20] = 9.0
    with jax.enable_x64(False):
        counts, rms, bc, brms = jax.device_get(jhealth.health_stats_profiled(x, 8.0))
        jstats = jhealth.stats_to_dict(np.array(counts), np.array(rms), x.size, np.array(bc),
                                       np.array(brms), 96)
    parts = thealth.health_stats_profiled(torch.from_numpy(x), 8.0)
    tstats = thealth.stats_to_dict(*[p.numpy() for p in parts[:2]], x.size,
                                   *[p.numpy() for p in parts[2:]], 96)
    assert tstats["dead_frac"] == jstats["dead_frac"] == 2 / 96
    picks = {"HF": np.zeros((2, 4), np.int64)}
    a = jquality.file_quality("h.h5", picks, {"HF": 2.0}, jstats, duration_s=3.5)
    b = quality.file_quality("h.h5", picks, {"HF": 2.0}, tstats, duration_s=3.5)
    _close(a, b)


def _regime_series(seed: int, n: int = 80):
    rng = np.random.default_rng(seed)
    x = rng.normal(10.0, 0.3, n)
    x[40:55] += 8.0          # a regime change the baseline must flag, then absorb
    x[70] = 100.0            # a lone spike: no warn
    return x.tolist()


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_drift_states_match_jax(seed):
    pol_kw = dict(alpha=0.1, warmup=12, enter_sigma=5.0, exit_sigma=2.0,
                  enter_consecutive=3, exit_consecutive=5, sigma_floor_frac=0.05)
    a = jquality.DriftBaseline(jquality.DriftPolicy(**pol_kw))
    b = quality.DriftBaseline(quality.DriftPolicy(**pol_kw))
    seen = []
    for v in _regime_series(seed):
        sa, sb = a.observe(v), b.observe(v)
        assert sa == sb
        seen.append(sb)
        _close(a.snapshot(), b.snapshot())
    assert "warn" in seen and seen[-1] == "ok"


def test_quality_observatory_snapshot_matches_jax(tmp_path):
    rng = np.random.default_rng(21)
    ja, tb = jquality.QualityObservatory(), quality.QualityObservatory()
    ja.fresh("x"), tb.fresh("x")
    for k in range(30):
        _names, picks, thr, stats, factors = _random_record(rng, k)
        if k > 20:
            stats["rms"] *= 50.0
        ja.observe("x", jquality.file_quality(f"f{k}", picks, thr, stats, 10.0, factors))
        tb.observe("x", quality.file_quality(f"f{k}", picks, thr, stats, 10.0, factors))
    _close(ja.snapshot(["x"]), tb.snapshot(["x"]))
    assert tb.drifting_tenants(["x"]) == ja.drifting_tenants(["x"])
    assert quality.export_json(str(tmp_path / "q.json"), tenants=["x"]) == str(tmp_path / "q.json")


def test_rel_threshold_and_factor_map_mirror_the_detector():
    from das4whales_tpu_torch.io.synth import SyntheticScene
    from das4whales_tpu_torch.models import matched_filter as tmf

    assert quality.REL_THRESHOLD == tmf.REL_THRESHOLD == jquality.REL_THRESHOLD
    assert quality.DRIFT_SIGNALS == jquality.DRIFT_SIGNALS
    det = tmf.MatchedFilterDetector(SyntheticScene(nx=24, ns=900).metadata, [0, 24, 1],
                                    (24, 900), templates="fin-variants", device="cpu")
    fm = quality.threshold_factor_map(det.design)
    assert list(fm) == list(det.design.template_names)
    assert fm == jquality.threshold_factor_map(det.design)
    assert quality.threshold_factor_map(None) is None


def test_lock_order_inversions_match_jax():
    """AB then BA on two lock classes, and two instances of one class
    nested: each package records the same inversions."""
    for mod in (jlocks, locks):
        mod.reset_order_graph()
        a1, a2, b = mod.new_lock("A"), mod.new_lock("A"), mod.new_lock("B")
        with a1:
            with b:
                pass
        assert mod.inversions() == []

        def other():
            with b:
                with a1:
                    pass

        t = threading.Thread(target=other, name="inverter")
        t.start()
        t.join(5)
        with a1:
            with a2:
                pass
    ji, ti = jlocks.inversions(), locks.inversions()
    assert [i["cycle"] for i in ti] == [i["cycle"] for i in ji] == [
        ["A", "B", "A"], ["A", "A"]]
    assert locks.order_edges() == jlocks.order_edges() == {"A": ("B",), "B": ("A",)}
    assert locks.find_cycle() is not None
    locks.reset_order_graph()
    jlocks.reset_order_graph()
    assert locks.inversions() == [] and locks.find_cycle() is None


def test_traced_lock_feeds_the_histograms_and_conditions():
    lk = locks.new_lock("obs-test")
    cond = threading.Condition(lk)
    hits = []
    locks.set_yield(lambda: hits.append(1))
    try:
        with cond:
            cond.wait(0.01)
    finally:
        locks.set_yield(None)
    assert hits
    snap = metrics.snapshot()
    for name in ("das_lock_wait_seconds", "das_lock_held_seconds"):
        rows = snap[name]["values"]
        assert any(r["labels"].get("name") == "obs-test" and r["count"] >= 1 for r in rows)


def test_device_peaks_name_the_card_and_hold_no_tpu_constant():
    src = Path(costs.__file__).read_text()
    for tpu in ("819e9", "98e12", "197e12", "v5e", "TPU"):
        assert tpu not in src
    h100 = costs.KNOWN_PEAKS["NVIDIA H100 80GB HBM3"]
    assert h100.name == "NVIDIA H100 80GB HBM3" and h100.known
    assert "H100" in h100.source
    assert not costs.device_peaks("cpu").known
    assert costs.device_peaks("cpu").name == "cpu"
    assert costs.DevicePeaks("Some Card", None, None, None).known is False


def test_cost_card_roofline_only_with_known_peaks():
    kw = dict(program="batched:2", bucket="24x1024/float32", engine="fft", batch=2,
              templates=2, flops=6.7e12, bytes_accessed=3.35e12, transcendentals=0.0,
              peak_bytes=2**30, argument_bytes=2**20, compile_seconds=0.5)
    on_card = costs.CostCard(device="NVIDIA H100 80GB HBM3", **kw)
    assert on_card.predicted_wall_s() == pytest.approx(1.0)
    d = on_card.as_dict()
    assert d["source"] == "counted" and d["contract"] == "unchecked"
    assert d["device"] == "NVIDIA H100 80GB HBM3"
    elsewhere = costs.CostCard(device="Other Card", **kw)
    assert elsewhere.predicted_wall_s() is None and elsewhere.as_dict()["predicted_wall_s"] is None
    costs.reset()
    try:
        costs.REGISTRY.record(elsewhere)
        assert costs.note_slab_resolved(kw["bucket"], "batched:2", "fft", 0.3) is None
        assert costs.note_slab_resolved(kw["bucket"], "batched:4", "fft", 0.3) is None
        payload = costs.cards_payload()
        assert payload["devices"]["Other Card"]["flops"] is None
        assert len(payload["cards"]) == 1
    finally:
        costs.reset()
    assert costs.bucket_label((24, 1024, "float32")) == "24x1024/float32"
    assert costs.sample_hbm("cpu", force=True) is None
