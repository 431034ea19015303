"""Port parity, the memory preflight and the campaigns' observatories:
``utils.memory``, the facades' ``program_spec`` and ``preflight=``,
``cost_cards=`` and ``quality=`` in both campaign entries of
das4whales_tpu_torch (``device="cpu"``) against das4whales_tpu's (float32,
x64 off, ``mf_engine``/``fk_engine="fft"``).

On the CPU the port measures nothing (no device memory to admit
against: the probe returns None, which fits), so the placement tests
inject one pricer into both packages (``batched_program_memory``): a
program's peak is B GiB. Contract: the fitting policy is JAX's and a
brute force's; a preflight pins and skips exactly as JAX's (manifests
equal record by record, less wall times, span ids and pick counts); and
with the three switches on, every pick is bitwise what it is with them
off.
"""

from __future__ import annotations

import json
import os

import jax
import numpy as np
import pytest

from das4whales_tpu.utils import artifacts as jartifacts
from das4whales_tpu.utils import memory as jmemory
from das4whales_tpu.workflows import campaign as jcampaign
from das4whales_tpu_torch.telemetry import costs
from das4whales_tpu_torch.utils import memory
from das4whales_tpu_torch.workflows import campaign

from tests.conftest import CHAOS_SEL
from tests.torch_threads import one_torch_thread  # noqa: F401

SEL = CHAOS_SEL
GIB = 2**30


def _brute_first(peaks: dict, cands, budget):
    for c in cands:
        p = peaks[c]
        if p is None or p < budget:
            return c
    return None


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_first_fitting_and_max_fitting_batch_match_brute_force_and_jax(seed):
    rng = np.random.default_rng(seed)
    cands = [int(c) for c in rng.permutation([1, 2, 4, 8, 16])]
    peaks = {c: (None if rng.random() < 0.15 else int(rng.integers(1, 40)) * GIB)
             for c in cands}
    for budget in (0, 5 * GIB, 17 * GIB, 64 * GIB):
        def tprice(c):
            p = peaks[c]
            return None if p is None else memory.MemoryStats(p, 0, 0)

        def jprice(c):
            p = peaks[c]
            return None if p is None else jmemory.MemoryStats(p, 0, 0, 0)

        want = _brute_first(peaks, cands, budget)
        assert memory.first_fitting(tprice, cands, budget) == want
        assert jmemory.first_fitting(jprice, cands, budget) == want
        largest = _brute_first(peaks, sorted(cands, reverse=True), budget)
        assert memory.max_fitting_batch(tprice, cands, budget) == largest
        assert jmemory.max_fitting_batch(jprice, cands, budget) == largest


def test_memory_stats_fits_and_an_exhausted_probe_fits_nothing():
    st = memory.MemoryStats(temp_bytes=3 * GIB, output_bytes=GIB, argument_bytes=2 * GIB)
    assert st.peak == 4 * GIB and st.total == 6 * GIB
    assert st.fits(5 * GIB) and not st.fits(4 * GIB)
    oom = memory.MemoryStats(temp_bytes=80 * GIB, output_bytes=0, argument_bytes=GIB,
                             exhausted=True)
    assert not oom.fits(10**15)
    assert memory.first_fitting(lambda c: oom, [4, 2, 1], 10**15) is None


def _facades(chaos_file_set):
    from das4whales_tpu_torch.io.stream import stream_strain_blocks
    from das4whales_tpu_torch.models.learned import LearnedDetector, load_pretrained
    from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector
    from das4whales_tpu_torch.parallel.batch import batched_detector_for

    blk = next(stream_strain_blocks(chaos_file_set[:1], SEL, as_numpy=True))
    shape = np.asarray(blk.trace).shape
    mf = MatchedFilterDetector(blk.metadata, SEL, shape, pick_mode="sparse",
                               keep_correlograms=False, device="cpu")
    learned = LearnedDetector(*load_pretrained(), device="cpu")
    return shape, {"mf": batched_detector_for(mf),
                   "learned": batched_detector_for(learned, trace_shape=shape)}


@pytest.mark.parametrize("family", ["mf", "learned"])
def test_program_spec_runs_its_program_and_prices_nothing_on_the_cpu(chaos_file_set, family):
    import torch

    shape, bdets = _facades(chaos_file_set)
    bd = bdets[family]
    spec = bd.program_spec(2, np.float32, with_health=True, health_clip=None)
    assert spec.family == family and spec.shape == (2,) + shape
    assert spec.key[:4] == (family, shape[0], shape[1], 2)
    assert spec.flops > 0 and spec.bytes_accessed > 0 and spec.stages
    out = spec.run(torch.zeros(spec.shape))
    assert out is not None
    assert memory.probe_program(spec) is None
    assert memory.batched_program_memory(bd, 2, np.float32, with_health=True) is None
    an = memory.batched_program_analysis(bd, 2, np.float32, with_health=True)
    assert an.memory is None and an.compile_seconds == 0.0 and an.flops == spec.flops
    # the batch axis scales the counted work
    assert bd.program_spec(4, np.float32).flops > spec.flops


def _picks(res):
    return {os.path.basename(r.path): campaign.load_picks(r.picks_file)
            for r in res.records if r.status == "done"}


def _same_picks(a, b):
    assert set(a) == set(b) and a
    for f in a:
        assert set(a[f]) == set(b[f])
        for name in a[f]:
            np.testing.assert_array_equal(a[f][name], b[f][name])


@pytest.mark.parametrize("entry", ["batched", "per_file"])
def test_the_three_switches_change_no_pick(chaos_file_set, tmp_path, entry):
    """``preflight``, ``cost_cards`` and ``quality`` on: every pick bitwise
    the run's with them off; ``cost_cards.json``, ``quality.json`` and a
    manifest ``quality`` event appear."""
    run = (campaign.run_campaign_batched if entry == "batched" else campaign.run_campaign)
    kw = dict(batch=2, bucket="exact") if entry == "batched" else {}
    off = run(chaos_file_set, SEL, str(tmp_path / "off"), device="cpu", preflight=False,
              cost_cards=False, quality=False, **kw)
    costs.reset()
    on = run(chaos_file_set, SEL, str(tmp_path / "on"), device="cpu", preflight=True,
             cost_cards=True, quality=True, **kw)
    assert [(r.status, r.rung) for r in on.records] == [(r.status, r.rung) for r in off.records]
    _same_picks(_picks(off), _picks(on))
    out = tmp_path / "on"
    cards = json.loads((out / "cost_cards.json").read_text())["cards"]
    assert cards and all(c["source"] == "counted" and c["device"] == "cpu" for c in cards)
    assert {c["program"] for c in cards} >= {"batched:2" if entry == "batched" else "file"}
    q = json.loads((out / "quality.json").read_text())
    assert q["tenants"][0]["tenant"] == "campaign"
    assert q["tenants"][0]["n_files"] == len(chaos_file_set)
    events = [e for e in jartifacts.read_records(str(out / "manifest.jsonl"))
              if e.get("event") == "quality"]
    assert len(events) == 1
    assert not (tmp_path / "off" / "quality.json").exists()
    assert not (tmp_path / "off" / "cost_cards.json").exists()


def _pricer(mod, peaks_gib):
    """A pricer: the program at batch B peaks at ``peaks_gib(B, bdet)`` GiB
    (None: unpriced)."""
    def price(bdet, batch, dtype, *, with_health=False, health_clip=None):
        g = peaks_gib(int(batch), bdet)
        if g is None:
            return None
        if mod is jmemory:
            return jmemory.MemoryStats(int(g * GIB), 0, 0, 0)
        return memory.MemoryStats(int(g * GIB), 0, 0)
    return price


def _norm(rec):
    out = {k: v for k, v in rec.items()
           if k not in ("wall_s", "span_id", "health", "n_picks", "engines")}
    for k in ("picks_file", "path"):
        if out.get(k):
            out[k] = os.path.basename(out[k])
    return out


def _manifest(outdir):
    return jartifacts.read_records(os.path.join(str(outdir), "manifest.jsonl"))


def _both_batched(chaos_file_set, tmp_path, monkeypatch, peaks_gib, budget_gb):
    monkeypatch.setenv("DAS_HBM_BUDGET_GB", str(budget_gb))
    monkeypatch.setattr(jmemory, "batched_program_memory", _pricer(jmemory, peaks_gib))
    monkeypatch.setattr(memory, "batched_program_memory", _pricer(memory, peaks_gib))
    with jax.enable_x64(False):
        jcampaign.run_campaign_batched(chaos_file_set, SEL, str(tmp_path / "jax"), batch=4,
                                       bucket="exact", preflight=True, mf_engine="fft",
                                       fk_engine="fft", persistent_cache=False)
    tres = campaign.run_campaign_batched(chaos_file_set, SEL, str(tmp_path / "port"), batch=4,
                                         bucket="exact", preflight=True, device="cpu")
    jm, tm = _manifest(tmp_path / "jax"), _manifest(tmp_path / "port")
    assert [_norm(r) for r in tm] == [_norm(r) for r in jm]
    return tres, tm


def test_batched_preflight_pins_the_largest_fitting_batch_as_jax(chaos_file_set, tmp_path,
                                                               monkeypatch):
    """A budget between the B=2 and B=4 peaks: both packages start the
    bucket at ``batched:2`` before any dispatch (one preflight
    downshift), and the port's picks are bitwise a run at batch 2
    without the preflight."""
    tres, tm = _both_batched(chaos_file_set, tmp_path, monkeypatch, lambda b, _: float(b), 3)
    moves = [e for e in tm if e.get("event") == "downshift"]
    assert len(moves) == 1 and moves[0]["preflight"] is True
    assert (moves[0]["from"], moves[0]["to"]) == ("batched:4", "batched:2")
    assert [(r.status, r.rung) for r in tres.records] == [("done", "batched:2")] * 4
    monkeypatch.delenv("DAS_HBM_BUDGET_GB")
    ref = campaign.run_campaign_batched(chaos_file_set, SEL, str(tmp_path / "b2"), batch=2,
                                        bucket="exact", device="cpu")
    _same_picks(_picks(ref), _picks(tres))


def test_batched_preflight_skips_a_bucket_nothing_fits_as_jax(chaos_file_set, tmp_path,
                                                             monkeypatch):
    """Every rung, the tiled one included, over the budget: the bucket is
    skipped before dispatch (a ``preflight_skip`` event, each file
    ``failed``) in both packages."""
    tres, tm = _both_batched(chaos_file_set, tmp_path, monkeypatch,
                             lambda b, _: 100.0 + b, 1)
    skips = [e for e in tm if e.get("event") == "preflight_skip"]
    assert len(skips) == 1 and "skipped before dispatch" in skips[0]["reason"]
    assert [r.status for r in tres.records] == ["failed"] * 4


def test_per_file_preflight_starts_at_the_first_fitting_rung(chaos_file_set, tmp_path,
                                                            monkeypatch):
    """``run_campaign(preflight=True)`` (the port's; JAX's per-file entry
    has no preflight): the per-file program over the budget, the tiled
    one under it — the run starts at ``tiled``, one preflight downshift
    ledgered, picks bitwise the unpinned run's."""
    def peaks(b, bdet):
        return 1.0 if bdet.det._route() == "tiled" else 5.0

    monkeypatch.setenv("DAS_HBM_BUDGET_GB", "2")
    monkeypatch.setattr(memory, "batched_program_memory", _pricer(memory, peaks))
    pinned = campaign.run_campaign(chaos_file_set, SEL, str(tmp_path / "pin"), device="cpu",
                                   preflight=True)
    assert [(r.status, r.rung) for r in pinned.records] == [("done", "tiled")] * 4
    moves = [e for e in _manifest(tmp_path / "pin") if e.get("event") == "downshift"]
    assert [(e["from"], e["to"], e.get("preflight")) for e in moves] == [
        ("file", "tiled", True)]
    plain = campaign.run_campaign(chaos_file_set, SEL, str(tmp_path / "plain"), device="cpu",
                                  preflight=False)
    _same_picks(_picks(plain), _picks(pinned))


def test_per_file_preflight_skips_when_no_card_rung_fits(chaos_file_set, tmp_path,
                                                         monkeypatch):
    """``run_campaign(preflight=True)`` with every card rung (per-file,
    tiled) over the budget: the run is skipped before dispatch — one
    ``preflight_skip`` event, each file ``failed``, no downshift — and is
    never pinned to the host rung, which the preflight does not price."""
    monkeypatch.setenv("DAS_HBM_BUDGET_GB", "1")
    monkeypatch.setattr(memory, "batched_program_memory", _pricer(memory, lambda b, _: 100.0))
    res = campaign.run_campaign(chaos_file_set, SEL, str(tmp_path / "skip"), device="cpu",
                                preflight=True)
    assert [r.status for r in res.records] == ["failed"] * len(chaos_file_set)
    assert all("skipped before dispatch" in r.error for r in res.records)
    events = [e for e in _manifest(tmp_path / "skip") if "event" in e]
    skips = [e for e in events if e["event"] == "preflight_skip"]
    assert len(skips) == 1 and "100.00 GiB" in skips[0]["reason"]
    assert not [e for e in events if e["event"] == "downshift"]


def _mf_facade(chaos_file_set, design=None, **kw):
    from das4whales_tpu_torch.io.stream import stream_strain_blocks
    from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector
    from das4whales_tpu_torch.parallel.batch import batched_detector_for

    blk = next(stream_strain_blocks(chaos_file_set[:1], SEL, as_numpy=True))
    if design is None:
        design = MatchedFilterDetector(blk.metadata, SEL, np.asarray(blk.trace).shape,
                                       device="cpu").design
    det = MatchedFilterDetector.from_design(design, blk.metadata, pick_mode="sparse",
                                            keep_correlograms=False, device="cpu", **kw)
    return design, batched_detector_for(det)


def test_probe_key_carries_what_sizes_the_program(chaos_file_set):
    """Two facades that agree on every buffer size share one probe key
    (the memo); the pick capacity, the template length or a learned
    configuration that differs gives another."""
    import dataclasses

    from das4whales_tpu_torch.models.learned import LearnedDetector, load_pretrained
    from das4whales_tpu_torch.parallel.batch import batched_detector_for

    design, base = _mf_facade(chaos_file_set)
    key = base.program_spec(2, np.float32).key
    assert _mf_facade(chaos_file_set, design)[1].program_spec(2, np.float32).key == key
    assert _mf_facade(chaos_file_set, design, max_peaks=64)[1].program_spec(
        2, np.float32).key != key
    assert _mf_facade(chaos_file_set, design, pick_pack_cap=64)[1].program_spec(
        2, np.float32).key != key
    longer = dataclasses.replace(design, templates=np.pad(design.templates, ((0, 0), (0, 8))))
    assert _mf_facade(chaos_file_set, longer)[1].program_spec(2, np.float32).key != key
    params, cfg = load_pretrained()
    shape = (len(range(*SEL)), 3000)

    def lkey(cfg_, **kw):
        det = LearnedDetector(params, cfg_, device="cpu", **kw)
        return batched_detector_for(det, trace_shape=shape).program_spec(2, np.float32).key

    assert lkey(cfg) == lkey(cfg)
    assert lkey(dataclasses.replace(cfg, hop=cfg.hop * 2)) != lkey(cfg)
    assert lkey(cfg, row_chunk=1024) != lkey(cfg)


@pytest.mark.parametrize("exhausted", [False, True])
def test_an_out_of_memory_probe_is_not_memoized(monkeypatch, exhausted):
    """A measured peak is kept for the program's key; an out-of-memory
    answer (which depends on what else held the card) is not: the next
    pricing probes again."""
    from types import SimpleNamespace

    runs = []

    def fake_measure(spec):
        runs.append(spec.key)
        return memory.MemoryStats(GIB, 0, 0, exhausted=exhausted), 0.5

    monkeypatch.setattr(memory, "_measure", fake_measure)
    memory.clear_probe_cache()
    spec = memory.ProgramSpec(family="mf", run=None, shape=(1, 2, 3), dtype=np.dtype("float32"),
                              device=SimpleNamespace(type="cuda"), key=("oom-test", exhausted))
    try:
        for _ in range(2):
            an = memory.probe_program(spec)
            assert an.memory.exhausted is exhausted and an.compile_seconds == 0.5
    finally:
        memory.clear_probe_cache()
    assert len(runs) == (2 if exhausted else 1)
