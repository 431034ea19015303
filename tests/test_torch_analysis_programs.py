"""Port parity, the program-contract audit: ``das4whales_tpu_torch.
analysis.programs`` (R11, R13) after ``tests/test_programs.py``.

* **Synthetic streams** — each R11/R13 finding provoked from a hand-made
  op stream (no program runs) and silenced by its clean counterpart.
* **The canonical gate** — JAX's variant set (five matched-filter engine
  pairs at 24 x 900, the spectro, Gabor and learned facades at 16 x 2000)
  recorded on the CPU, once for the module, audits clean against the
  checked-in ``analysis/contracts.json``, and the snapshot round-trips.
  Each hand-written kernel is one stream entry, whose plain version the
  recorder does not descend into.
* **Capture costs nothing** — recording rides the probe's own run (no
  extra probe), changes no value, and a cost card's verdict is "clean"
  with the gate on and "unchecked" with it off, with bitwise equal picks
  and peaks either way.
"""

from __future__ import annotations

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from das4whales_tpu.analysis import programs as jprograms
from das4whales_tpu_torch.analysis import programs
from das4whales_tpu_torch.analysis.pytest_plugin import torch_compile_guard  # noqa: F401
from das4whales_tpu_torch.telemetry import costs
from das4whales_tpu_torch.utils import memory

from tests.conftest import CHAOS_NS, CHAOS_NX, CHAOS_SEL
from tests.torch_threads import one_torch_thread  # noqa: F401

R = programs.OpRecord


def art(ops, engine="fft+fft", wire="float32", bucket="24x900/float32"):
    return programs.ProgramArtifact(bucket=bucket, label="batched:1", engine=engine,
                                    wire_dtype=wire, ops=tuple(ops))


def codes(findings):
    return [f.code for f in findings]


CLEAN = [
    R("aten::sub", ("float32", "float32"), ("float32",), ("cpu", "cpu"), ("cpu",)),
    R("aten::_to_copy", ("int32",), ("float32",), ("cpu",), ("cpu",)),
    R("kernel:fused_picks"),
    R("fetch"),
]


# ---------------------------------------------------------------------------
# Synthetic streams
# ---------------------------------------------------------------------------


def test_clean_stream_is_green():
    assert programs.audit_program(art(CLEAN)) == []


@pytest.mark.parametrize("case", [
    ("R11", "f64-in-program", [R("aten::mul", ("float64",), ("float64",), ("cpu",), ("cpu",))],
     "float32"),
    ("R11", "bf16-outside-gate", [R("aten::_to_copy", ("float32",), ("bfloat16",))],
     "float32"),
    ("R13", "host-read-in-program", [R("aten::_local_scalar_dense", ("float32",), ())],
     "float32"),
    ("R13", "host-read-in-program",
     [R("aten::_to_copy", ("float32",), ("float32",), ("cuda",), ("cpu",))], "int32"),
    ("R13", "f64-transcendental", [R("aten::sqrt", ("float64",), ("float64",))], "float32"),
], ids=lambda c: f"{c[0]}-{c[1]}-{c[3]}")
def test_each_finding_is_provoked_by_its_stream(case):
    rule, code, ops, wire = case
    fs = programs.audit_program(art(CLEAN + ops, wire=wire), rules=(rule,))
    assert codes(fs) == [code]
    assert fs[0].path == f"program:{'24x900/float32'}" and fs[0].symbol == "batched:1|fft+fft"


def test_float64_wire_skips_the_float64_checks():
    wide = [R("aten::sqrt", ("float64",), ("float64",))]
    assert programs.audit_program(art(CLEAN + wide, wire="float64")) == []


def test_bf16_gate_allows_the_rounding_and_refuses_arithmetic():
    rounding = [R("aten::_to_copy", ("float32",), ("bfloat16",)),
                R("aten::_to_copy", ("bfloat16",), ("float32",))]
    assert programs.audit_program(art(CLEAN + rounding, engine="matmul-bf16+fft")) == []
    escaped = rounding + [R("aten::convolution", ("bfloat16", "bfloat16"), ("bfloat16",))]
    fs = programs.audit_program(art(CLEAN + escaped, engine="matmul-bf16+fft"))
    assert codes(fs) == ["bf16-escaped-matmul"] and "aten::convolution" in fs[0].message


def test_reads_inside_a_counted_scope_or_a_kernel_are_not_recorded():
    """The scopes of ``utils.oprecord`` note one entry and hide what runs
    inside: a device-to-host copy in ``fetch`` is the counted read."""
    from das4whales_tpu_torch.utils import oprecord

    def run(x):
        y = x + 1
        with oprecord.counted_read():
            z = y.sum().item()
        with oprecord.kernel("fused_picks"):
            w = (y * 2).sum().item()
        return z + w

    out, ops = programs.record_ops(run, torch.ones(3))
    assert out == 18.0
    assert [r.name for r in ops] == ["aten::add", "fetch", "kernel:fused_picks"]
    assert programs.audit_program(art(ops)) == []
    _, bare = programs.record_ops(lambda x: x.sum().item(), torch.ones(3))
    assert codes(programs.audit_program(art(bare))) == ["host-read-in-program"]


def test_op_ceiling_follows_jax_slack_policy():
    key = programs.contract_key("24x900/float32", "batched:1", "fft+fft")
    snap = {"programs": {key: {"convert": 0, "layout_copy": 0, "copy_": 0}}}
    conv = R("aten::_to_copy", ("int32",), ("float32",))
    # CLEAN holds one conversion: ceiling(0) = 4 allows four, not five
    assert programs.audit_program(art(CLEAN + [conv] * 3), snapshot=snap) == []
    fs = programs.audit_program(art(CLEAN + [conv] * 4), snapshot=snap)
    assert codes(fs) == ["op-ceiling-exceeded"] and "convert: 5 > ceiling 4" in fs[0].message
    assert programs.audit_program(art(CLEAN + [conv] * 40, bucket="9x9/float32"),
                                  snapshot=snap) == []
    for n in (0, 10, 100):
        assert programs.contract_ceiling(n) == jprograms.contract_ceiling(n)


def test_layout_copies_are_counted_from_a_real_run():
    _, ops = programs.record_ops(lambda x: x.t().contiguous() + x.clone(), torch.ones(4, 4))
    assert programs.op_counts(ops)["layout_copy"] == 1   # the clone of a contiguous x is not


# ---------------------------------------------------------------------------
# The canonical gate, recorded on the CPU
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def canonical(tmp_path_factory):
    import os

    old = os.environ.get("DAS_CALIBRATION_CACHE")
    os.environ["DAS_CALIBRATION_CACHE"] = str(tmp_path_factory.mktemp("cal") / "c.json")
    try:
        arts = programs.canonical_artifacts(device="cpu")
    finally:
        if old is None:
            os.environ.pop("DAS_CALIBRATION_CACHE", None)
        else:
            os.environ["DAS_CALIBRATION_CACHE"] = old
    return arts


def test_canonical_variants_are_jax_s(canonical):
    assert programs.CANONICAL_SHAPE == jprograms.CANONICAL_SHAPE
    assert programs.CANONICAL_VARIANTS == jprograms.CANONICAL_VARIANTS
    assert programs.FAMILY_CANONICAL_SHAPE == jprograms.FAMILY_CANONICAL_SHAPE
    assert programs.FAMILY_VARIANTS == jprograms.FAMILY_VARIANTS
    engines = [a.engine for a in canonical]
    assert engines[:5] == [f"{m}+{f}" for m, f in programs.CANONICAL_VARIANTS]
    assert [e.split("-")[0] for e in engines[5:]] == list(programs.FAMILY_VARIANTS)


def test_gate_is_green_against_the_checked_in_snapshot(canonical):
    fs = programs.audit_canonical(artifacts=canonical)
    assert fs == [], "\n".join(f.format() for f in fs)


def test_snapshot_round_trips(canonical):
    """--write-contracts is deterministic: the recorded variants give the
    checked-in counts exactly (provenance aside: which torch recorded)."""
    with open(programs.DEFAULT_CONTRACTS, encoding="utf-8") as fh:
        checked_in = json.load(fh)
    snap = programs.build_contracts(canonical, torch_version=checked_in["torch"],
                                    device=checked_in["device"])
    assert snap == checked_in
    assert json.loads(programs.dump_contracts(snap)) == snap


def test_each_kernel_is_one_entry_on_its_route(canonical):
    by = {a.engine: programs.kernel_entries(a.ops) for a in canonical}
    for m, f in programs.CANONICAL_VARIANTS:
        assert by[f"{m}+{f}"] == {"fused_picks": 1}
    assert by["spectro-fused"] == {"fused_stft": 2}     # one a hat kernel
    assert by["learned-fused"] == {"fused_stft": 1}


def test_the_recorder_does_not_descend_into_a_plain_version():
    from das4whales_tpu_torch.ops import fused_picks, fused_stft

    x = torch.randn(4, 256, generator=torch.Generator().manual_seed(0))
    _, ops = programs.record_ops(fused_stft.stft_power, x, 32, 8)
    assert [r.name for r in ops] == ["kernel:fused_stft"]
    sp, ops = programs.record_ops(fused_picks.envelope_peaks_sparse, x, x, 0.5, max_peaks=8)
    assert [r.name for r in ops].count("kernel:fused_picks") == 1
    assert "aten::topk" not in {r.name for r in ops}
    assert sp.positions.shape == (4, 8)


def test_the_audit_runs_no_program(canonical, torch_compile_guard):  # noqa: F811
    with torch_compile_guard.max_compiles(0, what="R11/R13 audit"):
        programs.audit_canonical(artifacts=canonical)


# ---------------------------------------------------------------------------
# Capture costs nothing
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def chaos_bdet(chaos_detector):
    from das4whales_tpu_torch.parallel.batch import BatchedMatchedFilterDetector

    return BatchedMatchedFilterDetector(chaos_detector, donate=False)


@pytest.fixture(scope="module")
def chaos_detector():
    from das4whales_tpu_torch.io.synth import SyntheticScene
    from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector

    return MatchedFilterDetector(SyntheticScene(nx=CHAOS_NX, ns=CHAOS_NS).metadata, CHAOS_SEL,
                                 (CHAOS_NX, CHAOS_NS), pick_mode="sparse",
                                 keep_correlograms=False, device="cpu")


def test_recording_rides_the_probe_and_changes_no_value(chaos_bdet, monkeypatch,
                                                        torch_compile_guard):  # noqa: F811
    """On the card's path (a probe that runs the program; here on the CPU
    with the peak faked) the plain pricing records already (the gate is
    on), so asking for the stream again probes nothing; the recorded run's
    outputs equal an unrecorded run's."""
    runs = []

    def fake_measure(spec):
        runs.append(spec.run(torch.zeros(spec.shape)))
        return memory.MemoryStats(3, 4, 5), 0.25

    spec0 = chaos_bdet.program_spec(1, np.float32)
    card = SimpleNamespace(type="cuda")
    monkeypatch.setattr(memory, "_measure", fake_measure)
    monkeypatch.setattr(type(chaos_bdet), "program_spec",
                        lambda self, *a, **kw: memory.ProgramSpec(
                            **{**spec0.__dict__, "device": card, "key": ("capture-test",)}))
    memory.clear_probe_cache()
    try:
        st, n_plain = torch_compile_guard.count_compiles(
            memory.batched_program_memory, chaos_bdet, 1, np.float32)
        an, n_capture = torch_compile_guard.count_compiles(
            memory.batched_program_analysis, chaos_bdet, 1, np.float32, capture_ops=True)
    finally:
        memory.clear_probe_cache()
    assert (n_plain, n_capture) == (1, 0) and len(runs) == 1
    assert an.memory == st and an.ops and programs.kernel_entries(an.ops) == {"fused_picks": 1}
    plain = spec0.run(torch.zeros(spec0.shape))
    assert all(np.array_equal(a, b) for a, b in zip(plain, runs[0]))


def test_cost_card_verdict_with_the_gate_on_and_off(chaos_file_set, tmp_path):
    """A CPU campaign with cost cards: each card reads "clean" with the
    gate on (one recording run of the priced program) and "unchecked"
    with it off; picks are bitwise equal either way."""
    from das4whales_tpu_torch.workflows import campaign

    got = {}
    for gate in (True, False):
        costs.reset()
        memory.clear_probe_cache()
        (costs.enable_contracts if gate else costs.disable_contracts)()
        try:
            res = campaign.run_campaign_batched(chaos_file_set, CHAOS_SEL,
                                                str(tmp_path / f"gate{gate}"), batch=2,
                                                cost_cards=True, device="cpu")
            got[gate] = (res, [c.as_dict() for c in costs.REGISTRY.cards()])
        finally:
            costs.enable_contracts()
            costs.reset()
            memory.clear_probe_cache()
    assert got[True][0].n_done == len(chaos_file_set) == got[False][0].n_done
    assert got[True][1] and {c["contract"] for c in got[True][1]} == {"clean"}
    assert {c["contract"] for c in got[False][1]} == {"unchecked"}
    assert all(c["contract_findings"] == [] for c in got[True][1])
    assert [c["peak_bytes"] for c in got[True][1]] == [c["peak_bytes"] for c in got[False][1]]
    picks = {g: {r.path: campaign.load_picks(r.picks_file) for r in got[g][0].records}
             for g in got}
    for path, p in picks[True].items():
        q = picks[False][path]
        assert set(p) == set(q) and all(np.array_equal(p[k], q[k]) for k in p)
