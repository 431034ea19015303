"""Port parity, template banks beyond fin: the registry, the bank views and
the bank-split rung of das4whales_tpu_torch against das4whales_tpu
(float32, x64 off; ``pick_mode="sparse"``, ``mf_engine="fft"``,
``fk_engine="fft"`` set explicitly on the JAX side).

Contracts: bank names, entries, scopes and factors equal JAX's; compiled
template stacks within 5e-4 absolute (JAX synthesizes in float32, whose
phase rounding over the blue bank's 5 s chirp reaches 2.5e-4; the port in
float64); detection runs on JAX's own design (``convert``), picks equal
up to rounding knife edges (``utils.parity``), thresholds to rtol 1e-5;
within the port a sub-bank view's picks and thresholds equal the full
bank's rows bit for bit; the ladder's rung list and the bank-split
campaign's manifest equal JAX's record by record.
"""

from __future__ import annotations

import os

import jax
import numpy as np
import pytest

from das4whales_tpu import faults as jfaults
from das4whales_tpu.io.synth import SyntheticCall, SyntheticScene, write_synthetic_file
from das4whales_tpu.models import templates as jtpl
from das4whales_tpu.models.matched_filter import MatchedFilterDetector as JaxDetector
from das4whales_tpu.parallel.batch import BatchedMatchedFilterDetector as JaxBatched
from das4whales_tpu.utils.checkpoint import save_design as jsave_design
from das4whales_tpu.utils import artifacts as jartifacts
from das4whales_tpu.workflows import campaign as jcampaign
from das4whales_tpu.workflows import planner as jplanner
from das4whales_tpu_torch import convert, faults
from das4whales_tpu_torch.io.synth import SyntheticScene as TScene
from das4whales_tpu_torch.io.synth import synthesize_scene
from das4whales_tpu_torch.models import templates as ttpl
from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector
from das4whales_tpu_torch.parallel.batch import BatchedMatchedFilterDetector
from das4whales_tpu_torch.utils.parity import envelopes, unexplained_differences
from das4whales_tpu_torch.workflows import campaign, planner
from tests.torch_threads import one_torch_thread  # noqa: F401

NX, NS = 24, 900
SEL = [0, NX, 1]
SPECS = ("chirp-grid:4", "chirp-grid:3:15-25", "chirp-grid:6:14-30:0.6,0.9", "chirp-grid:5::0.5")
STACK_ATOL = 5e-4


def _banks():
    return list(jtpl.bank_names()) + list(SPECS)


@pytest.mark.parametrize("name", _banks())
def test_registry_and_specs_match_jax(name):
    assert ttpl.bank_names() == jtpl.bank_names()
    bj, bt = jtpl.get_bank(name), ttpl.get_bank(name)
    assert bt.name == bj.name and bt.names == bj.names and len(bt) == len(bj)
    assert bt.threshold_scope == bj.threshold_scope and bt.splittable == bj.splittable
    assert bt.configs == {k: ttpl.CallTemplateConfig(**vars(v)) for k, v in bj.configs.items()}
    np.testing.assert_array_equal(bt.threshold_factors(), bj.threshold_factors())
    assert ttpl.resolve_bank(name) == bt
    with jax.enable_x64(False):
        sj = np.array(bj.compile(NS, 200.0))
    st = bt.compile(NS, 200.0)
    assert st.dtype == sj.dtype == np.float32 and st.shape == sj.shape
    np.testing.assert_allclose(st, sj, rtol=0, atol=STACK_ATOL)
    if len(bt) >= 2:
        for a, b in zip(bt.split(), bj.split()):
            assert (a.name, a.names, a.threshold_scope) == (b.name, b.names, b.threshold_scope)
        assert bt.subset(1, 2).names == bj.subset(1, 2).names


def test_bank_errors_match_jax():
    for fn in (lambda m: m.get_bank("nope"), lambda m: m.chirp_grid(0),
               lambda m: m.FIN_BANK.subset(1, 1), lambda m: m.get_bank("fin").subset(0, 1).split(),
               lambda m: m.resolve_bank(3)):
        errs = []
        for m in (jtpl, ttpl):
            with pytest.raises((KeyError, ValueError, TypeError)) as ei:
                fn(m)
            errs.append((ei.type, str(ei.value)))
        assert errs[0] == errs[1]


@pytest.mark.parametrize("env", ["", "fin-variants", "blue", "chirp-grid:4:14-30:0.6"])
def test_das_template_bank_resolution(monkeypatch, env):
    monkeypatch.setenv("DAS_TEMPLATE_BANK", env)
    bj, bt = jtpl.resolve_bank(None), ttpl.resolve_bank(None)
    assert bt.name == bj.name == (env or "fin") and bt.names == bj.names
    mapping = {"a": ttpl.FIN_LF_NOTE}
    assert ttpl.resolve_bank(mapping).threshold_scope == "global"
    assert ttpl.resolve_bank(ttpl.BLUE_BANK) is ttpl.BLUE_BANK


def _scene_block(seed=0):
    scene = TScene(nx=NX, ns=NS, noise_rms=0.05, seed=seed, calls=[])
    x = synthesize_scene(scene).astype(np.float32)
    c = ttpl.gen_template_fincall(np.arange(NS) / 200.0, 200.0, 17.8, 28.8, 0.68)
    x[NX // 2] += 2.0 * np.roll(c, 220).astype(np.float32)
    x[NX // 3] += 1.5 * np.roll(ttpl.gen_template_fincall(
        np.arange(NS) / 200.0, 200.0, 14.7, 21.8, 0.78), 480).astype(np.float32)
    return scene.metadata, x


@pytest.fixture(scope="module")
def designs():
    """JAX's design of each bank at (NX, NS), carried into the port."""
    meta = SyntheticScene(nx=NX, ns=NS).metadata
    out = {}
    with jax.enable_x64(False):
        for name in ("fin", "fin-variants", "blue", "chirp-grid:4"):
            jd = JaxDetector(meta, SEL, (NX, NS), templates=name, pick_mode="sparse",
                             keep_correlograms=False, mf_engine="fft", fk_engine="fft")
            out[name] = (jd, convert.design_from_arrays(
                {f: getattr(jd.design, f) for f in convert.DESIGN_FIELDS}))
    return out


@pytest.mark.parametrize("name", ["fin-variants", "blue", "chirp-grid:4"])
@pytest.mark.parametrize("tile", [None, 8])
def test_bank_detect_picks_match_jax(designs, name, tile):
    meta, x = _scene_block()
    jd, design = designs[name]
    jd.channel_tile = tile
    with jax.enable_x64(False):
        jr = jd.detect_picks(x)
    td = MatchedFilterDetector.from_design(design, meta, templates=name, channel_tile=tile,
                                           device="cpu")
    assert td.supports_bank_split == jd.supports_bank_split is True
    assert td.template_configs == {k: ttpl.CallTemplateConfig(**vars(v))
                                   for k, v in jd.template_configs.items()}
    tr = td.detect_picks(x)
    env = envelopes(td, x)
    total = 0
    for i, n in enumerate(jr.picks):
        np.testing.assert_allclose(tr.thresholds[n], jr.thresholds[n], rtol=1e-5)
        bad = unexplained_differences(np.asarray(jr.picks[n]), tr.picks[n], env[i],
                                      tr.thresholds[n])
        assert not bad, f"{n}: picks differ beyond rounding at {bad[:10]}"
        total += tr.picks[n].shape[1]
    assert total > 0


@pytest.mark.parametrize("wire", ["conditioned", "raw"])
@pytest.mark.parametrize("tile", [None, 8])
def test_bank_views_are_bitwise_rows_of_the_full_bank(designs, wire, tile):
    meta, x = _scene_block(1)
    if wire == "raw":
        x = np.round(x / meta.scale_factor).astype(np.int32)
    _, design = designs["fin-variants"]
    td = MatchedFilterDetector.from_design(design, meta, templates="fin-variants",
                                           channel_tile=tile, wire=wire, device="cpu")
    full = td.detect_picks(x)
    a, b = td.split_views()
    assert td.split_views()[0] is a and td.bank_view(0, 2) is a
    assert a.bank.name == "fin-variants[0:2]" and b.design.template_names == ("HF-short", "LF-long")
    assert a._templates_true.shape[-1] == td._templates_true.shape[-1]   # the bank's m
    total = 0
    for view in (a, b, td.bank_view(1, 2), td.bank_view(3, 4)):
        res = view.detect_picks(x)
        for n in res.picks:
            np.testing.assert_array_equal(res.picks[n], full.picks[n])
            assert res.thresholds[n] == full.thresholds[n]
            total += res.picks[n].shape[1]
    assert total > 0
    with pytest.raises(ValueError, match="out of range"):
        td.bank_view(2, 5)


def test_split_views_refuse_a_global_bank_with_jax_text(designs):
    meta, _ = _scene_block()
    jd, design = designs["fin"]
    td = MatchedFilterDetector.from_design(design, meta, templates="fin", device="cpu")
    msgs = []
    for det in (jd, td):
        assert det.supports_bank_split is False
        with pytest.raises(ValueError) as ei:
            det.split_views()
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="not splittable"):
        BatchedMatchedFilterDetector(td).split_views()
    with pytest.raises(ValueError, match="are not the design's templates"):
        MatchedFilterDetector.from_design(design, meta, templates="blue", device="cpu")


def test_facade_split_views_give_the_full_bank_rows(designs):
    meta, x = _scene_block(2)
    _, design = designs["chirp-grid:4"]
    td = MatchedFilterDetector.from_design(design, meta, device="cpu")
    assert td.bank is None and td.supports_bank_split
    stack = np.stack([x, _scene_block(3)[1]])
    for serial in (True, False):
        bd = BatchedMatchedFilterDetector(td, serial=serial)
        full = bd.detect_batch(stack)
        ha, hb = bd.split_views()
        assert bd.split_views() == (ha, hb) and not ha.donate and ha.serial == serial
        for half in (ha.detect_batch(stack), hb.detect_batch(stack)):
            for f, (picks, thr) in enumerate(half):
                for n in picks:
                    np.testing.assert_array_equal(picks[n], full[f][0][n])
                    assert thr[n] == full[f][1][n]


def test_saturation_warning_names_the_bank_entry(designs):
    meta, x = _scene_block()
    _, design = designs["fin-variants"]
    td = MatchedFilterDetector.from_design(design, meta, templates="fin-variants",
                                           max_peaks=1, device="cpu")
    with pytest.warns(UserWarning, match="template fin-variants/HF"):
        td.detect_picks(x)
    plain = MatchedFilterDetector.from_design(design, meta, max_peaks=1, device="cpu")
    with pytest.warns(UserWarning, match="template HF-short"):
        plain.detect_picks(x)


def test_threshold_policy_matches_jax(designs):
    for name in ("fin", "fin-variants"):
        jd, design = designs[name]
        for kw in ({}, {"hf_factor": 0.8}, {"threshold_factors": np.arange(len(
                design.template_names), dtype=np.float32) + 1}, {"threshold_scope": "global"},
                {"hf_factor": 0.8, "threshold_scope": "per_template"}):
            fj, sj = jd.design.resolve_threshold_policy(**kw)
            ft, st = design.resolve_threshold_policy(**kw)
            np.testing.assert_array_equal(ft, np.asarray(fj))
            assert ft.dtype == np.float32 and st == sj
        for bad in ({"threshold_factors": [1.0]}, {"threshold_scope": "per_file"}):
            with pytest.raises(ValueError):
                design.resolve_threshold_policy(**bad)


def test_rung_lists_match_jax():
    for batch in (1, 2, 4):
        for bank in (False, True):
            lj = jplanner.DownshiftLadder(None, "", batch=batch, family="mf",
                                          stages=jfaults.DOWNSHIFT_STAGES)
            lt = planner.DownshiftLadder(None, "", batch=batch, family="mf",
                                         stages=faults.DOWNSHIFT_STAGES)
            if bank:
                lj.enable_bank_split("k")
                lt.enable_bank_split("k")
            assert lt.bank_split_enabled("k") == lj.bank_split_enabled("k") == bank
            assert not lt.bank_split_enabled("other")
            assert lt.rungs("k") == lj.rungs(None, "k")
            assert [faults.rung_label(r) for r in lt.rungs("k")] == \
                [jfaults.rung_label(r) for r in lj.rungs(None, "k")]


def test_planner_bank_rung_and_drill(designs, tmp_path):
    """The per-file planner: the bank rung's merged picks equal the full
    bank's; a resource failure at the file rung lands on ``bank``,
    sticky, and recovers (JAX's ``test_planner_bank_rung_and_drill``)."""
    meta, x = _scene_block()
    jd, design = designs["chirp-grid:4"]
    det = MatchedFilterDetector.from_design(design, meta, device="cpu")
    prog = planner.MatchedFilterProgram(det)
    assert prog.stages == jplanner.MatchedFilterProgram(jd).stages
    fin = MatchedFilterDetector.from_design(designs["fin"][1], meta, device="cpu")
    assert "bank" not in planner.MatchedFilterProgram(fin).stages
    ref = det.detect_picks(x)
    picks, thr, _ = prog.detect(("bank", 1), x)
    for n in ref.picks:
        np.testing.assert_array_equal(picks[n], ref.picks[n])
        assert thr[n] == ref.thresholds[n]

    class OOMAtFile(planner.MatchedFilterProgram):
        def detect(self, rung, trace, **kw):
            if rung[0] == "file":
                raise faults.InjectedResourceExhausted("injected: full-bank program exhausts")
            return super().detect(rung, trace, **kw)

    outdir = str(tmp_path / "drill")
    os.makedirs(outdir)
    rz = campaign._Resilience(outdir, [], None, retry=False, health=False)
    route = planner.RoutePlanner(rz, outdir, OOMAtFile(det))
    picks, thr, _, rung = route.run_file("f0", x)
    assert rung == ("bank", 1) and route.ladder.current("campaign") == ("bank", 1)
    for n in ref.picks:
        np.testing.assert_array_equal(picks[n], ref.picks[n])
    assert rz.tallies["downshifts"] == 1 and rz.tallies["oom_recoveries"] == 1


BANK4 = "chirp-grid:4:14-30:0.6"


def _write_bank_files(d, n):
    paths = []
    for k in range(n):
        scene = SyntheticScene(nx=NX, ns=NS, noise_rms=0.05, seed=k, calls=[
            SyntheticCall(t0=1.2 + 0.3 * k, x0_m=NX / 2 * 2.042, amplitude=2.0)])
        paths.append(write_synthetic_file(str(d / f"f{k}.h5"), scene))
    return paths


def _norm(rec):
    out = {k: v for k, v in rec.items() if k not in ("wall_s", "span_id", "health", "n_picks")}
    for k in ("path", "picks_file"):
        if out.get(k):
            out[k] = os.path.basename(out[k])
    if "engines" in out:
        out["engines"] = {k: v for k, v in out["engines"].items() if k != "pick_engine"}
    return out


def test_batched_campaign_bank_split_rung_matches_jax(tmp_path, monkeypatch):
    """A batched campaign whose full-bank slab program always exhausts
    resources downshifts ``batched:2 -> bank:2`` and completes every file
    there with the healthy run's picks bit for bit — in both packages,
    manifests equal record by record (JAX's
    ``test_batched_campaign_bank_split_rung``)."""
    paths = _write_bank_files(tmp_path, 4)
    meta = SyntheticScene(nx=NX, ns=NS).metadata
    kw = dict(batch=2, bucket="exact", dispatch_depth=1, templates=BANK4, health=False)
    with jax.enable_x64(False):
        jd = JaxDetector(meta, SEL, (NX, NS), templates=BANK4, pick_mode="sparse",
                         keep_correlograms=False, mf_engine="fft", fk_engine="fft")
        dpath = jsave_design(str(tmp_path / "design.npz"), jd.design)
    runs = {}

    def jax_run(out):
        with jax.enable_x64(False):
            return jcampaign.run_campaign_batched(paths, SEL, str(tmp_path / out),
                                                  persistent_cache=False, mf_engine="fft",
                                                  fk_engine="fft", resume=False, **kw)

    def port_run(out):
        return campaign.run_campaign_batched(paths, SEL, str(tmp_path / out), device="cpu",
                                             design=dpath, resume=False, **kw)

    runs["jax", "healthy"], runs["port", "healthy"] = jax_run("jh"), port_run("th")
    real_j, real_t = JaxBatched.detect_batch, BatchedMatchedFilterDetector.detect_batch

    def oom_j(self, *a, **k):
        if self.det.design.templates.shape[0] == 4:
            raise jfaults.InjectedResourceExhausted("injected: full-bank slab program exhausts HBM")
        return real_j(self, *a, **k)

    def oom_t(self, *a, **k):
        if self.det.design.templates.shape[0] == 4:
            raise faults.InjectedResourceExhausted("injected: full-bank slab program exhausts HBM")
        return real_t(self, *a, **k)

    monkeypatch.setattr(JaxBatched, "detect_batch", oom_j)
    monkeypatch.setattr(BatchedMatchedFilterDetector, "detect_batch", oom_t)
    runs["jax", "split"], runs["port", "split"] = jax_run("js"), port_run("ts")
    for pkg in ("jax", "port"):
        h, s = runs[pkg, "healthy"], runs[pkg, "split"]
        assert s.n_done == 4 and s.n_failed == 0
        assert {r.rung for r in s.records} == {"bank:2"}
        for a, b in zip(h.records, s.records):
            pa = (jcampaign if pkg == "jax" else campaign).load_picks(a.picks_file)
            pb = (jcampaign if pkg == "jax" else campaign).load_picks(b.picks_file)
            assert set(pa) == set(pb) and sum(v.shape[1] for v in pb.values()) > 0
            for n in pa:
                np.testing.assert_array_equal(pa[n], pb[n])
    ledger = campaign.summarize_campaign(str(tmp_path / "ts"))["downshift_ledger"]
    assert [(e["from"], e["to"]) for e in ledger] == [("batched:2", "bank:2")]
    for j, t in (("jh", "th"), ("js", "ts")):
        mj = jartifacts.read_records(os.path.join(str(tmp_path / j), "manifest.jsonl"))
        mt = jartifacts.read_records(os.path.join(str(tmp_path / t), "manifest.jsonl"))
        assert [_norm(r) for r in mj] == [_norm(r) for r in mt]
