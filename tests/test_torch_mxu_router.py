"""The engine routers, the calibration table and the precision gates of
das4whales_tpu_torch (``ops/mxu.py``), and the engines through the
batched facade and the rung views, on the CPU. The routers run on a
prefilled table with the backend pinned to a card's key, as JAX's tests
pin ``"tpu"`` (no measurement runs: the table is the cache); the gates'
outcomes are pinned by ``record=`` as in JAX's precision tests.
"""

from __future__ import annotations

import json
import os
import threading

import jax
import numpy as np
import pytest
import torch

from _mxu_helpers import fin_template_pair
from das4whales_tpu.io.synth import SyntheticCall, SyntheticScene, synthesize_scene, to_raw_counts
from das4whales_tpu.models.matched_filter import MatchedFilterDetector as JaxDetector
from das4whales_tpu.ops import mxu as jmxu
from das4whales_tpu_torch import config, convert
from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector as TorchDetector
from das4whales_tpu_torch.ops import filters as tfilters
from das4whales_tpu_torch.ops import mxu
from das4whales_tpu_torch.ops import xcorr as txcorr
from das4whales_tpu_torch.parallel.batch import BatchedMatchedFilterDetector
from das4whales_tpu_torch.telemetry import costs
from tests.torch_threads import one_torch_thread  # noqa: F401

CARD = "cuda:NVIDIA H100 80GB HBM3"
FS, NS = 200.0, 6000


@pytest.fixture(autouse=True)
def _table_path(tmp_path, monkeypatch):
    monkeypatch.setenv("DAS_CALIBRATION_CACHE", str(tmp_path / "default.json"))


@pytest.fixture
def table(tmp_path):
    return mxu.CalibrationTable(str(tmp_path / "cal.json"))


def _triple(n=NS):
    return txcorr.padded_template_stats(np.pad(fin_template_pair(), ((0, 0), (0, n - 137))))


def _fused_design(n=NS):
    fir, _ = tfilters.butter_zero_phase_fir(FS, (14.0, 30.0))
    return fir, tfilters.butter_zero_phase_gain(n, FS, (14.0, 30.0)).astype(np.float32)


# ---------------------------------------------------------------- the table

def test_config_defaults_and_paths(monkeypatch):
    for var in ("DAS_MF_ENGINE", "DAS_FK_ENGINE", "DAS_FK_MATMUL_MAX_CHANNELS",
                "DAS_CALIBRATION_CACHE"):
        monkeypatch.delenv(var, raising=False)
    assert config.mf_engine_default() == "fft" and config.fk_engine_default() == "fft"
    assert config.fk_matmul_max_channels() == config.DEFAULT_FK_MATMUL_MAX_CHANNELS == 4096
    assert config.calibration_cache_path().endswith(
        "/.cache/das4whales_tpu_torch/mxu_calibration.json")
    monkeypatch.setenv("DAS_MF_ENGINE", "auto")
    monkeypatch.setenv("DAS_FK_MATMUL_MAX_CHANNELS", "junk")
    assert config.mf_engine_default() == "auto"
    assert config.fk_matmul_max_channels() == 4096
    assert mxu.requested_stft_engine(None) == "fused"
    assert mxu.requested_gabor_engine(None) == "fft"


def test_calibration_table_roundtrip_and_corruption(table):
    assert table.get("k") is None
    table.put("k", {"winner": "matmul", "fft_s": 1.0})
    assert mxu.CalibrationTable(table.path).get("k")["winner"] == "matmul"
    with open(table.path, "w") as fh:
        fh.write("{not json")
    t3 = mxu.CalibrationTable(table.path)
    assert t3.get("k") is None            # a corrupt file reads as empty
    t3.put("k2", {"winner": "fft"})       # and stays writable
    assert mxu.CalibrationTable(table.path).get("k2")["winner"] == "fft"


def test_calibration_table_merges_across_instances(table):
    other = mxu.CalibrationTable(table.path)
    assert other.get("a") is None          # loaded before either write
    table.put("a", {"winner": "fft"})
    other.put("b", {"winner": "matmul"})   # keeps a, which it never loaded
    table.put("c", {"winner": "conv"})
    with open(table.path) as fh:
        assert sorted(json.load(fh)) == ["a", "b", "c"]


@pytest.mark.parametrize("shared", [True, False], ids=["one-instance", "two-instances"])
def test_calibration_table_puts_from_two_threads(table, shared):
    """Two threads writing one table file (the service's tenants share
    the default table) keep every key, leave a file that parses and no
    temporary file behind."""
    tabs = (table, table if shared else mxu.CalibrationTable(table.path))

    def fill(tab, tag):
        for i in range(40):
            tab.put(f"{tag}{i}", {"winner": tag})

    threads = [threading.Thread(target=fill, args=(t, tag)) for t, tag in zip(tabs, "ab")]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    want = sorted(f"{tag}{i}" for tag in "ab" for i in range(40))
    with open(table.path) as fh:
        assert sorted(json.load(fh)) == want
    fresh = mxu.CalibrationTable(table.path)
    assert all(fresh.get(k) is not None for k in want)
    for tab, tag in zip(tabs, "ab"):
        assert all(tab.get(f"{tag}{i}") == {"winner": tag} for i in range(40))
    d, base = os.path.split(table.path)
    assert [f for f in os.listdir(d) if f.startswith(base)] == [base]


def test_default_table_follows_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("DAS_CALIBRATION_CACHE", str(tmp_path / "x.json"))
    a = mxu.default_table()
    assert a is mxu.default_table() and a.path == str(tmp_path / "x.json")
    monkeypatch.setenv("DAS_CALIBRATION_CACHE", str(tmp_path / "y.json"))
    assert mxu.default_table() is not a


def test_backend_keys():
    assert mxu.backend_key("cpu") == "cpu"
    assert mxu.backend_key(torch.device("cpu")) == "cpu"


def test_calibrate_correlate_measures_once(table):
    e1 = mxu.calibrate_correlate(32, 400, 21, 2, table=table, device="cpu", repeats=1)
    assert e1["winner"] in ("fft", "matmul") and e1["cal_channels"] == 32
    assert e1["fft_s"] > 0 and e1["matmul_s"] > 0 and "matmul_bf16_s" not in e1
    assert mxu.calibrate_correlate(32, 400, 21, 2, table=table, device="cpu") == e1
    fresh = mxu.CalibrationTable(table.path)
    assert mxu.calibrate_correlate(32, 400, 21, 2, table=fresh, device="cpu") == e1
    assert table.get("correlate|cpu|C32xN400|m21T2") == e1


@pytest.mark.parametrize("which", ["fk", "stft", "gabor", "fused"])
def test_other_calibrations_measure_and_key(table, which):
    if which == "fk":
        e = mxu.calibrate_fk(24, 512, 10, 60, table=table, device="cpu", repeats=1)
        key, cands = "fk|cpu|C24xN512|band50", ("fft", "matmul")
    elif which == "stft":
        e = mxu.calibrate_stft(8, 1200, 64, 8, table=table, device="cpu", repeats=1)
        key, cands = "stft|cpu|C8xN1200|nfft64h8", ("rfft", "matmul")   # no kernel on the CPU
    elif which == "gabor":
        e = mxu.calibrate_gabor(40, 60, 5, 7, table=table, device="cpu", repeats=1)
        key, cands = "gabor|cpu|H40xW60|k5x7", ("fft", "conv")
    else:
        e = mxu.calibrate_correlate_fused(16, 600, 21, 2, 9, table=table, device="cpu",
                                          repeats=1)
        key, cands = "correlate-fused|cpu|C16xN600|m21T2|L9", ("staged", "fused")
    assert all(e[f"{c}_s"] > 0 for c in cands)
    assert table.get(key) == e


# ---------------------------------------------------------------- the routers

def test_auto_router_consults_the_table_on_a_card_key(table):
    tt = np.zeros((2, 37), np.float32)
    mu = np.zeros((2,), np.float32)
    sc = np.ones((2,), np.float32)
    key = f"correlate|{CARD}|C64xN900|m37T2"

    def route():
        return mxu.resolve_mf_engine("auto", (64, 900), tt, mu, sc, table=table, backend=CARD)

    table.put(key, {"winner": "fft", "fft_s": 1.0, "matmul_s": 2.0})
    eng, why = route()
    assert eng == "fft" and "A/B fft" in why
    table.put(key, {"winner": "matmul", "fft_s": 2.0, "matmul_s": 1.0})
    eng, why = route()
    assert eng == "matmul" and "A/B matmul" in why


@pytest.mark.parametrize("bf16_s", [0.5, 0.99], ids=["well-below", "within-noise"])
@pytest.mark.parametrize("winner", ["fft", "matmul"])
def test_auto_router_never_takes_bf16_on_a_card(table, bf16_s, winner):
    """The port's bf16 route is the float32 contraction plus two rounding
    passes, so it cannot beat the float32 matmul: ``auto`` never takes it,
    whatever wall a table (an older one, or timer noise) gives it and
    whatever its gate said. It runs only when forced."""
    tt = np.zeros((2, 37), np.float32)
    mu = np.zeros((2,), np.float32)
    sc = np.ones((2,), np.float32)
    walls = {"fft_s": 1.0, "matmul_s": 2.0} if winner == "fft" else {"fft_s": 2.0, "matmul_s": 1.0}
    table.put(f"correlate|{CARD}|C64xN900|m37T2",
              {"winner": winner, **walls, "matmul_bf16_s": bf16_s * min(walls.values())})
    table.put(mxu.gate_key(CARD, (64, 900), tt, mu, sc),
              {"eligible": True, "reason": "prefilled: bit-identical"})
    eng, why = mxu.resolve_mf_engine("auto", (64, 900), tt, mu, sc, table=table, backend=CARD)
    assert eng == winner and "bf16" not in why
    eng, why = mxu.resolve_mf_engine("matmul-bf16", (64, 900), tt, mu, sc, table=table,
                                     backend=CARD)
    assert eng == "matmul-bf16" and "gate passed" in why


def test_auto_router_takes_the_fold_on_its_gate_and_its_ab(table):
    tt, mu, sc = _triple(900)
    fir, gain = _fused_design(900)
    L = (fir.shape[0] - 1) // 2
    m = tt.shape[1]
    table.put(f"correlate|{CARD}|C64xN900|m{m}T2",
              {"winner": "matmul", "fft_s": 2.0, "matmul_s": 1.0})
    fkey = f"correlate-fused|{CARD}|C64xN900|m{m}T2|L{L}"
    gkey = mxu.fused_gate_key(CARD, (64, 900), tt, mu, sc, fir)
    table.put(fkey, {"winner": "matmul-fused", "staged_s": 2.0, "fused_s": 1.0})
    table.put(gkey, {"eligible": True, "reason": "prefilled"})

    def route():
        return mxu.resolve_mf_engine("auto", (64, 900), tt, mu, sc, table=table, backend=CARD,
                                     fused_design=(fir, gain))

    eng, why = route()
    assert eng == "matmul-fused" and "A/B fused" in why
    table.put(gkey, {"eligible": False, "reason": "prefilled"})
    assert route()[0] == "matmul"
    table.put(gkey, {"eligible": True, "reason": "prefilled"})
    table.put(fkey, {"winner": "staged", "staged_s": 1.0, "fused_s": 2.0})
    assert route()[0] == "matmul"


def test_fk_router_cap_and_ab(table, monkeypatch):
    monkeypatch.setenv("DAS_FK_MATMUL_MAX_CHANNELS", "100")
    eng, why = mxu.resolve_fk_engine("auto", 101, 900, 64, table=table, backend=CARD)
    assert eng == "fft" and "above DAS_FK_MATMUL_MAX_CHANNELS" in why
    table.put(f"fk|{CARD}|C64xN900|band32", {"winner": "matmul", "fft_s": 2.0, "matmul_s": 1.0})
    eng, why = mxu.resolve_fk_engine("auto", 64, 900, 32, table=table, backend=CARD)
    assert eng == "matmul" and "A/B matmul" in why
    table.put(f"fk|{CARD}|C64xN900|band32", {"winner": "fft", "fft_s": 1.0, "matmul_s": 2.0})
    assert mxu.resolve_fk_engine("auto", 64, 900, 32, table=table, backend=CARD)[0] == "fft"


def test_stft_and_gabor_routers_on_a_card_key(table):
    table.put(f"stft|{CARD}|C4096xN12000|nfft160h8",
              {"winner": "fused", "rfft_s": 3.0, "matmul_s": 2.0, "fused_s": 1.0})
    eng, why = mxu.resolve_stft_engine_ab("auto", 4096, 12000, 160, 8, table=table,
                                          backend=CARD)
    assert eng == "fused" and why.startswith("auto: A/B fused wins") and "matmul 2s" in why
    table.put(f"gabor|{CARD}|H2205xW1200|k101x101", {"winner": "conv", "fft_s": 2.0,
                                                     "conv_s": 1.0})
    eng, why = mxu.resolve_gabor_engine("auto", (2205, 1200), (101, 101), table=table,
                                        backend=CARD)
    assert eng == "conv" and "A/B conv" in why


@pytest.mark.parametrize("which", ["mf", "fk", "stft", "gabor"])
def test_auto_off_the_card_is_the_fft_route_with_jax_wording(table, which):
    tt, mu, sc = _triple(900)
    with jax.enable_x64(False):
        if which == "mf":
            got = mxu.resolve_mf_engine("auto", (24, 900), tt, mu, sc, table=table, device="cpu")
            ref = jmxu.resolve_mf_engine("auto", (24, 900), tt, mu, sc, backend="cpu")
        elif which == "fk":
            got = mxu.resolve_fk_engine("auto", 24, 900, 40, table=table, device="cpu")
            ref = jmxu.resolve_fk_engine("auto", 24, 900, 40, backend="cpu")
        elif which == "stft":
            got = mxu.resolve_stft_engine_ab("auto", 24, 900, 160, 8, table=table, device="cpu")
            ref = jmxu.resolve_stft_engine_ab("auto", 24, 900, 160, 8, backend="cpu")
        else:
            got = mxu.resolve_gabor_engine("auto", (24, 90), (11, 11), table=table, device="cpu")
            ref = jmxu.resolve_gabor_engine("auto", (24, 90), (11, 11), backend="cpu")
    assert got == tuple(ref)
    assert mxu.CalibrationTable(table.path).get(
        f"correlate|cpu|C24xN900|m{tt.shape[1]}T2") is None     # nothing measured


def test_forced_engines_pass_through_and_invalid_values_raise():
    tt, mu, sc = _triple(900)
    for eng in ("fft", "matmul"):
        assert mxu.resolve_mf_engine(eng, (8, 900), tt, mu, sc) == (eng, "forced")
        assert mxu.resolve_fk_engine(eng, 8, 900, 10) == (eng, "forced")
    for eng in ("rfft", "matmul", "fused"):
        assert mxu.resolve_stft_engine_ab(eng, 8, 900, 64, 8) == (eng, "forced")
    assert mxu.resolve_gabor_engine("conv", (8, 8), (3, 3)) == ("conv", "forced")
    z = np.zeros((2,), np.float32)
    with pytest.raises(ValueError, match="mf_engine"):
        mxu.resolve_mf_engine("nope", (8, 100), np.zeros((2, 5), np.float32), z, z)
    with pytest.raises(ValueError, match="fk_engine"):
        mxu.resolve_fk_engine("nope", 8, 100, 10)
    with pytest.raises(ValueError, match="unknown stft engine"):
        mxu.resolve_stft_engine_ab("nope", 8, 100, 64, 8)
    with pytest.raises(ValueError, match="unknown gabor engine"):
        mxu.resolve_gabor_engine("nope", (8, 8), (3, 3))
    with pytest.raises(ValueError, match="mf_engine"):
        mxu.correlograms_body(torch.zeros((2, 8)), torch.zeros((1, 2)), torch.zeros((1,)),
                              torch.ones((1,)), "nope")
    with pytest.raises(ValueError, match="matmul-fused engine needs"):
        mxu.correlograms_body(torch.zeros((2, 8)), torch.zeros((1, 2)), torch.zeros((1,)),
                              torch.ones((1,)), "matmul-fused")
    with pytest.raises(ValueError, match="fk_engine"):
        mxu.fk_apply_body(torch.zeros((4, 8)), torch.ones((4, 2)), 0, 2, "nope", None)


def test_fused_unavailable_without_design(table):
    tt, mu, sc = _triple(900)
    eng, why = mxu.resolve_mf_engine("matmul-fused", (8, 900), tt, mu, sc, table=table,
                                     device="cpu")
    assert eng == "matmul" and "unavailable without the bandpass FIR" in why


# ---------------------------------------------------------------- the gates

def _record(kind):
    rng = np.random.default_rng(5)
    if kind == "noisy-marginal":
        return rng.normal(0.0, 1.0, size=(32, NS)).astype(np.float32)
    rec = rng.normal(0.0, 0.01, size=(32, NS)).astype(np.float32)
    rec[5, 800 : 800 + 137] += 2.0 * fin_template_pair()[0]
    rec[20, 3000 : 3000 + 137] += 2.0 * fin_template_pair()[1]
    return rec


@pytest.mark.parametrize("gate", ["bf16", "fused"])
@pytest.mark.parametrize("kind,eligible", [("noisy-marginal", False), ("clean-strong", True)])
def test_gate_outcomes_pinned_by_record(table, gate, kind, eligible):
    """A noisy record with near-threshold picks rejects the engine, a clean
    strong scene passes; the reason names the record, a cached verdict
    routes bit for bit, and a rejection resolves to the float32 matmul."""
    tt, mu, sc = _triple()
    tt_true = fin_template_pair()
    fir, gain = _fused_design()
    rec = _record(kind)
    if gate == "bf16":
        ok, why = mxu.bf16_correlate_gate((32, NS), tt, mu, sc, table=table, device="cpu",
                                          record=rec)
        key = mxu.gate_key("cpu", (32, NS), tt, mu, sc)
        req, fallback, differ = "matmul-bf16", "bf16 ineligible", "differ from the f32 FFT route"
    else:
        ok, why = mxu.fused_correlate_gate((32, NS), tt_true, mu, sc, fir, gain, table=table,
                                           device="cpu", record=rec)
        key = mxu.fused_gate_key("cpu", (32, NS), tt_true, mu, sc, fir)
        req, fallback = "matmul-fused", "fused-taps ineligible"
        differ = "differ from the staged f32 route"
    assert ok == eligible, why
    assert "calibration record" in why and (ok or differ in why)
    assert table.get(key) is None          # an explicit record bypasses the table
    table.put(key, {"eligible": ok, "reason": why})
    eng, reason = mxu.resolve_mf_engine(req, (32, NS), tt_true if gate == "fused" else tt,
                                        mu, sc, table=table, backend="cpu",
                                        fused_design=(fir, gain))
    assert eng == (req if ok else "matmul")
    assert ok or fallback in reason


def test_gates_on_the_fixed_record_are_kept_in_the_table(table):
    tt, mu, sc = _triple(900)
    ok, why = mxu.bf16_correlate_gate((24, 900), tt, mu, sc, table=table, device="cpu")
    hit = table.get(mxu.gate_key("cpu", (24, 900), tt, mu, sc))
    assert hit == {"eligible": ok, "reason": why} and "[24x900]" in why
    # the verdict is read back, not measured again
    table.put(mxu.gate_key("cpu", (24, 900), tt, mu, sc), {"eligible": not ok, "reason": "r"})
    assert mxu.bf16_correlate_gate((24, 900), tt, mu, sc, table=table, device="cpu") \
        == (not ok, "r")


def test_gate_keys_are_content_keyed():
    tt, mu, sc = _triple(900)
    fir, _ = _fused_design(900)
    a = mxu.gate_key(CARD, (64, 900), tt, mu, sc)
    assert a.startswith(f"bf16gate|{CARD}|C64xN900|m{tt.shape[1]}T2|t")
    assert a != mxu.gate_key(CARD, (64, 900), tt[::-1], mu, sc)       # same shape, other bank
    assert a != mxu.gate_key("cpu", (64, 900), tt, mu, sc)
    b = mxu.fused_gate_key(CARD, (64, 900), tt, mu, sc, fir)
    assert f"|L{(fir.shape[0] - 1) // 2}|" in b
    assert b != mxu.fused_gate_key(CARD, (64, 900), tt, mu, sc, fir * 0.5)
    with jax.enable_x64(False):
        assert a.replace(CARD, "tpu") == jmxu.gate_key("tpu", (64, 900), tt, mu, sc)
        assert b.replace(CARD, "tpu") == jmxu.fused_gate_key("tpu", (64, 900), tt, mu, sc, fir)
    np.testing.assert_array_equal(mxu.calibration_record((16, 900), tt),
                                  jmxu.calibration_record((16, 900), tt))


# ---------------------------------------------------------------- facade and views

def _scene(nx, ns, seed):
    scene = SyntheticScene(nx=nx, ns=ns, noise_rms=0.05, seed=seed, calls=[
        SyntheticCall(t0=1.0 + 0.2 * (seed % 3), x0_m=nx / 2 * 2.042, amplitude=2.0),
        SyntheticCall(t0=3.0, x0_m=nx / 4 * 2.042, amplitude=1.5)])
    raw = to_raw_counts(synthesize_scene(scene), scene.metadata)
    cond = ((raw - raw.mean(axis=1, keepdims=True)) * scene.metadata.scale_factor)
    return scene, {"raw": raw, "conditioned": cond.astype(np.float32)}


@pytest.fixture(scope="module")
def design24():
    scene, _ = _scene(24, 900, 0)
    with jax.enable_x64(False):
        jd = JaxDetector(scene.metadata, [0, 24, 1], (24, 900), templates="fin-variants",
                         mf_engine="fft", fk_engine="fft")
    design = convert.design_from_arrays({f: getattr(jd.design, f) for f in convert.DESIGN_FIELDS})
    return scene.metadata, design


@pytest.mark.parametrize("wire", ["raw", "conditioned"])
@pytest.mark.parametrize("B", [1, 2, 4])
def test_batched_facade_is_bitwise_the_serial_route(design24, wire, B):
    meta, design = design24
    blocks = [_scene(24, 900, 10 + k)[1][wire] for k in range(B)]
    det = TorchDetector.from_design(design, meta, wire=wire, pick_mode="sparse",
                                    mf_engine="matmul", fk_engine="matmul", device="cpu")
    stack = np.stack(blocks)
    per_file = [det.detect_picks(b) for b in blocks]
    total = 0
    for serial in (True, False):
        out = BatchedMatchedFilterDetector(det, serial=serial).detect_batch(stack)
        assert len(out) == B
        for ref, (picks, thr) in zip(per_file, out):
            assert thr == ref.thresholds
            for name in ref.picks:
                np.testing.assert_array_equal(picks[name], ref.picks[name])
                total += picks[name].shape[1]
    assert total > 0
    spec = BatchedMatchedFilterDetector(det, serial=True).program_spec(B, np.float32)
    assert spec.key[-2:] == ("matmul", "matmul")
    fft = TorchDetector.from_design(design, meta, wire=wire, device="cpu")
    assert BatchedMatchedFilterDetector(fft, serial=True).program_spec(B, np.float32).key \
        != spec.key


def test_cost_rows_count_each_engine():
    T, m, nT, rows = 12000, 150, 2, 22050
    mm = costs.correlate_stage("matmul", rows, nT, T, m, 12149)
    assert mm[0] == "correlate" and mm[1] >= 2.0 * rows * T * m * nT
    assert costs.correlate_stage("matmul-bf16", rows, nT, T, m, 12149)[1] == mm[1]
    assert costs.correlate_stage("matmul-fused", rows, nT, T, m, 12149, 198)[1] > mm[1]
    assert costs.correlate_stage("fft", rows, nT, T, m, 12150)[1] < mm[1]
    C, Fb = 4096, 961
    fm = costs.fk_stage("matmul", 1, C, T, C, Fb)
    ff = costs.fk_stage("fft", 1, C, T, C, Fb)
    assert fm[1] - ff[1] >= 8 * 2.0 * C * C * Fb - 2 * Fb * 2 * costs.rfft_ops(C) - 6.0 * C * Fb
    assert fm[2] - ff[2] == 2 * C * C * 4


def test_bank_view_regates_a_sub_bank(design24, tmp_path, monkeypatch):
    """A gated parent's sub-bank earns its own content-keyed verdict: with
    the sub-bank's gate prefilled as ineligible, the view falls back to
    the float32 matmul while the parent keeps bf16; a float32 parent's
    views inherit its engine, and their picks are the full bank's rows."""
    meta, design = design24
    path = str(tmp_path / "views.json")
    monkeypatch.setenv("DAS_CALIBRATION_CACHE", path)
    det = TorchDetector.from_design(design, meta, templates="fin-variants", wire="raw",
                                    pick_mode="sparse", mf_engine="matmul-bf16", device="cpu")
    if det.mf_engine != "matmul-bf16":
        pytest.skip(f"the bank's gate failed on its record: {det.mf_engine_reason}")
    sub = [a[0:2] for a in (det._templates_true.numpy(), det._template_mu.numpy(),
                            det._template_scale.numpy())]
    mxu.default_table().put(mxu.gate_key("cpu", design.trace_shape, *sub),
                            {"eligible": False, "reason": "prefilled for the sub-bank"})
    a, b = det.split_views()
    assert a.mf_engine == "matmul" and "prefilled for the sub-bank" in a.mf_engine_reason
    assert det.mf_engine == "matmul-bf16"
    assert b.mf_engine == "matmul-bf16" and b.mf_engine_reason != det.mf_engine_reason
    f32 = TorchDetector.from_design(design, meta, templates="fin-variants", wire="raw",
                                    pick_mode="sparse", mf_engine="matmul", device="cpu")
    x = _scene(24, 900, 0)[1]["raw"]
    full = f32.detect_picks(x)
    for view in f32.split_views():
        assert view.mf_engine == "matmul" and view.mf_engine_reason == "forced"
        res = view.detect_picks(x)
        for name in res.picks:
            np.testing.assert_array_equal(res.picks[name], full.picks[name])
            assert res.thresholds[name] == full.thresholds[name]


def test_bank_view_of_a_fused_parent_folds_its_own_slice(design24):
    meta, design = design24
    det = TorchDetector.from_design(design, meta, templates="fin-variants", wire="raw",
                                    mf_engine="matmul-fused", device="cpu")
    if det.mf_engine != "matmul-fused":
        pytest.skip(f"the bank's gate failed on its record: {det.mf_engine_reason}")
    a, _ = det.split_views()
    if a.mf_engine == "matmul-fused":
        assert a._mf_fused[0].shape[0] == 3 and a._mask_band_fused is not None
        np.testing.assert_array_equal(
            a._mf_fused[0].numpy(),
            mxu.fused_template_taps(det._templates_true[0:2].numpy(), det._bp_fir)[0])
    else:
        assert a.mf_engine == "matmul" and a._mf_fused is None


def test_host_view_resolves_the_requested_engines_again(design24, monkeypatch, table):
    """A parent whose "auto" resolved on a card (its backend key pinned to
    the card's, the table prefilled) keeps that route; its host view
    resolves "auto" again for the CPU, and forced engines stay forced."""
    meta, design = design24
    tt, mu, sc = txcorr.padded_template_stats(design.templates)
    on_card = {"v": True}
    monkeypatch.setattr(mxu, "backend_key", lambda dev: CARD if on_card["v"] else "cpu")
    mxu.default_table().put(
        f"correlate|{CARD}|C24xN900|m{tt.shape[1]}T{tt.shape[0]}",
        {"winner": "matmul", "fft_s": 2.0, "matmul_s": 1.0})
    det = TorchDetector.from_design(design, meta, mf_engine="auto", fk_engine="matmul",
                                    device="cpu")
    assert det.mf_engine == "matmul" and "A/B matmul" in det.mf_engine_reason
    on_card["v"] = False
    host = det.host_view()
    assert host.device.type == "cpu" and host is det.host_view()
    assert host.mf_engine == "fft" and "no MXU" in host.mf_engine_reason
    assert host.fk_engine == "matmul" and host._fk_dft is not None
    assert det.mf_engine == "matmul"
