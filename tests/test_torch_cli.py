"""Port parity, the command line: ``python -m das4whales_tpu_torch`` — the
verbs ``list``, ``fsck``, ``evaluate``, ``campaign``, ``longrecord`` and
the refusals of ``fleet`` and the mesh flags — through ``main(argv)``
in-process with ``--device cpu``, against das4whales_tpu's ``main(argv)``
(float32, x64 off) on the same files. The six workflow verbs are in
``tests/test_torch_cli_workflows.py``.

Contract: the verbs' own stdout lines equal (output paths aside);
``summary.json`` equal but for wall times and paths; ``picks.npz`` and
the campaigns' picks artifacts equal or differing only on rounding knife
edges (``utils.parity``, on the port's envelopes); every error path's
exit code equal (``--family learned`` without ``--model`` 2, no
probeable file 3, ``--bank`` with a non-mf family 2, an aborted campaign
4); ``evaluate``'s sweep rows the same points, the mf family's scores
equal; ``evaluate --family learned`` with ``fit`` patched to 2 epochs in
BOTH packages (the patch keeps the test short; ``fit`` itself is held to
JAX in ``tests/test_torch_learned.py``), its scores within one call of
JAX's a sweep point (a trained CNN is rounding away from JAX's).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import matplotlib
from tests.torch_threads import one_torch_thread  # noqa: F401

matplotlib.use("Agg")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from das4whales_tpu.__main__ import main as jmain  # noqa: E402
from das4whales_tpu.io.hdf5 import write_optasense  # noqa: E402
from das4whales_tpu.io.synth import SyntheticCall, SyntheticScene, write_synthetic_file  # noqa: E402
from das4whales_tpu_torch.__main__ import main as tmain  # noqa: E402
from das4whales_tpu_torch.io.stream import stream_strain_blocks  # noqa: E402
from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector  # noqa: E402
from das4whales_tpu_torch.utils.parity import envelopes, unexplained_differences  # noqa: E402
from das4whales_tpu_torch.utils.artifacts import read_records  # noqa: E402
from das4whales_tpu_torch.workflows.campaign import load_picks  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NX = 48


def _run(main, argv, capsys, jax_side=False):
    capsys.readouterr()
    if jax_side:
        with jax.enable_x64(False):
            rc = main(argv)
    else:
        rc = main(argv + (["--device", "cpu"] if _computes(argv) else []))
    out = capsys.readouterr()
    return rc, out.out, out.err


def _computes(argv) -> bool:
    return argv[0] in ("evaluate", "campaign", "longrecord")


def _verb_lines(verb, out, outdirs=()):
    lines = [ln for ln in out.splitlines() if ln.startswith(f"{verb}")]
    for d in outdirs:
        lines = [ln.replace(str(d), "<outdir>") for ln in lines]
    return lines


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_files")
    out = {}
    for k in range(2):
        scene = SyntheticScene(nx=NX, ns=1000, noise_rms=0.05, seed=500 + k, calls=[
            SyntheticCall(t0=1.0 + 0.5 * k, x0_m=(12 + 10 * k) * 2.042, amplitude=2.0),
            SyntheticCall(t0=3.2, x0_m=(36 - 6 * k) * 2.042, amplitude=2.0,
                          fmin=14.7, fmax=21.8, duration=0.78)])
        out[f"f{k}"] = write_synthetic_file(str(d / f"f{k}.h5"), scene)
    bad = d / "bad.h5"
    bad.write_bytes(b"\x00garbage" * 64)
    out["bad"] = str(bad)
    return out


def _same_picks(jpicks: dict, tpicks: dict, env_of, thr_of):
    assert sorted(jpicks) == sorted(tpicks)
    for name in jpicks:
        a, b = np.asarray(jpicks[name]), np.asarray(tpicks[name])
        if a.shape == b.shape and np.array_equal(a, b):
            continue
        bad = unexplained_differences(a, b, env_of(name), thr_of(name))
        assert not bad, f"{name}: picks differ beyond rounding at {bad[:10]}"


def test_list_and_help_match_jax(capsys):
    rj, oj, _ = _run(jmain, ["list"], capsys, jax_side=True)
    rt, ot, _ = _run(tmain, ["list"], capsys)
    assert rj == rt == 0 and ot == oj and "bathynoise" in ot


def test_list_and_help_run_as_a_module():
    env = dict(os.environ, PYTHONPATH=ROOT, MPLBACKEND="Agg")
    for argv, want in ((["list"], "mfdetect"), (["--help"], "workflow"),
                       (["campaign", "--help"], "--device")):
        out = subprocess.run([sys.executable, "-m", "das4whales_tpu_torch", *argv],
                             capture_output=True, text=True, env=env, timeout=120, cwd=ROOT)
        assert out.returncode == 0, out.stderr[-2000:]
        assert want in out.stdout


def test_campaign_and_fsck_match_jax(files, tmp_path, capsys):
    paths = [files["f0"], files["bad"], files["f1"]]
    outs = {}
    for side, main in (("j", jmain), ("t", tmain)):
        outdir = tmp_path / side
        rc, out, _ = _run(main, ["campaign", *paths, "--outdir", str(outdir)], capsys,
                          jax_side=side == "j")
        outs[side] = (rc, _verb_lines("campaign", out, [outdir]), outdir)
    (rj, lj, dj), (rt, lt, dt) = outs["j"], outs["t"]
    assert rj == rt == 3                      # one file failed
    assert lt == lj and "campaign: 2 done, 1 failed, 0 skipped -> <outdir>" in lt
    sj = json.loads((dj / "summary.json").read_text())
    st = json.loads((dt / "summary.json").read_text())
    for s in (sj, st):
        for f in s["files"]:
            f.pop("wall_s")
    assert st == sj
    assert (dt / "density.png").stat().st_size > 0
    meta_sel = [0, NX, 1]
    for name in ("f0", "f1"):
        (jf,), (tf,) = ([str(p) for p in (d / "picks").glob(f"{name}-*.npz")]
                        for d in (dj, dt))
        assert os.path.basename(tf) == os.path.basename(jf)
        jp, tp = load_picks(jf), load_picks(tf)
        block = next(stream_strain_blocks([files[name]], meta_sel, device="cpu"))
        det = MatchedFilterDetector(block.metadata, meta_sel, tuple(block.trace.shape),
                                    device="cpu")
        res = det.detect_picks(block.trace)
        env = dict(zip(det.design.template_names, envelopes(det, block.trace)))
        _same_picks(jp, tp, env.__getitem__, res.thresholds.__getitem__)
    # a second run resumes: every file skipped but the failed one
    rt2, out2, _ = _run(tmain, ["campaign", *paths, "--outdir", str(dt)], capsys)
    assert rt2 == 3 and "campaign: 0 done, 1 failed, 2 skipped" in out2
    # fsck of both outdirs: the same findings, the same exit code
    for extra in ([], ["--json"]):
        rj, oj, _ = _run(jmain, ["fsck", str(dj), *extra], capsys, jax_side=True)
        rt, ot, _ = _run(tmain, ["fsck", str(dt), *extra], capsys)
        assert rj == rt and ot.replace(str(dt), "<o>") == oj.replace(str(dj), "<o>")


@pytest.mark.parametrize("argv, want", [
    (["--family", "learned"], 2),                          # learned without --model
    (["--family", "spectro", "--bank", "fin-variants"], 2),
    (["--max-failures", "0"], 4),                          # aborted at the corrupt file
])
def test_campaign_error_paths_match_jax(files, tmp_path, capsys, argv, want):
    paths = [files["bad"], files["f0"]]
    rcs = []
    for side, main in (("j", jmain), ("t", tmain)):
        rc, out, _ = _run(main, ["campaign", *paths, "--outdir", str(tmp_path / side), *argv],
                          capsys, jax_side=side == "j")
        rcs.append((rc, _verb_lines("campaign", out, [tmp_path / side])))
    assert rcs[0] == rcs[1] and rcs[1][0] == want


def test_campaign_with_no_probeable_file_exits_3(files, tmp_path, capsys):
    for side, main in (("j", jmain), ("t", tmain)):
        rc, out, _ = _run(main, ["campaign", files["bad"], "--outdir", str(tmp_path / side)],
                          capsys, jax_side=side == "j")
        assert rc == 3 and "no file in the list is probeable" in out


@pytest.mark.parametrize("argv", [["campaign", "x.h5", "--sharded"],
                                  ["campaign", "x.h5", "--multihost"],
                                  ["fleet", "fleet.json"]])
def test_mesh_flags_and_fleet_exit_2_naming_their_item(argv, capsys, tmp_path, files):
    """The mesh flags run: without torchrun's variables a mesh of one on
    the CPU, whose records are the one-device campaign's (tests/
    test_torch_campaign_sharded.py holds them against JAX's). The fleet
    verb runs: a registry with an unknown key fails naming it, in both
    packages, before any worker starts (running fleets:
    tests/test_torch_fleet.py)."""
    if argv[0] == "fleet":
        cfg = tmp_path / argv[1]
        cfg.write_text(json.dumps({"tenants": [], "root": str(tmp_path / "f"),
                                   "bogus_knob": 1}))
        for main in (jmain, tmain):
            with pytest.raises(ValueError, match="bogus_knob"):
                main(["fleet", str(cfg), "--device", "cpu"] if main is tmain
                     else ["fleet", str(cfg)])
        assert "Service and fleet" not in capsys.readouterr().err
        assert not (tmp_path / "f").exists()
        return
    paths = [files["f0"], files["bad"], files["f1"]]
    rc, out, _ = _run(tmain, ["campaign", *paths, argv[2], "--no-figure",
                              "--outdir", str(tmp_path / "m")], capsys)
    assert rc == 3 and "campaign: 2 done, 1 failed, 0 skipped" in out
    rc1, _, _ = _run(tmain, ["campaign", *paths, "--no-figure", "--outdir",
                             str(tmp_path / "one")], capsys)
    assert rc1 == 3
    rung = "multihost" if argv[2] == "--multihost" else "sharded"
    recs = {r["path"]: r for r in read_records(str(tmp_path / "m" / "manifest.jsonl"))}
    ones = {r["path"]: r for r in read_records(str(tmp_path / "one" / "manifest.jsonl"))}
    assert sorted(recs) == sorted(ones)
    for path, r in recs.items():
        assert r["status"] == ones[path]["status"] and r["family"] == "mf"
        if r["status"] == "done":
            assert r["rung"] == rung
            a, b = load_picks(r["picks_file"]), load_picks(ones[path]["picks_file"])
            for name in a:
                np.testing.assert_array_equal(a[name], b[name])
    assert not (tmp_path / "m" / "density.png").exists()


def _long_files(d):
    fs, ns = 200.0, 1536
    rng = np.random.default_rng(5)
    record = rng.standard_normal((NX, 2 * ns)) * 1e-9
    from das4whales_tpu_torch.models.templates import gen_template_fincall

    t = np.arange(ns) / fs
    call = gen_template_fincall(t, fs, 17.8, 28.8, 0.68, True)
    n_call = int(0.68 * fs) + 1
    onset = ns - n_call // 2          # one call straddling the boundary
    record[7, onset:onset + n_call] += 8e-9 * call[:n_call]
    return [write_optasense(str(d / f"seg{k}.h5"),
                            np.round(record[:, k * ns:(k + 1) * ns] / 1e-12).astype(np.int32),
                            fs=fs, dx=4.0) for k in range(2)]


def test_longrecord_matches_jax(tmp_path, capsys):
    paths = _long_files(tmp_path)
    outs = {}
    for side, main in (("j", jmain), ("t", tmain)):
        outdir = tmp_path / f"lr_{side}"
        rc, out, _ = _run(main, ["longrecord", *paths, "--outdir", str(outdir)], capsys,
                          jax_side=side == "j")
        outs[side] = (rc, _verb_lines("longrecord", out, [outdir]), outdir)
    (rj, lj, dj), (rt, lt, dt) = outs["j"], outs["t"]
    assert rj == rt == 0 and lt == lj and "2 files as one" in lt[-1]
    sj = json.loads((dj / "summary.json").read_text())
    st = json.loads((dt / "summary.json").read_text())
    for name, thr in sj.pop("thresholds").items():
        np.testing.assert_allclose(st["thresholds"][name], thr, rtol=1e-5)
    st.pop("thresholds")
    assert st == sj
    with np.load(dj / "picks.npz") as zj, np.load(dt / "picks.npz") as zt:
        assert sorted(zj.files) == sorted(zt.files)
        for key in zj.files:
            np.testing.assert_array_equal(zt[key], zj[key])


#: the Gabor image settings of ``tests/test_gabor_timeshard.py``: the verb
#: has no flag for them, so both packages' workflow takes them through a
#: patch (the default receptive field needs thousands of channels a shard)
GABOR_KW = dict(bin_factor=0.5, ksize=6, threshold1=2000.0, threshold2=10.0)
#: channels of the Gabor verb's files: JAX's verb shards the record over
#: the 8 CPU devices, and 24 rows a shard hold the 20-row channel halo
GABOR_NX = 192


def _gabor_files(d):
    fs, ns = 200.0, 1536
    calls = [SyntheticCall(t0=5.0, x0_m=90 * 4.0, amplitude=2.0),
             SyntheticCall(t0=7.4, x0_m=40 * 4.0, amplitude=2.0)]
    scene = SyntheticScene(nx=GABOR_NX, ns=2 * ns, dx=4.0, noise_rms=0.05, seed=61,
                           calls=calls)
    from das4whales_tpu.io.synth import synthesize_scene, to_raw_counts

    raw = to_raw_counts(synthesize_scene(scene), scene.metadata)
    return [write_optasense(str(d / f"gseg{k}.h5"), raw[:, k * ns:(k + 1) * ns], fs=fs,
                            dx=4.0) for k in range(2)]


def _gabor_kw(fn):
    def wrapped(*a, **kw):
        if kw.get("family") == "gabor" and not kw.get("family_kwargs"):
            kw["family_kwargs"] = dict(GABOR_KW)
        return fn(*a, **kw)
    return wrapped


@pytest.mark.parametrize("argv", [["--family", "learned"], ["--family", "gabor"],
                                  ["--staged"]])
def test_longrecord_refusals(tmp_path, capsys, monkeypatch, argv):
    """``--family learned`` without ``--model`` exits 2 as JAX's; the Gabor
    family over a record, once refused, exits 0 with JAX's verb lines,
    thresholds within rtol 1e-5 and picks up to knife edges of the port's
    own envelopes (both packages' workflow given the test-size image
    settings); the staged (halo) bandpass runs, as a mesh of one."""
    if argv == ["--family", "gabor"]:
        from das4whales_tpu.workflows import longrecord as jlr
        from das4whales_tpu_torch.workflows import longrecord as tlr

        monkeypatch.setattr(jlr, "detect_long_record", _gabor_kw(jlr.detect_long_record))
        monkeypatch.setattr(tlr, "detect_long_record", _gabor_kw(tlr.detect_long_record))
        paths = _gabor_files(tmp_path)
        outs = {}
        for side, main in (("j", jmain), ("t", tmain)):
            outdir = tmp_path / side
            # JAX's verb splits the record over 8 devices: 384 samples a
            # shard, under the default bandpass halo of 512
            rc, out, _ = _run(main, ["longrecord", *paths, "--outdir", str(outdir), *argv,
                                     "--halo", "256"], capsys, jax_side=side == "j")
            outs[side] = (rc, _verb_lines("longrecord", out, [outdir]), outdir)
        (rj, lj, dj), (rt, lt, dt) = outs["j"], outs["t"]
        assert rj == rt == 0 and lt == lj and "2 files as one" in lt[-1]
        sj = json.loads((dj / "summary.json").read_text())
        st = json.loads((dt / "summary.json").read_text())
        for name, thr in sj.pop("thresholds").items():
            np.testing.assert_allclose(st["thresholds"][name], thr, rtol=1e-5)
        st.pop("thresholds")
        assert st == sj and sum(sj["n_picks"].values()) > 0
        one = tlr.detect_long_record(paths, [0, GABOR_NX, 1], device="cpu", family="gabor",
                                     family_kwargs=GABOR_KW, halo=256, keep_envelopes=True)
        names, env, thr = list(one.thresholds), one.envelopes, one.thresholds
        with np.load(dj / "picks.npz") as zj, np.load(dt / "picks.npz") as zt:
            for i, name in enumerate(names):
                assert not unexplained_differences(zj[f"picks_{name}"], zt[f"picks_{name}"],
                                                   env[i], thr[name])
        return
    paths = _long_files(tmp_path)
    rc, out, err = _run(tmain, ["longrecord", *paths, "--outdir", str(tmp_path / "o"), *argv],
                        capsys)
    if argv == ["--staged"]:
        assert rc == 0 and "2 files as one" in out
        return
    assert rc == 2
    rj, oj, _ = _run(jmain, ["longrecord", *paths, "--outdir", str(tmp_path / "j"), *argv],
                     capsys, jax_side=True)
    assert rj == 2 and _verb_lines("longrecord", out) == _verb_lines("longrecord", oj)


def _sweep(main, argv, capsys, jax_side, tmp_path, tag):
    out_json = tmp_path / f"{tag}.json"
    fig = tmp_path / f"{tag}.png"
    rc, out, _ = _run(main, ["evaluate", *argv, "--out", str(out_json), "--figure", str(fig)],
                      capsys, jax_side=jax_side)
    assert rc == 0 and fig.stat().st_size > 0
    payload = json.loads(out)
    assert json.loads(out_json.read_text()) == payload
    return payload


def test_evaluate_mf_matches_jax(tmp_path, capsys):
    argv = ["--nx", "48", "--ns", "6000", "--amplitudes", "0.15,1.0"]
    jp = _sweep(jmain, argv, capsys, True, tmp_path, "j")
    tp = _sweep(tmain, argv, capsys, False, tmp_path, "t")
    assert tp == jp
    assert tp[-1]["HF"]["recall"] > 0


def test_evaluate_learned_with_fit_patched_matches_jax(tmp_path, capsys, monkeypatch):
    from das4whales_tpu.models import learned as jlearned
    from das4whales_tpu_torch.models import learned as tlearned

    for mod in (jlearned, tlearned):
        fit = mod.fit
        monkeypatch.setattr(mod, "fit", lambda cfg, scenes, *a, _fit=fit, **kw:
                            _fit(cfg, scenes, *a, **{**kw, "epochs": 2}))
    argv = ["--family", "learned", "--nx", "48", "--ns", "6000", "--amplitudes", "0.5,1.0"]
    jp = _sweep(jmain, argv, capsys, True, tmp_path, "j")
    tp = _sweep(tmain, argv, capsys, False, tmp_path, "t")
    assert len(tp) == len(jp)
    for trow, jrow in zip(tp, jp):
        assert trow["amplitude"] == jrow["amplitude"] and trow["snr_db"] == jrow["snr_db"]
        assert set(trow) == set(jrow)
        # the eval scene holds 3 calls of each note
        assert abs(trow["CALL"]["recall"] - jrow["CALL"]["recall"]) <= 1 / 3 + 1e-9


def test_campaign_with_a_trained_model_matches_jax(files, tmp_path, capsys):
    """``campaign --family learned --model <npz>``: the pretrained model
    saved by the port's ``save_params`` (JAX's ``.npz`` layout), run by
    both command lines over the same files."""
    from das4whales_tpu_torch.models import learned as tlearned

    model, cfg = tlearned.load_pretrained()
    npz = tlearned.save_params(str(tmp_path / "model.npz"), model, cfg)
    paths = [files["f0"], files["f1"]]
    outs = {}
    for side, main in (("j", jmain), ("t", tmain)):
        outdir = tmp_path / side
        rc, out, _ = _run(main, ["campaign", *paths, "--outdir", str(outdir), "--family",
                                 "learned", "--model", npz], capsys, jax_side=side == "j")
        outs[side] = (rc, _verb_lines("campaign", out, [outdir]),
                      json.loads((outdir / "summary.json").read_text()))
    (rj, lj, sj), (rt, lt, st) = outs["j"], outs["t"]
    assert rj == rt == 0 and lt == lj
    for s in (sj, st):
        for f in s["files"]:
            f.pop("wall_s")
    assert st["by_family"] == sj["by_family"] == {"learned": {"done": 2}}
    assert st == sj
