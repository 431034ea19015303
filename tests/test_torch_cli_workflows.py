"""Port parity, the command line's six workflow verbs: ``python -m
das4whales_tpu_torch <workflow> <file> --outdir d --device cpu`` through
``main(argv)`` in-process, against das4whales_tpu's ``main(argv)``
(float32, x64 off) on JAX's ``small_scene`` (96 x 3000, dx 12 m) written
as an OptaSense HDF5 file.

Contract: exit code 0 for both; the verbs' pick lines equal (``mfdetect:
template HF: n picks``); the same figure and audio files written, each
non-empty. Without matplotlib each verb exits 2 naming it, before it
reads a file. ``tests/test_torch_mains.py`` holds the mains' arrays.
"""

from __future__ import annotations

import os

import matplotlib
from tests.torch_threads import one_torch_thread  # noqa: F401

matplotlib.use("Agg")

import jax  # noqa: E402
import pytest  # noqa: E402

from das4whales_tpu.__main__ import main as jmain  # noqa: E402
from das4whales_tpu.io import synth as jsynth  # noqa: E402
from das4whales_tpu_torch.__main__ import WORKFLOWS, main as tmain  # noqa: E402


@pytest.fixture(scope="module")
def scene_file(tmp_path_factory):
    calls = [
        jsynth.SyntheticCall(t0=4.0, x0_m=400.0, fmin=17.8, fmax=28.8, duration=0.68,
                             amplitude=6.0),
        jsynth.SyntheticCall(t0=10.0, x0_m=900.0, fmin=14.7, fmax=21.8, duration=0.78,
                             amplitude=6.0),
    ]
    scene = jsynth.SyntheticScene(nx=96, ns=3000, dx=12.0, calls=calls, seed=3)
    path = str(tmp_path_factory.mktemp("cli_scene") / "scene.h5")
    return jsynth.write_synthetic_file(path, scene)


def _lines(verb, out):
    return [ln for ln in out.splitlines() if ln.startswith(f"{verb}: ")]


@pytest.mark.parametrize("verb, extra", [("mfdetect", []), ("mfdetect", ["--no-snr"]),
                                         ("spectrodetect", []), ("gabordetect", []),
                                         ("fkcomp", []), ("plots", []), ("bathynoise", [])])
def test_workflow_verb_matches_jax(scene_file, tmp_path, capsys, verb, extra):
    outs = {}
    for side in ("j", "t"):
        outdir = tmp_path / side
        argv = [verb, scene_file, "--outdir", str(outdir), *extra]
        capsys.readouterr()
        if side == "j":
            with jax.enable_x64(False):
                rc = jmain(argv)
        else:
            rc = tmain(argv + ["--device", "cpu"])
        out = capsys.readouterr().out
        outs[side] = (rc, _lines(verb, out), sorted(os.listdir(outdir)), outdir)
    (rj, lj, fj, _), (rt, lt, ft, dt) = outs["j"], outs["t"]
    assert rj == rt == 0
    assert lt == lj
    assert ft == fj and ft
    assert all((dt / f).stat().st_size > 0 for f in ft)


def test_list_names_the_six_workflows():
    assert list(WORKFLOWS) == ["mfdetect", "spectrodetect", "gabordetect", "fkcomp", "plots",
                               "bathynoise"]


@pytest.mark.parametrize("argv", [[verb] for verb in WORKFLOWS]
                         + [["campaign", "x.h5"], ["evaluate", "--figure", "f.png"]])
def test_a_rendering_verb_without_matplotlib_exits_2_before_reading(
        argv, tmp_path, capsys, monkeypatch):
    """With matplotlib blocked, a verb that renders stops with exit 2
    naming it: no file is read (the file does not exist), no device is
    asked for (no ``--device``), nothing is written."""
    monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)
    monkeypatch.chdir(tmp_path)
    path = str(tmp_path / "absent.h5")
    argv = [argv[0], path, *argv[1:]] if argv[0] in WORKFLOWS else argv
    assert tmain(argv) == 2
    assert "needs matplotlib" in capsys.readouterr().err
    assert os.listdir(tmp_path) == []
