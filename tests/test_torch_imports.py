"""The port stands alone: das4whales_tpu_torch and chip_smoke.py import
neither ``jax`` nor anything of ``das4whales_tpu``, the port imports with
both blocked, and its entry points refuse to run on a missing card
instead of falling back to the CPU."""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "das4whales_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "das4whales_tpu")


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_package_import(path):
    bad = sorted({m for m in _imported_roots(path) if m in FORBIDDEN})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_scan_covers_every_module_of_the_port():
    scanned = {str(p.relative_to(ROOT)) for p in _sources()}
    for mod in ("models/spectro.py", "ops/fused_stft.py", "ops/spectral.py", "eval.py",
                "workflows/common.py", "workflows/spectrodetect.py", "convert.py",
                "ops/health.py", "io/hdf5.py", "io/tdms.py", "io/interrogators.py",
                "io/stream.py", "io/staging.py", "io/native.py", "io/download.py",
                "parallel/batch.py", "utils/log.py", "crashpoints.py", "utils/artifacts.py",
                "telemetry/__init__.py", "telemetry/metrics.py", "telemetry/trace.py",
                "telemetry/probes.py", "telemetry/progress.py", "utils/views.py", "faults.py",
                "fsck.py", "utils/checkpoint.py", "parallel/dispatch.py",
                "workflows/planner.py", "workflows/campaign.py", "workflows/mfdetect.py",
                "utils/profiling.py", "models/templates.py", "ops/peaks.py", "ops/fk.py",
                "ops/image.py", "models/gabor.py", "workflows/gabordetect.py",
                "models/learned.py", "utils/parity.py", "loc.py", "ops/chunked.py",
                "ops/filters.py", "ops/xcorr.py", "ops/conditioning.py", "io/annotations.py",
                "io/coords.py", "workflows/longrecord.py", "utils/locks.py",
                "utils/memory.py", "telemetry/slo.py", "telemetry/quality.py",
                "telemetry/costs.py", "service/__init__.py", "service/ingest.py",
                "service/scheduler.py", "service/api.py", "service/runner.py",
                "__main__.py", "ops/mxu.py", "viz/__init__.py", "viz/cmaps.py",
                "viz/plot.py", "viz/map.py", "utils/audio.py", "workflows/fkcomp.py",
                "workflows/plots.py", "workflows/bathynoise.py",
                "workflows/spectrodetect.py", "workflows/gabordetect.py",
                "fleet/__init__.py", "fleet/supervisor.py", "fleet/router.py",
                "parallel/__init__.py", "parallel/mesh.py", "parallel/collectives.py",
                "parallel/distributed.py", "parallel/fft.py", "parallel/pipeline.py",
                "parallel/timeshard.py", "parallel/spectro.py", "parallel/gabor.py"):
        assert f"das4whales_tpu_torch/{mod}" in scanned
    assert "chip_smoke.py" in scanned


def test_port_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'jaxlib', 'das4whales_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import das4whales_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "assert 'jax' not in sys.modules or sys.modules['jax'] is None\n"
        "print(len(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_package_import_pulls_in_no_jax_matplotlib_or_h5py_and_builds_no_kernel():
    """A fresh ``import das4whales_tpu_torch`` (the smoke's ``surface``
    phase runs the same source on the card) has its eager attributes and
    none of its lazy ones; each lazy one loads on access as its module;
    none of it imports ``jax``, ``das4whales_tpu``, ``matplotlib`` or
    ``h5py`` (the card's machine has neither of the last two, this image
    both), and no kernel library or native reader is built."""
    import chip_smoke

    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", chip_smoke._SURFACE_IMPORT_SRC], cwd=str(ROOT),
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {
        "eager_missing": [], "lazy_early": [], "lazy_wrong": [], "foreign": [],
        "kernel_builds": 0, "native_built": False}


def test_default_device_is_the_card_and_never_the_cpu():
    from das4whales_tpu_torch.io.synth import SyntheticScene
    from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector
    from das4whales_tpu_torch.utils.device import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA device"):
        MatchedFilterDetector(SyntheticScene(nx=24, ns=900).metadata, [0, 24, 1], (24, 900))
    assert resolve_device("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_loc_eval_and_long_record_default_to_the_card(tmp_path):
    """``loc.localize``, ``loc.localize_batch``, ``eval.localize_scene_call``
    and ``detect_long_record`` given numpy inputs and no ``device=`` ask
    for the card and refuse without one, before any work."""
    import numpy as np

    from das4whales_tpu_torch import eval as teval
    from das4whales_tpu_torch import loc
    from das4whales_tpu_torch.io.hdf5 import write_optasense
    from das4whales_tpu_torch.io.synth import SyntheticCall, SyntheticScene
    from das4whales_tpu_torch.workflows.longrecord import detect_long_record

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    cable = np.stack([np.arange(16) * 10.0, np.zeros(16), np.zeros(16)], axis=1)
    ti = np.linspace(1.0, 1.1, 16)
    with pytest.raises(RuntimeError, match="CUDA device"):
        loc.localize(ti, cable, 1500.0)
    with pytest.raises(RuntimeError, match="CUDA device"):
        loc.localize_batch(np.stack([ti, ti]), cable, 1500.0)
    scene = SyntheticScene(nx=16, ns=400, calls=[SyntheticCall(t0=0.5, x0_m=10.0)])
    picks = np.asarray([np.arange(16), np.full(16, 110)])
    with pytest.raises(RuntimeError, match="CUDA device"):
        teval.localize_scene_call(picks, scene)
    path = write_optasense(str(tmp_path / "f.h5"), np.zeros((8, 64), np.int32), fs=200.0,
                           dx=2.0)
    with pytest.raises(RuntimeError, match="CUDA device"):
        detect_long_record([path], [0, 8, 1])
    # the spectro and Gabor families (a mesh of one on the card)
    for family in ("spectro", "gabor"):
        with pytest.raises(RuntimeError, match="CUDA device"):
            detect_long_record([path], [0, 8, 1], family=family)
    assert loc.localize(ti, cable, 1500.0, device="cpu").position.device.type == "cpu"


def test_ingest_and_batched_route_default_to_the_card(tmp_path):
    """The slab stream, the single-file loader and the pinned stager take
    the card by default and refuse without one; nothing drops to the CPU
    or to a pageable copy."""
    import numpy as np

    from das4whales_tpu_torch.io.hdf5 import load_das_data, write_optasense
    from das4whales_tpu_torch.io.staging import PinnedStager
    from das4whales_tpu_torch.io.stream import stream_batched_slabs, stream_strain_blocks

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    path = write_optasense(str(tmp_path / "f.h5"), np.zeros((8, 64), np.int32), fs=200.0, dx=2.0)
    with pytest.raises(RuntimeError, match="CUDA device"):
        next(stream_batched_slabs([path], [0, 8, 1], batch=2))
    with pytest.raises(RuntimeError, match="CUDA device"):
        next(stream_strain_blocks([path], [0, 8, 1]))
    with pytest.raises(RuntimeError, match="CUDA device"):
        load_das_data(path, [0, 8, 1], {"fs": 200.0, "dx": 2.0, "nx": 8, "ns": 64})
    with pytest.raises(ValueError, match="CUDA device"):
        PinnedStager(torch.device("cpu"))


def test_campaigns_default_to_the_card(tmp_path):
    """Both campaign entries take the card by default and refuse without
    one before reading a file: no manifest is written, nothing runs on
    the CPU, no file is failed for it."""
    import numpy as np

    from das4whales_tpu_torch.io.hdf5 import write_optasense
    from das4whales_tpu_torch.workflows.campaign import run_campaign, run_campaign_batched

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    path = write_optasense(str(tmp_path / "f.h5"), np.zeros((8, 64), np.int32), fs=200.0, dx=2.0)
    for entry in (run_campaign, run_campaign_batched):
        out = tmp_path / entry.__name__
        with pytest.raises(RuntimeError, match="CUDA device"):
            entry([path], [0, 8, 1], str(out))
        assert not (out / "manifest.jsonl").exists()
    # the mesh routes: a mesh's ranks take their cards, the multi-host
    # campaign and the batch stream too
    from das4whales_tpu_torch.io.stream import stream_file_batches
    from das4whales_tpu_torch.parallel.mesh import make_mesh
    from das4whales_tpu_torch.workflows.campaign import run_campaign_multiprocess

    out = tmp_path / "mesh"
    with pytest.raises(RuntimeError, match="CUDA device"):
        run_campaign_multiprocess([path], [0, 8, 1], str(out))
    with pytest.raises(RuntimeError, match="CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA device"):
        stream_file_batches([path], [0, 8, 1], batch=1)
    assert not out.exists()


def test_service_and_serve_default_to_the_card(tmp_path):
    """``DetectionService`` without ``device`` (and ``serve`` on a registry
    without a ``device`` key) asks for the card and refuses without one,
    before any file is read or any output written."""
    import json

    from das4whales_tpu_torch.__main__ import main
    from das4whales_tpu_torch.service import DetectionService, ServiceConfig, TenantSpec

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    out = tmp_path / "svc"
    with pytest.raises(RuntimeError, match="CUDA device"):
        DetectionService(ServiceConfig(tenants=[TenantSpec(name="a", files=["x.h5"],
                                                           channels=[0, 8, 1])],
                                       outdir=str(out)))
    reg = tmp_path / "reg.json"
    reg.write_text(json.dumps({"outdir": str(out), "tenants": [
        {"name": "a", "files": ["x.h5"], "channels": [0, 8, 1]}]}))
    with pytest.raises(RuntimeError, match="CUDA device"):
        main(["serve", str(reg), "--until-idle"])
    assert not out.exists()


def test_fleet_defaults_to_the_card(tmp_path):
    """``FleetConfig().device`` is the card and a registry without a
    ``device`` key loads onto it; the ``fleet`` verb without ``--device``
    raises ``resolve_device``'s error before it makes its root or spawns a
    worker; a supervisor started on the card spawns its worker, which
    exits non-zero naming the missing card, and ``start`` names the
    worker's log — nothing runs on the CPU."""
    import json

    from das4whales_tpu_torch.__main__ import main
    from das4whales_tpu_torch.fleet import FleetConfig, FleetSupervisor, load_fleet_config

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    assert FleetConfig(tenants=[]).device == "cuda"
    root = tmp_path / "fleet"
    reg = tmp_path / "fleet.json"
    reg.write_text(json.dumps({"root": str(root), "workers": 1, "tenants": [
        {"name": "a", "files": ["x.h5"], "channels": [0, 8, 1]}]}))
    assert load_fleet_config(str(reg)).device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA device"):
        main(["fleet", str(reg), "--until-settled"])
    assert not root.exists()
    cfg = load_fleet_config(str(reg))
    cfg.worker_env = {"PYTHONPATH": str(ROOT)}
    sup = FleetSupervisor(cfg)
    try:
        with pytest.raises(RuntimeError, match="worker.log"):
            sup.start()
    finally:
        sup.stop()
    log = (root / "workers" / "w0" / "worker.log").read_text()
    assert "CUDA device" in log and "device='cpu'" in log
    assert json.loads((root / "workers" / "w0" / "registry.json").read_text())["device"] == "cuda"
    assert not (root / "tenants" / "a").exists()


def test_cli_mains_and_figures_default_to_the_card(tmp_path, monkeypatch):
    """Without a card: every computing verb without ``--device`` ends with
    ``resolve_device``'s error (in-process it raises; as a module it exits
    non-zero), before reading its file or writing its outdir; the mains
    and the figures' device helpers raise it; ``import
    das4whales_tpu_torch.viz`` works with matplotlib blocked."""
    import numpy as np

    from das4whales_tpu_torch.__main__ import WORKFLOWS, main
    from das4whales_tpu_torch.io.hdf5 import write_optasense
    from das4whales_tpu_torch.viz import plot
    from das4whales_tpu_torch.workflows import (bathynoise, fkcomp, gabordetect, mfdetect,
                                                plots, spectrodetect)

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the refusal without one")
    monkeypatch.chdir(tmp_path)
    path = write_optasense(str(tmp_path / "f.h5"), np.zeros((8, 64), np.int32), fs=200.0,
                           dx=2.0)
    verbs = [[w, path] for w in WORKFLOWS] + [["campaign", path], ["longrecord", path],
                                              ["evaluate", "--nx", "8", "--ns", "400"]]
    for argv in verbs:
        with pytest.raises(RuntimeError, match="CUDA device"):
            main(argv)
    assert sorted(os.listdir(tmp_path)) == ["f.h5"]
    env = dict(os.environ, PYTHONPATH=str(ROOT), MPLBACKEND="Agg")
    out = subprocess.run([sys.executable, "-m", "das4whales_tpu_torch", "mfdetect", path,
                          "--outdir", str(tmp_path / "o")], capture_output=True, text=True,
                         env=env, timeout=120, cwd=str(tmp_path))
    assert out.returncode != 0 and "device='cpu'" in out.stderr
    for m in (mfdetect, spectrodetect, gabordetect, fkcomp, plots, bathynoise):
        with pytest.raises(RuntimeError, match="CUDA device"):
            m.main(path)
    x = np.zeros((4, 64), np.float32)
    for fn, args in ((plot.envelope_np, (x,)), (plot.fx_panels, (x, 200.0)),
                     (plot.instant_freq_np, (x[0], 200.0))):
        with pytest.raises(RuntimeError, match="CUDA device"):
            fn(*args)
    assert sorted(os.listdir(tmp_path)) == ["f.h5"]
    code = ("import sys\nsys.modules['matplotlib'] = None\n"
            "import das4whales_tpu_torch.viz as v\n"
            "assert not v.plot.have_matplotlib() and 'matplotlib.pyplot' not in sys.modules\n"
            "print(v.import_roseus.__name__)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "import_roseus"


def test_telemetry_is_free_when_off_and_annotates_the_profiler_when_on():
    """Disabled, a span is one shared no-op object (no clock, no torch
    work); enabled, it enters ``torch.profiler.record_function`` under
    its name, so a profile of the card carries the campaign's spans."""
    from das4whales_tpu_torch.telemetry import trace

    assert not trace.enabled()
    assert trace.span("a", x=1) is trace.span("b")
    trace.enable(clear=True)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with trace.span("slab", n=2):
                torch.ones(4).sum()
    finally:
        trace.disable()
    assert "slab" in {e.key for e in prof.key_averages()}
    assert [s["name"] for s in trace.take_spans()] == ["slab"]


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """Without a card the smoke run exits non-zero and prints no result
    line; alone in a directory (no package beside it) it fails too."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = dict(os.environ, PYTHONPATH="")
    here = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=str(ROOT),
                          env=env, capture_output=True, text=True, timeout=120)
    assert here.returncode != 0 and '"ok"' not in here.stdout
    alone = tmp_path / "chip_smoke.py"
    alone.write_text((ROOT / "chip_smoke.py").read_text())
    lone = subprocess.run([sys.executable, str(alone)], cwd=str(tmp_path), env=env,
                          capture_output=True, text=True, timeout=120)
    assert lone.returncode != 0 and '"ok"' not in lone.stdout
