"""The port stands alone: das4whales_tpu_torch and chip_smoke.py import
neither ``jax`` nor anything of ``das4whales_tpu``, the port imports with
both blocked, and its entry points refuse to run on a missing card
instead of falling back to the CPU."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

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
                "workflows/planner.py", "workflows/campaign.py"):
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
