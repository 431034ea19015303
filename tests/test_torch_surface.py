"""The port's public surface against the JAX package's.

Every public name that a ``das4whales_tpu`` module defines or re-exports
from inside the package (its object's ``__module__`` starts with
``das4whales_tpu``; for a package, the modules its ``__init__`` imports)
resolves on the port's module of the same path, and every public method
and property of each JAX class on the port's class, unless it stands in
:data:`EXCEPTIONS` with its reason. A listed name that the port does have
fails, so the list cannot go stale. Beside that, the names this surface
added behave as JAX's: the meter-based channel selection and the
acquisition properties, the profiling helpers, ``probe_backend``,
``supports_fused_health``, the batched facades' engine labels, the STFT
engine resolver, a tenant's ``handle_slab``, and the package's eager and
lazy attributes.
"""

from __future__ import annotations

import ast
import importlib
import inspect
import json
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tests.torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
JAX_ROOT = ROOT / "das4whales_tpu"

#: JAX module paths with no module of the same path in the port
MODULE_EXCEPTIONS = {
    "ops/pallas_picks.py": "the Pallas pick kernel; its counterpart is ops/fused_picks.py "
                           "over csrc/fused_picks.cu",
    "ops/pallas_stft.py": "the Pallas STFT kernel; its counterpart is ops/fused_stft.py "
                          "over csrc/fused_stft.cu",
    "parallel/compat.py": "a shard_map shim across jax versions; the port's mesh is "
                          "torch.distributed (parallel/mesh.py, parallel/collectives.py)",
}

_XLA_CACHE = "XLA's persistent compilation cache: eager PyTorch compiles no program to keep"
_JIT = "a jax.jit spelling; the port runs the same function eagerly"
_HOST_DEVICES = ("XLA's virtual CPU devices in one process; the port's mesh ranks are "
                 "processes (parallel.distributed)")
_AOT = ("XLA's ahead-of-time analysis of a compiled program; the preflight measures a "
        "program's peak on the card instead (utils.memory.probe_program)")
_TPU_PEAK = ("a TPU v5e's published peak; the port's card peaks are "
             "telemetry.costs.KNOWN_PEAKS, keyed by the card's name")
_CPU_PEAK = ("a nominal CPU roofline; the port prices no roofline on the CPU "
             "(telemetry.costs.device_peaks has none there), so a default would mean nothing")

#: names of the JAX package (``module.name`` below the package, ``name``
#: at its root, ``module.Class.member``) the port does not carry, each
#: with its reason
EXCEPTIONS = {
    "config.DEFAULT_COMPILATION_CACHE_DIR": _XLA_CACHE,
    "config.compilation_cache_dir": _XLA_CACHE,
    "config.enable_persistent_compilation_cache": _XLA_CACHE,
    "ops.conditioning.condition_jit": _JIT + " (ops.conditioning.condition)",
    "ops.conditioning.condition_donated": _JIT + ", its input donated "
                                                 "(ops.conditioning.condition)",
    "ops.mxu.fk_apply_dft_matmul_jit": _JIT + " (ops.mxu.fk_apply_dft_matmul)",
    "ops.mxu.fused_correlograms_body": "the traced body of a jitted program; the port "
                                       "calls ops.mxu's correlate eagerly",
    "parallel.batch.batched_detect_picks_program": _JIT + " (the batched facade's program)",
    "parallel.batch.batched_detect_picks_program_donated": _JIT + ", its slab donated",
    "utils.device.ensure_devices": _HOST_DEVICES,
    "utils.device.force_cpu_host_devices": _HOST_DEVICES,
    "utils.memory.aot_memory_stats": _AOT,
    "utils.memory.aot_program_analysis": _AOT,
    "analysis.programs.hlo_op_counts": "counts the operations of compiled HLO; the port's "
                                       "audit counts the recorded stream of aten operations "
                                       "(analysis.programs.OpRecorder)",
    "analysis.programs.alias_param_numbers": "HLO input-output aliasing (buffer donation); "
                                             "eager PyTorch donates nothing",
    "analysis.runtime.install": "installs jax.monitoring listeners; the port counts probes "
                                "and builds where they happen (utils.memory, utils.build)",
    "analysis.pytest_plugin.compile_guard": "torch_compile_guard in the port, so both "
                                            "fixtures live in one pytest session",
    "analysis.pytest_plugin.race_guard": "torch_race_guard in the port, so both fixtures "
                                         "live in one pytest session",
    "analysis.pytest_plugin.retrace_guard": "torch_retrace_guard in the port, so both "
                                            "fixtures live in one pytest session",
    "telemetry.costs.HBM_GBS": _TPU_PEAK,
    "telemetry.costs.F32_FLOPS": _TPU_PEAK,
    "telemetry.costs.MXU_BF16_FLOPS": _TPU_PEAK,
    "telemetry.costs.CPU_FLOPS_DEFAULT": _CPU_PEAK,
    "telemetry.costs.CPU_HBM_GBS_DEFAULT": _CPU_PEAK,
}

#: the port's names for the renamed fixtures
RENAMED = {"analysis.pytest_plugin.compile_guard": "torch_compile_guard",
           "analysis.pytest_plugin.race_guard": "torch_race_guard",
           "analysis.pytest_plugin.retrace_guard": "torch_retrace_guard"}


def _rel_module(rel: str) -> str:
    """``io/hdf5.py`` -> ``io.hdf5``; ``io/__init__.py`` -> ``io``; the
    package's own ``__init__.py`` -> ``""``."""
    parts = list(Path(rel).with_suffix("").parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _qualified(pkg: str, mod: str) -> str:
    return pkg + ("." + mod if mod else "")


def _key(mod: str, name: str) -> str:
    return f"{mod}.{name}" if mod else name


JAX_MODULES = sorted(str(p.relative_to(JAX_ROOT)) for p in JAX_ROOT.rglob("*.py")
                     if str(p.relative_to(JAX_ROOT)) not in MODULE_EXCEPTIONS)
EXCEPTED_CHILDREN = {_rel_module(rel) for rel in MODULE_EXCEPTIONS}


def _source_names(path: Path) -> tuple:
    """(names bound at the top level of a module's source: functions,
    classes, assignments, also inside top-level ``if``/``try``; the child
    modules a package's ``__init__`` imports with ``from . import``)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    defined, children = set(), set()

    def visit(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                defined.add(node.name)
            elif isinstance(node, ast.Assign):
                for target in node.targets:
                    defined.update(n.id for n in ast.walk(target) if isinstance(n, ast.Name))
            elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
                defined.add(node.target.id)
            elif isinstance(node, ast.ImportFrom) and node.level == 1 and node.module is None:
                children.update(a.asname or a.name for a in node.names)
            elif isinstance(node, (ast.If, ast.Try)):
                visit(node.body)
                for handler in getattr(node, "handlers", []):
                    visit(handler.body)
                visit(node.orelse)

    visit(tree.body)
    return defined, children


def _public_names(jmod, path: Path) -> dict:
    """The public names of JAX module ``jmod`` the port must carry."""
    defined, children = _source_names(path)
    out = {}
    for name, obj in vars(jmod).items():
        if name.startswith("_"):
            continue
        if isinstance(obj, types.ModuleType):
            if name in children and obj.__name__ == f"{jmod.__name__}.{name}":
                out[name] = obj
            continue
        owner = getattr(obj, "__module__", None)
        if name in defined or (isinstance(owner, str) and owner.startswith("das4whales_tpu")):
            out[name] = obj
    return out


def _members(cls) -> set:
    """Public methods and properties of ``cls`` defined in the JAX package
    (its own and those of its bases there)."""
    kinds = (types.FunctionType, property, classmethod, staticmethod)
    out = set()
    for base in cls.__mro__:
        if not (getattr(base, "__module__", "") or "").startswith("das4whales_tpu"):
            continue
        out.update(k for k, v in vars(base).items()
                   if not k.startswith("_") and isinstance(v, kinds))
    return out


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_public_names_resolve_on_the_port(rel):
    mod = _rel_module(rel)
    jmod = importlib.import_module(_qualified("das4whales_tpu", mod))
    tmod = importlib.import_module(_qualified("das4whales_tpu_torch", mod))
    missing = []
    for name, obj in sorted(_public_names(jmod, JAX_ROOT / rel).items()):
        key = _key(mod, name)
        if key in EXCEPTIONS or (isinstance(obj, types.ModuleType)
                                 and _key(mod, name) in EXCEPTED_CHILDREN):
            continue
        if not hasattr(tmod, name):
            missing.append(key)
            continue
        if inspect.isclass(obj) and obj.__module__ == jmod.__name__:
            tcls = getattr(tmod, name)
            missing += [f"{key}.{m}" for m in sorted(_members(obj))
                        if f"{key}.{m}" not in EXCEPTIONS and not hasattr(tcls, m)]
    assert not missing, f"missing on das4whales_tpu_torch: {missing}"


@pytest.mark.parametrize("key", sorted(EXCEPTIONS))
def test_each_exception_has_a_reason_and_is_still_missing(key):
    """A listed name exists in the JAX package, has a reason, and is
    absent from the port (else the list has gone stale)."""
    assert len(EXCEPTIONS[key]) > 20
    mod, name = key.rsplit(".", 1) if "." in key else ("", key)
    jmod = importlib.import_module(_qualified("das4whales_tpu", mod))
    tmod = importlib.import_module(_qualified("das4whales_tpu_torch", mod))
    assert hasattr(jmod, name), f"{key} is not in the JAX package"
    assert not hasattr(tmod, name), f"{key} is in the port: take it off EXCEPTIONS"
    if key in RENAMED:
        assert hasattr(tmod, RENAMED[key])


@pytest.mark.parametrize("rel", sorted(MODULE_EXCEPTIONS))
def test_each_module_exception_has_a_reason_and_no_port_module(rel):
    assert len(MODULE_EXCEPTIONS[rel]) > 20
    assert (JAX_ROOT / rel).is_file()
    assert not (ROOT / "das4whales_tpu_torch" / rel).exists()
    with pytest.raises(ImportError):
        importlib.import_module(_qualified("das4whales_tpu_torch", _rel_module(rel)))


def _package_attributes() -> list:
    """``(package, attribute)`` for every module a JAX package's
    ``__init__`` imports, and the root package's lazy attributes."""
    out = []
    for init in sorted(JAX_ROOT.rglob("__init__.py")):
        pkg = _rel_module(str(init.relative_to(JAX_ROOT)))
        _, children = _source_names(init)
        out += [(pkg, c) for c in sorted(children) if _key(pkg, c) not in EXCEPTED_CHILDREN]
    tree = ast.parse((JAX_ROOT / "__init__.py").read_text())
    lazy = next(node for node in ast.walk(tree) if isinstance(node, ast.FunctionDef)
                and node.name == "__getattr__")
    names = next(ast.literal_eval(c.comparators[0]) for c in ast.walk(lazy)
                 if isinstance(c, ast.Compare) and isinstance(c.ops[0], ast.In))
    return out + [("", name) for name in sorted(names)]


@pytest.mark.parametrize("pkg,name", _package_attributes(),
                         ids=lambda v: v or "das4whales_tpu_torch")
def test_package_attribute_is_its_module(pkg, name):
    """``dw.<module>`` (eager or lazy) and a subpackage's modules are the
    modules of the same path, by identity."""
    parent = importlib.import_module(_qualified("das4whales_tpu_torch", pkg))
    child = importlib.import_module(_qualified("das4whales_tpu_torch", _key(pkg, name)))
    assert getattr(parent, name) is child


def test_the_names_a_caller_of_the_jax_package_uses_now_resolve():
    import das4whales_tpu_torch as dw
    from das4whales_tpu_torch.config import AcquisitionMetadata, ChannelSelection
    from das4whales_tpu_torch.io import load_das_data
    from das4whales_tpu_torch.models import MatchedFilterDetector
    from das4whales_tpu_torch.utils import StageTimer, annotate, block_and_time, device_trace
    from das4whales_tpu_torch.utils.device import probe_backend
    from das4whales_tpu_torch.workflows import detect_long_record

    assert ChannelSelection.from_meters(0.0, 100.0, 4.0, 2.0).to_list() == [0, 50, 2]
    assert dw.workflows.mfdetect.main is importlib.import_module(
        "das4whales_tpu_torch.workflows.mfdetect").main
    assert dw.AcquisitionMetadata is AcquisitionMetadata
    assert dw.ChannelSelection is ChannelSelection
    assert all(callable(f) for f in (load_das_data, MatchedFilterDetector, StageTimer, annotate,
                                     block_and_time, device_trace, probe_backend,
                                     detect_long_record))


def test_channel_selection_and_acquisition_helpers_equal_jax():
    from das4whales_tpu import config as jconfig
    from das4whales_tpu_torch import config as tconfig

    # tests/test_io.py's case
    sel = tconfig.ChannelSelection.from_meters(20000, 65000, 5, dx=2.042)
    assert sel.to_list() == [int(20000 // 2.042), int(65000 // 2.042), int(5 // 2.042)]
    for args in ((20000, 65000, 5, 2.042), (0.0, 1000.0, 2.042, 2.042),
                 (100.5, 900.25, 10.0, 4.0)):
        t = tconfig.ChannelSelection.from_meters(*args)
        j = jconfig.ChannelSelection.from_meters(*args)
        assert t.to_list() == j.to_list() and t.spacing == j.spacing
        for dx, n in ((2.042, 7), (4.0, 0), (8.0, 100)):
            td, jd = t.distances(dx, n), j.distances(dx, n)
            assert td.dtype == jd.dtype and np.array_equal(td, jd)
    for mod in (tconfig, jconfig):
        with pytest.raises(ValueError, match="below the spatial sampling"):
            mod.ChannelSelection.from_meters(0.0, 100.0, 1.0, 2.042)
    for fs, dx, nx, ns in ((200.0, 2.042, 22050, 12000), (1000.0, 1.02, 7, 333)):
        t = tconfig.AcquisitionMetadata(fs=fs, dx=dx, nx=nx, ns=ns)
        j = jconfig.AcquisitionMetadata(fs=fs, dx=dx, nx=nx, ns=ns)
        assert (t.duration, t.cable_span) == (j.duration, j.cable_span)


def test_block_and_time_progress_and_stage_timer_behave_as_jax():
    """``tests/test_utils.py``'s checks on the port: the best-of wall and
    the warm result; ``utils.progress`` passes through; the deprecated
    ``utils.profiling.progress`` warns and keeps ``len()``; with tracing
    on, each measured repeat is a ``timed`` span."""
    from das4whales_tpu.utils import profiling as jprofiling
    from das4whales_tpu_torch import utils
    from das4whales_tpu_torch.telemetry import trace
    from das4whales_tpu_torch.utils import profiling

    dt, result = utils.block_and_time(lambda x: torch.sum(x * x),
                                      torch.arange(1000.0, dtype=torch.float64), repeats=2)
    assert dt >= 0.0
    assert float(result) == float(np.sum(np.arange(1000.0) ** 2))
    dt, result = utils.block_and_time(lambda x, scale: x * scale, torch.ones(3), scale=2.0)
    assert torch.equal(result, torch.full((3,), 2.0))
    trace.enable(clear=True)
    try:
        utils.block_and_time(torch.sum, torch.ones(8), repeats=3)
    finally:
        trace.disable()
    assert [s["name"] for s in trace.take_spans()] == ["timed"] * 3

    assert list(utils.progress(range(5), desc="x")) == [0, 1, 2, 3, 4]
    for mod in (profiling, jprofiling):
        with pytest.warns(DeprecationWarning, match="telemetry.progress.progress"):
            bar = mod.progress(range(3), desc="y", total=3)
        assert len(bar) == 3 and list(bar) == [0, 1, 2]

    timer = utils.StageTimer()
    for name in ("a", "a", "b"):
        with timer.stage(name):
            pass
    assert timer.counts == {"a": 2, "b": 1} and "a" in timer.report()


def _traces(d: Path) -> list:
    return sorted(d.glob("*.pt.trace.json"))


def test_device_trace_writes_a_trace_holding_an_annotate_span(tmp_path, monkeypatch):
    """On the CPU the trace holds the host's activity and the span; a
    body that raises writes nothing; where a card is present and the
    session recorded no CUDA activity it raises and writes nothing."""
    from torch.profiler import ProfilerActivity

    from das4whales_tpu_torch import utils
    from das4whales_tpu_torch.utils import profiling

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py's surface phase traces it")
    monkeypatch.setattr(profiling, "PROFILER_SETTLE_S", 0.0)
    d = tmp_path / "trace"
    with utils.device_trace(str(d)) as got:
        with utils.annotate("surface/cpu"):
            torch.ones(64).sum()
    assert got == str(d) and len(_traces(d)) == 1
    events = json.loads(_traces(d)[0].read_text())["traceEvents"]
    spans = [e for e in events if e.get("name") == "surface/cpu"]
    assert spans and spans[0]["dur"] > 0

    with pytest.raises(ZeroDivisionError):
        with utils.device_trace(str(tmp_path / "raised")):
            1 / 0
    assert not _traces(tmp_path / "raised")

    # a card whose session keeps no CUDA record: the profiler is given the
    # CPU activity only, as if CUPTI had lost every record
    real = torch.profiler.profile
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.profiler, "profile", lambda activities, **kw: real(
        activities=[a for a in activities if a != ProfilerActivity.CUDA], **kw))
    with pytest.raises(RuntimeError, match="no CUDA activity"):
        with utils.device_trace(str(tmp_path / "lost")):
            torch.ones(4).sum()
    assert not _traces(tmp_path / "lost")


def test_probe_backend_counts_devices_in_a_subprocess(monkeypatch):
    from das4whales_tpu_torch.utils import device

    assert device.probe_backend(0.001) == 0
    if not torch.cuda.is_available():
        assert device.probe_backend(60) == 0
    # the count is the last token of the probe's output; anything else is 0
    monkeypatch.setattr(device, "_PROBE_SRC", "print('a banner'); print(3)")
    assert device.probe_backend(60) == 3
    monkeypatch.setattr(device, "_PROBE_SRC", "print('no count')")
    assert device.probe_backend(60) == 0
    monkeypatch.setattr(device, "_PROBE_SRC", "raise SystemExit(1)")
    assert device.probe_backend(60) == 0


NX, NS = 16, 2000


@pytest.fixture(scope="module")
def meta():
    from das4whales_tpu_torch.io.synth import SyntheticScene

    return SyntheticScene(nx=NX, ns=NS).metadata


def test_supports_fused_health_equals_jax_in_the_campaign_configuration(meta):
    """The matched filter and its program fuse the health stats on the
    sparse route in both packages; the other programs do not. Off the
    sparse route the port's ``detect_picks`` still does (it is always the
    sparse route; ROADMAP §3), JAX's does not."""
    from das4whales_tpu.config import AcquisitionMetadata as JMeta
    from das4whales_tpu.models.matched_filter import MatchedFilterDetector as JDet
    from das4whales_tpu.workflows import planner as jplanner
    from das4whales_tpu_torch.models.matched_filter import MatchedFilterDetector
    from das4whales_tpu_torch.workflows import planner

    jmeta = JMeta(**{f: getattr(meta, f) for f in ("fs", "dx", "nx", "ns", "n", "gauge_length",
                                                   "scale_factor")})
    with jax.enable_x64(False):
        jdet = JDet(jmeta, [0, NX, 1], (NX, NS), pick_mode="sparse", mf_engine="fft",
                    fk_engine="fft")
        jscipy = JDet(jmeta, [0, NX, 1], (NX, NS), pick_mode="scipy", mf_engine="fft",
                      fk_engine="fft")
    tdet = MatchedFilterDetector(meta, [0, NX, 1], (NX, NS), pick_mode="sparse", device="cpu")
    tscipy = MatchedFilterDetector.from_design(tdet.design, meta, pick_mode="scipy",
                                               device="cpu")
    assert tdet.supports_fused_health is jdet.supports_fused_health is True
    tprog, jprog = planner.program_for(tdet), jplanner.program_for(jdet)
    assert tprog.supports_fused_health is jprog.supports_fused_health is True
    for name in ("DetectorProgram", "GenericProgram", "SpectroProgram", "GaborProgram",
                 "LearnedProgram"):
        assert getattr(planner, name).supports_fused_health is False
        assert getattr(jplanner, name).supports_fused_health is False
    assert jscipy.supports_fused_health is False
    assert tscipy.supports_fused_health is True
    assert planner.program_for(tscipy).supports_fused_health is True


@pytest.mark.parametrize("family,kw,forced,port_default", [
    ("spectro", {"threshold": 2.0}, {"stft_engine": "rfft"}, "fused"),
    ("gabor", {}, {"gabor_engine": "fft"}, "fft"),
])
def test_batched_facade_engine_labels_equal_jax(meta, family, kw, forced, port_default):
    """On a forced engine, before the detector resolves it and after, the
    facade's label is JAX's; the base facade's is ``"fft"`` in both. At
    the defaults the spectro label is the port's default engine, the
    kernel (``"fused"``, ROADMAP §3), where JAX's is ``"rfft"`` off a
    TPU."""
    from das4whales_tpu.config import AcquisitionMetadata as JMeta
    from das4whales_tpu.parallel import batch as jbatch
    from das4whales_tpu.workflows.campaign import family_detector as jfamily
    from das4whales_tpu_torch.parallel import batch
    from das4whales_tpu_torch.workflows.campaign import family_detector

    assert batch._BatchedFamilyDetector.engine.fget(None) == \
        jbatch._BatchedFamilyDetector.engine.fget(None) == "fft"
    jmeta = JMeta(**{f: getattr(meta, f) for f in ("fs", "dx", "nx", "ns", "n", "gauge_length",
                                                   "scale_factor")})

    def facades(**extra):
        with jax.enable_x64(False):
            jb = jbatch.batched_detector_for(jfamily(family, jmeta, [0, NX, 1], (NX, NS),
                                                     **kw, **extra),
                                             donate=False, trace_shape=(NX, NS))
        tb = batch.batched_detector_for(family_detector(family, meta, [0, NX, 1], (NX, NS),
                                                        device="cpu", **kw, **extra),
                                        trace_shape=(NX, NS))
        return jb, tb

    jb, tb = facades()
    assert tb.engine == port_default
    assert jb.engine == {"spectro": "rfft", "gabor": "fft"}[family]
    jb, tb = facades(**forced)
    assert tb.engine == jb.engine == next(iter(forced.values()))
    jb.det.det.resolve_engine((NX, NS))
    tb.det.det.resolve_engine((NX, NS))
    assert tb.engine == jb.engine == next(iter(forced.values()))


def test_resolve_stft_engine_equals_jax_off_the_card(monkeypatch):
    from das4whales_tpu.ops import spectral as jspectral
    from das4whales_tpu_torch.ops import spectral

    monkeypatch.delenv("DAS4WHALES_STFT_ENGINE", raising=False)
    assert spectral.resolve_stft_engine("auto", device="cpu") == jspectral.resolve_stft_engine()
    assert spectral.resolve_stft_engine() == "fused"   # the card's kernel route
    for engine in ("rfft", "matmul"):
        assert spectral.resolve_stft_engine(engine) == jspectral.resolve_stft_engine(engine)
    monkeypatch.setenv("DAS4WHALES_STFT_ENGINE", "matmul")
    assert spectral.resolve_stft_engine(device="cpu") == jspectral.resolve_stft_engine() \
        == "matmul"
    for mod in (spectral, jspectral):
        with pytest.raises(ValueError, match="unknown stft engine"):
            mod.resolve_stft_engine("nope")


def test_tenant_handle_slab_settles_a_slab_as_the_batched_campaign(tmp_path):
    """``TenantRuntime.handle_slab`` on one slab of two files: both
    ``done``, their picks bitwise ``run_campaign_batched``'s."""
    from das4whales_tpu_torch.io.synth import SyntheticCall, SyntheticScene, write_synthetic_file
    from das4whales_tpu_torch.service import TenantSpec
    from das4whales_tpu_torch.service.ingest import FileReplaySource
    from das4whales_tpu_torch.service.scheduler import TenantRuntime
    from das4whales_tpu_torch.workflows import campaign

    files = [write_synthetic_file(str(tmp_path / f"f{k}.h5"), SyntheticScene(
        nx=NX, ns=NS, dx=8.0, noise_rms=0.05, seed=k,
        calls=[SyntheticCall(t0=3.0 + k, x0_m=40.0, amplitude=2.0)])) for k in range(2)]
    spec = TenantSpec(name="a", files=files, channels=[0, NX, 1], batch=2, bucket="exact")
    tenant = TenantRuntime(spec, str(tmp_path / "a"), device="cpu")
    src = FileReplaySource(tenant.ring, tenant.replay_files(), spec.channels).start()
    src.join(timeout=60)
    tenant.pump()
    assert len(tenant.ready) == 1
    tenant.handle_slab(tenant.ready.popleft())
    assert [(r.path, r.status) for r in tenant.records] == [(f, "done") for f in files]
    ref = campaign.run_campaign_batched(files, [0, NX, 1], str(tmp_path / "ref"), batch=2,
                                        bucket="exact", device="cpu")
    assert [r.status for r in ref.records] == ["done", "done"]
    n_picks = 0
    for got, want in zip(tenant.records, ref.records):
        a, b = campaign.load_picks(got.picks_file), campaign.load_picks(want.picks_file)
        assert a.keys() == b.keys()
        assert all(np.array_equal(a[n], b[n]) for n in a)
        n_picks += sum(v.shape[1] for v in a.values())
    assert n_picks > 0
