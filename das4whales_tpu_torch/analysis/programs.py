"""Program-contract audit for the port: rules R11 and R13 over recorded
programs (the counterpart of ``das4whales_tpu.analysis.programs``).

The JAX package lints the jaxpr and HLO of each compiled program. Eager
PyTorch compiles nothing, so the port's text of a program is the stream
of aten operations of one run of it (:class:`OpRecorder`, a
``TorchDispatchMode`` that keeps each operation's name and its inputs'
and outputs' dtypes and devices, and no tensor). The run recorded is the
memory preflight's own probe of a priced program
(``utils.memory.probe_program(capture_ops=...)``): no program runs
twice for the audit, as JAX's audit costs no extra compile.

The two hand-written kernels launch through ``ctypes``, which a dispatch
mode never sees, and on the CPU their plain versions are ordinary aten
operations. So each kernel call is one entry, ``kernel:fused_picks`` or
``kernel:fused_stft``, on either device, and the recorder does not
descend into the launch or the plain version (``utils.oprecord``); a
program's counted read is one entry ``fetch``. One checked-in snapshot
then holds for the CPU and the card.

* **R11 dtype contract** — no float64/complex128 operation in a program
  whose wire is float32 or int32; bf16 only inside the ``matmul-bf16``
  engine's gated rounding (conversions and views), never in arithmetic;
  plus the AST sibling (:func:`analyze`): the builtin ``dtype=float``/
  ``dtype=complex`` and bf16 casts outside the gate, in ``ops/``.
* **R13 program hygiene** — no host read inside the program other than
  its counted fetch (``aten::_local_scalar_dense``, or a device-to-host
  copy outside a counted read), no float64 transcendental, and a
  per-(bucket, rung, engine) ceiling on dtype conversions (``_to_copy``
  with a dtype change), layout copies (a ``clone`` that makes a
  non-contiguous input contiguous: ``.contiguous()`` after ``permute``/
  ``transpose``) and ``copy_``, gated against ``analysis/contracts.json``
  with JAX's slack policy (:func:`contract_ceiling`).

JAX's host-callback check has no counterpart: an eager program is host
Python throughout; what costs the card is the host read, which R13
names. R12 (donation) has none either (``analysis/rules.py``).

Plus the runtime half: :func:`retrace_guard`, the forensic sibling of
``runtime.max_compiles`` — on a ceiling breach it names WHICH watched
argument's shape, dtype or static value changed.

Stdlib-only at import (like ``rules``/``concurrency``); torch and the
port are imported only to record or to build the canonical variants.
"""

from __future__ import annotations

import ast
import collections
import functools
import json
import os
from dataclasses import dataclass
from typing import Dict, Iterable, List, NamedTuple, Sequence, Tuple

from .rules import BF16_GATED, FLOAT64_DESIGN_ALLOWLIST, Finding, _Imports, _in_scope

__all__ = [
    "CANONICAL_SHAPE", "CANONICAL_VARIANTS", "CONTRACT_OPS", "DEFAULT_CONTRACTS",
    "FAMILY_CANONICAL_SHAPE", "FAMILY_VARIANTS", "OpRecord", "OpRecorder",
    "ProgramArtifact", "RetraceError", "RetraceGuard", "analyze", "audit_canonical",
    "audit_program", "build_contracts", "canonical_artifacts", "canonical_facades",
    "contract_ceiling", "record_artifact", "record_ops",
    "contract_key", "dump_contracts", "kernel_entries", "load_contracts", "op_counts",
    "retrace_guard", "signature_diff",
]

# ---------------------------------------------------------------------------
# R11 — AST half
# ---------------------------------------------------------------------------

#: R11's AST sibling is scoped to the kernel library.
_R11_SCOPE = frozenset({"ops"})

#: ``dtype=float`` / ``dtype=complex`` resolve to float64/complex128 in
#: numpy and torch alike — the raw-literal spelling R3 misses.
_BUILTIN_F64_DTYPES = {"float": "float64", "complex": "complex128"}


class _ProgramAstPass(ast.NodeVisitor):
    """R11's source-level checks (run from ``rules.analyze_source``)."""

    def __init__(self, path: str, imports: _Imports):
        self.path = path
        self.imports = imports
        self.findings: List[Finding] = []
        self._stack: List[str] = []

    def _symbol(self) -> str:
        return ".".join(self._stack) if self._stack else "<module>"

    def _emit(self, code: str, node: ast.AST, message: str) -> None:
        self.findings.append(Finding(
            rule="R11", code=code, path=self.path,
            line=getattr(node, "lineno", 1), col=getattr(node, "col_offset", 0),
            symbol=self._symbol(), message=message,
        ))

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._stack.append(node.name)
        self.generic_visit(node)
        self._stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def _is_bf16(self, node: ast.AST) -> bool:
        return self.imports.resolve(node) in ("torch.bfloat16", "torch.bfloat")

    def visit_Call(self, node: ast.Call) -> None:
        for kw in node.keywords:
            if (kw.arg == "dtype" and isinstance(kw.value, ast.Name)
                    and kw.value.id in _BUILTIN_F64_DTYPES
                    and not self._allowed(FLOAT64_DESIGN_ALLOWLIST)):
                self._emit(
                    "builtin-f64-dtype", kw.value,
                    f"dtype={kw.value.id} is {_BUILTIN_F64_DTYPES[kw.value.id]} — "
                    "spell the 32-bit dtype explicitly",
                )
        if not self._allowed(BF16_GATED):
            func = node.func
            cast = (isinstance(func, ast.Attribute) and func.attr == "bfloat16"
                    and not node.args)
            cast = cast or (isinstance(func, ast.Attribute) and func.attr in ("to", "type")
                            and any(self._is_bf16(a) for a in node.args))
            cast = cast or any(kw.arg == "dtype" and self._is_bf16(kw.value)
                               for kw in node.keywords)
            if cast:
                self._emit(
                    "bf16-outside-gate", node,
                    "a cast to bfloat16 outside the gated rounding of "
                    "ops/mxu.correlate_taps — the port's bf16 is a float32 "
                    "contraction of bf16-rounded inputs behind the precision gate",
                )
        self.generic_visit(node)

    def _allowed(self, table) -> bool:
        for suffix, fn in table:
            if self.path.endswith(suffix) and (fn == "*" or fn in self._stack):
                return True
        return False


def analyze(tree: ast.Module, path: str, lines: Sequence[str],
            rules: Sequence[str]) -> List[Finding]:
    """R11's AST half, entered from ``rules.analyze_source`` exactly like
    ``concurrency.analyze`` (inline ``allow[]`` filtering happens in the
    caller). The program half is :func:`audit_program`."""
    if "R11" not in rules or not _in_scope(path, _R11_SCOPE):
        return []
    ast_pass = _ProgramAstPass(path, _Imports(tree))
    ast_pass.visit(tree)
    return ast_pass.findings


# ---------------------------------------------------------------------------
# The recorder
# ---------------------------------------------------------------------------


class OpRecord(NamedTuple):
    """One recorded operation: its aten name (``aten::add``; or an
    opaque ``kernel:<name>`` / ``fetch`` entry), its tensor inputs' and
    outputs' dtypes and device types, and ``layout``: a clone that made a
    non-contiguous input contiguous."""

    name: str
    in_dtypes: Tuple[str, ...] = ()
    out_dtypes: Tuple[str, ...] = ()
    in_devices: Tuple[str, ...] = ()
    out_devices: Tuple[str, ...] = ()
    layout: bool = False


@functools.lru_cache(maxsize=None)
def _mode_class():
    from torch.utils._python_dispatch import TorchDispatchMode

    class _RecordingMode(TorchDispatchMode):
        def __init__(self, recorder):
            super().__init__()
            self.recorder = recorder

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if not self.recorder._suspended:
                self.recorder._note(func, args, kwargs, out)
            return out

    return _RecordingMode


@functools.lru_cache(maxsize=None)
def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _tensors(tree, tensor_type) -> list:
    """The tensors of an operation's arguments or outputs: tensors, and
    tensors in lists, tuples and dict values (one level, as aten
    signatures nest them)."""
    out = []
    for x in tree:
        if isinstance(x, tensor_type):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(y for y in x if isinstance(y, tensor_type))
    return out


class OpRecorder:
    """Records the aten operations of the calls it wraps (:meth:`wrap`),
    on the thread that runs them. ``utils.oprecord``'s scopes note one
    entry and suspend recording inside."""

    def __init__(self):
        self._ops: List[OpRecord] = []
        self._suspended = 0

    def enter_scope(self, entry: str) -> None:
        if not self._suspended:
            self._ops.append(OpRecord(entry))
        self._suspended += 1

    def exit_scope(self) -> None:
        self._suspended -= 1

    def _note(self, func, args, kwargs, out) -> None:
        import torch

        ins = _tensors(tuple(args) + tuple(kwargs.values()), torch.Tensor)
        outs = _tensors(out if isinstance(out, (list, tuple)) else (out,), torch.Tensor)
        name = func._schema.name
        layout = (name == "aten::clone" and bool(ins) and bool(outs)
                  and not ins[0].is_contiguous() and outs[0].is_contiguous())
        self._ops.append(OpRecord(
            name, tuple(_dtype_name(t.dtype) for t in ins),
            tuple(_dtype_name(t.dtype) for t in outs),
            tuple(t.device.type for t in ins), tuple(t.device.type for t in outs), layout))

    def wrap(self, run):
        """``run`` recorded: each call's operations are appended."""
        def recorded(*args, **kwargs):
            from ..utils import oprecord

            prev = oprecord.active()
            oprecord.set_active(self)
            try:
                with _mode_class()(self):
                    return run(*args, **kwargs)
            finally:
                oprecord.set_active(prev)

        return recorded

    def records(self) -> Tuple[OpRecord, ...]:
        return tuple(self._ops)


def record_ops(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under a recorder: ``(result, ops)``."""
    rec = OpRecorder()
    out = rec.wrap(fn)(*args, **kwargs)
    return out, rec.records()


# ---------------------------------------------------------------------------
# Recorded programs and their audit
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ProgramArtifact:
    """One recorded program variant: its op stream plus the identity
    labels the contract snapshot keys on."""

    bucket: str                    # costs.bucket_label spelling, "CxN/dtype"
    label: str                     # rung label, e.g. "batched:1"
    engine: str                    # the contract engine, e.g. "fft+matmul", "learned-fused"
    wire_dtype: str                # the slab dtype the program ingests
    ops: Tuple[OpRecord, ...] = ()
    peak_bytes: int = 0            # the probe's measured peak (0 off the card)
    device: str = "cpu"

    @property
    def key(self) -> str:
        return contract_key(self.bucket, self.label, self.engine)


#: the op-count families the R13 contract snapshot pins: each is pure
#: data movement or dtype churn.
CONTRACT_OPS: Tuple[str, ...] = ("convert", "layout_copy", "copy_")

#: operations that may carry a bf16 tensor inside the gated engine: the
#: rounding conversions and views between them. Anything else (an add, a
#: convolution) means bf16 escaped the gate into arithmetic.
_BF16_ALLOWED_OPS = frozenset({
    "aten::_to_copy", "aten::copy_", "aten::clone", "aten::empty", "aten::empty_strided",
    "aten::view", "aten::_unsafe_view", "aten::reshape", "aten::unsqueeze",
    "aten::squeeze", "aten::expand", "aten::slice", "aten::select", "aten::permute",
    "aten::transpose", "aten::t", "aten::as_strided", "aten::alias", "aten::detach",
})

#: transcendentals R13 names individually at float64.
_TRANSCENDENTALS = frozenset(f"aten::{n}" for n in (
    "atan2", "cos", "sin", "tan", "exp", "expm1", "log", "log1p", "log2", "log10", "pow",
    "rsqrt", "sqrt", "tanh", "sigmoid", "erf", "erfc", "acos", "asin", "atan",
))

_F64 = frozenset({"float64", "complex128"})

#: opaque entries (not operations)
_OPAQUE_PREFIXES = ("kernel:", "fetch")


def _is_op(r: OpRecord) -> bool:
    return not r.name.startswith(_OPAQUE_PREFIXES)


def _host_read(r: OpRecord) -> bool:
    if r.name == "aten::_local_scalar_dense":
        return True
    return (r.name in ("aten::_to_copy", "aten::copy_") and "cuda" in r.in_devices
            and "cpu" in r.out_devices)


def op_counts(ops: Sequence[OpRecord]) -> Dict[str, int]:
    """The snapshot's counts: dtype conversions, layout copies, ``copy_``."""
    return {
        "convert": sum(1 for r in ops if r.name == "aten::_to_copy"
                       and r.in_dtypes[:1] != r.out_dtypes[:1]),
        "layout_copy": sum(1 for r in ops if r.layout),
        "copy_": sum(1 for r in ops if r.name == "aten::copy_"),
    }


def kernel_entries(ops: Sequence[OpRecord]) -> Dict[str, int]:
    """``{kernel name: entries}`` of a recorded stream."""
    c = collections.Counter(r.name.split(":", 1)[1] for r in ops
                            if r.name.startswith("kernel:"))
    return dict(sorted(c.items()))


def _program_finding(art: ProgramArtifact, rule: str, code: str, message: str) -> Finding:
    return Finding(rule=rule, code=code, path=f"program:{art.bucket}", line=0, col=0,
                   symbol=f"{art.label}|{art.engine}", message=message)


def audit_program(art: ProgramArtifact, *, snapshot: Dict | None = None,
                  rules: Sequence[str] = ("R11", "R13")) -> List[Finding]:
    """Audit one recorded program against the R11/R13 contracts. Pure
    analysis of the recorded stream — no program runs. Findings carry
    ``path="program:<bucket>"`` / ``symbol="<rung>|<engine>"`` so
    ``baseline.toml`` entries compose as they do for source findings."""
    findings: List[Finding] = []
    ops = [r for r in art.ops if _is_op(r)]
    f64_wire = art.wire_dtype in _F64

    if "R11" in rules:
        if not f64_wire:
            wide = collections.Counter(r.name for r in ops
                                       if _F64 & set(r.in_dtypes + r.out_dtypes))
            if wide:
                findings.append(_program_finding(
                    art, "R11", "f64-in-program",
                    f"{sum(wide.values())} float64/complex128 operation(s) "
                    f"{sorted(wide)} in a {art.wire_dtype}-wire program — a host "
                    "float or literal promoted a device stage to double",
                ))
        bf16 = collections.Counter(r.name for r in ops
                                   if "bfloat16" in r.in_dtypes + r.out_dtypes)
        mf_engine = art.engine.split("+", 1)[0]
        if bf16 and mf_engine != "matmul-bf16":
            findings.append(_program_finding(
                art, "R11", "bf16-outside-gate",
                f"bf16 operations {sorted(bf16)} in a {mf_engine}-engine program — "
                "bf16 is licensed only inside the gated matmul engine "
                "(ops.mxu.bf16_correlate_gate)",
            ))
        else:
            escaped = sorted(set(bf16) - _BF16_ALLOWED_OPS)
            if escaped:
                findings.append(_program_finding(
                    art, "R11", "bf16-escaped-matmul",
                    f"bf16 {escaped} outside the rounding of the contraction's "
                    "inputs — arithmetic is running at bf16 precision, not just "
                    "the gated matmul's inputs",
                ))

    if "R13" in rules:
        reads = collections.Counter(r.name for r in ops if _host_read(r))
        if reads:
            findings.append(_program_finding(
                art, "R13", "host-read-in-program",
                f"{sum(reads.values())} host read(s) {sorted(reads)} inside the "
                "program outside its counted fetch — each waits for the card "
                "mid-program; read once, through parallel.dispatch's counted "
                "helpers",
            ))
        if not f64_wire:
            slow = sorted({r.name for r in ops if r.name in _TRANSCENDENTALS
                           and _F64 & set(r.in_dtypes + r.out_dtypes)})
            if slow:
                findings.append(_program_finding(
                    art, "R13", "f64-transcendental",
                    f"float64 transcendental(s) {slow} in a {art.wire_dtype}-wire "
                    "program — a fraction of the float32 rate on the card",
                ))
        if snapshot is not None:
            entry = (snapshot.get("programs") or {}).get(art.key)
            if entry is not None:
                counts = op_counts(ops)
                over = {op: (counts[op], contract_ceiling(int(entry.get(op, 0))))
                        for op in CONTRACT_OPS
                        if counts[op] > contract_ceiling(int(entry.get(op, 0)))}
                if over:
                    detail = ", ".join(
                        f"{op}: {n} > ceiling {c} (snapshot {entry.get(op, 0)})"
                        for op, (n, c) in sorted(over.items()))
                    findings.append(_program_finding(
                        art, "R13", "op-ceiling-exceeded",
                        f"data-movement op count above the contract snapshot "
                        f"({detail}) — a dtype or layout churn regression; "
                        "regenerate with --write-contracts only after triage",
                    ))
    return findings


# ---------------------------------------------------------------------------
# The contract snapshot (analysis/contracts.json, checked in)
# ---------------------------------------------------------------------------

DEFAULT_CONTRACTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "contracts.json")


def contract_key(bucket: str, label: str, engine: str) -> str:
    return f"{bucket}|{label}|{engine}"


def contract_ceiling(snapshot_count: int) -> int:
    """Allowed live count for a snapshotted op count: raw count plus
    slack (max(4, 50%)), JAX's policy — the snapshot stores raw counts so
    regeneration is deterministic."""
    return snapshot_count + max(4, snapshot_count // 2)


def load_contracts(path: str | None = None) -> Dict | None:
    """The checked-in snapshot, or None when absent/unreadable (an absent
    snapshot disables only the op-ceiling check)."""
    try:
        with open(path or DEFAULT_CONTRACTS, "r", encoding="utf-8") as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return None


def build_contracts(artifacts: Iterable[ProgramArtifact], *, torch_version: str = "",
                    device: str = "") -> Dict:
    """The snapshot payload from recorded artifacts: raw CONTRACT_OPS
    counts per program key plus provenance (the device and torch that
    recorded them)."""
    return {
        "version": 1,
        "device": device,
        "torch": torch_version,
        "ops": list(CONTRACT_OPS),
        "programs": {a.key: op_counts(a.ops) for a in sorted(artifacts, key=lambda a: a.key)},
    }


def dump_contracts(snapshot: Dict) -> str:
    return json.dumps(snapshot, indent=1, sort_keys=True) + "\n"


# ---------------------------------------------------------------------------
# Canonical variants: the (family, rung, engine) set the gate audits
# ---------------------------------------------------------------------------

#: the canonical audit scene of the matched filter (JAX's)
CANONICAL_SHAPE = (24, 900)

#: (mf_engine, fk_engine) pairs covering every engine of the matched
#: filter: the FFT route, both matmul routes, the bf16 route whose
#: rounding R11 checks, and the tap-folded route (JAX's five).
CANONICAL_VARIANTS: Tuple[Tuple[str, str], ...] = (
    ("fft", "fft"), ("matmul", "fft"), ("matmul-bf16", "fft"),
    ("matmul-fused", "fft"), ("fft", "matmul"),
)

#: the family facades' canonical scene (JAX's): long enough for the
#: spectral windowing of all three families' default designs.
FAMILY_CANONICAL_SHAPE = (16, 2000)

#: the non-mf detector families, one artifact each.
FAMILY_VARIANTS: Tuple[str, ...] = ("spectro", "gabor", "learned")


def canonical_facades(wire: str = "float32",
                      variants: Sequence[Tuple[str, str]] = CANONICAL_VARIANTS,
                      families: Sequence[str] = FAMILY_VARIANTS,
                      device=None) -> List[Tuple[object, str]]:
    """The canonical variants' batched facades and their bucket labels:
    the matched filter at ``CANONICAL_SHAPE`` per engine pair, then one
    facade per non-mf family at ``FAMILY_CANONICAL_SHAPE``. Building them
    runs the engines' precision gates (``ops.mxu``); recording them is
    :func:`record_artifact`. ``device`` None is the card (raises without
    one: never a silent CPU run)."""
    import numpy as np

    from ..io.synth import SyntheticScene
    from ..models.matched_filter import MatchedFilterDetector
    from ..parallel.batch import BatchedMatchedFilterDetector, batched_detector_for
    from ..telemetry.costs import bucket_label
    from ..utils.device import resolve_device
    from ..workflows.campaign import family_detector

    dev = resolve_device(device)
    dtype = np.dtype(wire).name
    nx, ns = CANONICAL_SHAPE
    md = SyntheticScene(nx=nx, ns=ns).metadata
    out = []
    for mf_engine, fk_engine in variants:
        det = MatchedFilterDetector(md, [0, nx, 1], (nx, ns), pick_mode="sparse",
                                    keep_correlograms=False, mf_engine=mf_engine,
                                    fk_engine=fk_engine, device=dev)
        out.append((BatchedMatchedFilterDetector(det, donate=False),
                    bucket_label((nx, ns, dtype))))
    fnx, fns = FAMILY_CANONICAL_SHAPE
    fmd = SyntheticScene(nx=fnx, ns=fns).metadata
    for family in families:
        det = family_detector(family, fmd, [0, fnx, 1], (fnx, fns), device=dev)
        out.append((batched_detector_for(det, donate=False, trace_shape=(fnx, fns)),
                    bucket_label((fnx, fns, dtype))))
    return out


def record_artifact(bdet, bucket: str, batch: int = 1, wire: str = "float32") -> ProgramArtifact:
    """Record one facade's batched program through the memory preflight's
    probe (``utils.memory``: on the card the probe's own run, on the CPU
    one recording run; a probe memoized with its recording is reused)."""
    import numpy as np

    from ..telemetry.costs import contract_engine
    from ..utils import memory as memutils

    dtype = np.dtype(wire)
    an = memutils.batched_program_analysis(bdet, batch, dtype, capture_ops=True)
    dev = getattr(bdet.det, "device", None) or getattr(getattr(bdet.det, "det", None),
                                                        "device", "cpu")
    return ProgramArtifact(
        bucket=bucket, label=f"batched:{batch}", engine=contract_engine(bdet),
        wire_dtype=dtype.name, ops=an.ops or (),
        peak_bytes=int(an.memory.peak if an.memory else 0),
        device=str(getattr(dev, "type", dev)))


def canonical_artifacts(batch: int = 1, wire: str = "float32",
                        variants: Sequence[Tuple[str, str]] = CANONICAL_VARIANTS,
                        families: Sequence[str] = FAMILY_VARIANTS,
                        device=None) -> List[ProgramArtifact]:
    """Record (once each) the canonical program variants
    (:func:`canonical_facades`, :func:`record_artifact`): what the CLI,
    the tier-1 gate and the card's smoke audit."""
    return [record_artifact(bdet, bucket, batch, wire)
            for bdet, bucket in canonical_facades(wire, variants, families, device)]


def audit_canonical(rules: Sequence[str] = ("R11", "R13"), *,
                    contracts_path: str | None = None,
                    artifacts: Sequence[ProgramArtifact] | None = None,
                    device=None) -> List[Finding]:
    """The command line's and the tests' program audit: audit the canonical variant
    set (or pre-recorded ``artifacts``) against the checked-in
    snapshot."""
    snapshot = load_contracts(contracts_path)
    arts = canonical_artifacts(device=device) if artifacts is None else artifacts
    findings: List[Finding] = []
    for art in arts:
        findings += audit_program(art, snapshot=snapshot, rules=rules)
    return findings


# ---------------------------------------------------------------------------
# Retrace forensics: WHICH argument signature changed
# ---------------------------------------------------------------------------


class RetraceError(AssertionError):
    """A watched region probed or built past its ceiling; the message
    names the argument signature diffs that provoked each one."""


def _arg_signature(x) -> Tuple:
    """Stable signature of one call argument in the terms that key a
    probe: tensors and arrays by (shape, dtype, device); everything else
    (batch sizes, dtypes, modes) by hash, falling back to identity for
    unhashables."""
    if hasattr(x, "shape") and hasattr(x, "dtype") and not isinstance(x, type):
        dev = getattr(x, "device", "cpu")
        return ("array", tuple(int(s) for s in x.shape), str(x.dtype),
                str(getattr(dev, "type", dev)))
    try:
        return ("static", type(x).__name__, hash(x))
    except TypeError:
        return ("static", type(x).__name__, f"unhashable@{id(x):#x}")


def _describe(sig: Tuple) -> str:
    if sig[0] == "array":
        _, shape, dtype, dev = sig
        return f"{dtype}{list(shape)} on {dev}"
    return f"static {sig[1]} hash={sig[2]}"


def signature_diff(prev: Dict[str, Tuple], cur: Dict[str, Tuple]) -> List[str]:
    """Human-readable per-argument diff between two call signatures —
    the forensic payload of :class:`RetraceError`."""
    lines: List[str] = []
    for name in sorted(set(prev) | set(cur)):
        a, b = prev.get(name), cur.get(name)
        if a == b:
            continue
        if a is None:
            lines.append(f"{name}: new argument ({_describe(b)})")
        elif b is None:
            lines.append(f"{name}: argument removed (was {_describe(a)})")
        elif a[0] == "array" and b[0] == "array":
            parts = []
            if a[1] != b[1]:
                parts.append(f"shape {list(a[1])} -> {list(b[1])}")
            if a[2] != b[2]:
                parts.append(f"dtype {a[2]} -> {b[2]}")
            if a[3] != b[3]:
                parts.append(f"device {a[3]} -> {b[3]}")
            lines.append(f"{name}: " + ", ".join(parts))
        elif a[0] == "static" and b[0] == "static":
            lines.append(f"{name}: static value changed "
                         f"({a[1]} hash {a[2]} -> {b[1]} hash {b[2]})")
        else:
            lines.append(f"{name}: {_describe(a)} -> {_describe(b)}")
    return lines


class _Watched:
    """Callable wrapper recording per-call argument signatures and the
    probes and builds each call triggered."""

    def __init__(self, guard: "RetraceGuard", fn, what: str):
        self._guard = guard
        self._fn = fn
        self.what = what

    def __call__(self, *args, **kwargs):
        from . import runtime

        sig = {f"arg[{i}]": _arg_signature(a) for i, a in enumerate(args)}
        sig.update({f"kwarg[{k}]": _arg_signature(v) for k, v in sorted(kwargs.items())})
        before = runtime.compile_count()
        out = self._fn(*args, **kwargs)
        self._guard._note(self.what, sig, runtime.compile_count() - before)
        return out


class RetraceGuard:
    """Context manager: ``with retrace_guard(1, what="detect") as g:``
    then call ``g.watch(fn)(...)`` wrappers inside the block. On exit,
    more than ``ceiling`` probes and builds raise :class:`RetraceError`
    whose message carries the signature diff of every probing watched
    call after its first."""

    def __init__(self, ceiling: int, what: str = "guarded region"):
        self.ceiling = int(ceiling)
        self.what = what
        self.forensics: List[Tuple[str, List[str]]] = []
        self._last: Dict[str, Dict[str, Tuple]] = {}
        self._start = 0

    def watch(self, fn, what: str | None = None) -> _Watched:
        return _Watched(self, fn, what or getattr(fn, "__name__", self.what))

    def _note(self, what: str, sig: Dict[str, Tuple], compiled: int) -> None:
        prev = self._last.get(what)
        if compiled and prev is not None:
            diff = signature_diff(prev, sig) or [
                "no watched argument changed — the probe came from inside (a "
                "fresh program key per call, or an unwatched closure input)"]
            self.forensics.append((what, diff))
        self._last[what] = sig

    def __enter__(self) -> "RetraceGuard":
        from . import runtime

        self._start = runtime.compile_count()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            return
        from . import runtime

        compiled = runtime.compile_count() - self._start
        if compiled <= self.ceiling:
            return
        report = "\n".join(
            f"  {what}: " + "; ".join(diff) for what, diff in self.forensics
        ) or "  (no watched call probed twice — the probes came from unwatched code)"
        raise RetraceError(
            f"{self.what}: {compiled} probes and kernel builds, ceiling "
            f"{self.ceiling} — argument signature changes:\n{report}"
        )


def retrace_guard(ceiling: int, what: str = "guarded region") -> RetraceGuard:
    """Factory form matching ``runtime.max_compiles``'s signature (the
    ``torch_retrace_guard`` pytest fixture returns this function)."""
    return RetraceGuard(ceiling, what=what)
