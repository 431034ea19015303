"""daslint rule engine for the port: AST hazard analysis of eager
PyTorch on a card (the counterpart of ``das4whales_tpu.analysis.rules``).

The port's speed rests on the invariants the JAX package's analyzer
guards, read for eager PyTorch: work stays on the card between a
program's dispatch and its one counted read (no host syncs), the device
path stays in the intended dtype (no float64 past the host-side design
stage), a wall is taken after a sync, and durable state goes through the
one crash-only write layer. Each rule below is a static check over the
Python AST.

Rule catalog:

R1  host syncs — ``.item()``/``.tolist()``/``.cpu()``/``.numpy()``,
    ``float()``/``int()``/``bool()`` of a tensor, and
    ``torch.cuda.synchronize()``, in the device-path packages (``ops/``,
    ``parallel/``, ``models/``). A value is a tensor when it reaches one
    of the function's tensor parameters (annotated ``torch.Tensor``,
    plain or optional); ``.shape``/``.dtype``/``.ndim`` reads and
    ``len()`` are Python metadata and cut the taint, as in JAX.
R3  float64 drift — ``torch.float64``/``torch.double``/
    ``torch.complex128``/``torch.cdouble`` and ``.double()`` anywhere in
    ``ops/``, ``parallel/``, ``models/``, plus the numpy spellings the JAX
    rule catches (``np.float64``/``np.double``/``dtype="float64"`` fed to
    a numpy call). Host-side filter design in float64 is the documented
    contract of ``ops/fk.py`` and ``ops/filters.py`` and stays allowed
    (:data:`FLOAT64_DESIGN_ALLOWLIST`).
R6  sync-in-loop — R1's syncs (``.item()``, ``.tolist()``, ``.cpu()``,
    ``.numpy()``, ``torch.cuda.synchronize()``; a cast where R1 sees that
    it reads a tensor) and ``np.asarray``/
    ``np.array`` of a freshly computed call result inside a ``for``/
    ``while`` body in ``ops/``, ``parallel/``, ``models/``,
    ``workflows/`` and ``io/``: one per iteration serializes the
    dispatch pipeline (``parallel.dispatch`` exists so hot loops never
    need one). Intentional drain points are baselined with a reason.
R7  unblocked timing — a ``time.perf_counter()`` bracket around a
    launch-suspect call with no sync between the two clock reads. CUDA
    launches are asynchronous: such a wall times the launch, not the
    work. Syncs: ``torch.cuda.synchronize``, an event's
    ``synchronize``/``elapsed_time``, ``.item()``, ``.cpu()``, the
    counted ``fetch``/``sync``/``resolve`` of ``parallel/dispatch.py``,
    ``np.asarray`` of a result. ``telemetry/`` is out of scope (its
    timing helpers are the blessed definitions).
R8–R10 concurrency — shared state, lock order, thread hygiene over the
    thread-spawning modules (``analysis/concurrency.py``).
R11 dtype contract, AST half (``analysis/programs.py``): the builtin
    ``dtype=float``/``dtype=complex`` in ``ops/``, and a cast to bfloat16
    (``.bfloat16()``, ``.to(torch.bfloat16)``, ``dtype=torch.bfloat16``)
    in ``ops/`` outside the gated rounding of ``ops/mxu.py``
    (``correlate_taps``: the port's bf16 is a float32 contraction of
    bf16-rounded inputs). The program half audits recorded runs.
R13 program hygiene — program audit only (``analysis/programs.py``):
    host reads outside the counted fetch, float64 transcendentals, and
    dtype conversions / layout copies / ``copy_`` under the ceilings of
    ``analysis/contracts.json``.
R14 non-durable artifact write — a direct ``open(.., "w"/"a")`` or
    ``np.savez``/``np.save`` on an artifact-suffixed path literal
    (``.json``/``.jsonl``/``.npz``) outside ``utils/artifacts.py``.
R15 unbounded subprocess wait — ``Popen.wait()`` with no timeout, or
    ``.communicate()`` without ``timeout=`` (the fleet supervisor must
    never hang on a wedged worker).

No counterpart, by design:

R2  (retrace hazards) reads ``jax.jit`` construction and static argument
    specs; eager PyTorch traces nothing, so there is nothing to retrace.
    What is done once per shape here — a priced program's cold probe and
    a kernel library's build — is counted at run time instead
    (``analysis/runtime.py``).
R4  (numpy calls on tracers) needs a tracer: an eager tensor is
    concrete, and the one way numpy reaches a CUDA tensor is through a
    host read, which R1 and R6 already catch.
R5  (donation audit) and R12 (donation effectiveness) audit
    ``donate_argnums`` and XLA's input/output aliasing; eager PyTorch
    donates nothing (a slab's storage is freed when its last reference
    goes, ``parallel/batch.py``), so neither has a meaning.

Suppression: an inline ``# daslint: allow[R1]`` (comma list, or
``daslint: ignore`` for all rules) on the finding's line or standalone
on the line above suppresses it at the source; ``baseline.toml``
suppresses known findings without touching the code.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import PurePosixPath
from typing import Iterable, List, Optional, Sequence, Set, Tuple

#: The package the canonical paths anchor at.
PACKAGE = "das4whales_tpu_torch"

ALL_RULES = ("R1", "R3", "R6", "R7", "R8", "R9", "R10", "R11", "R13", "R14", "R15")

#: rules whose primary half runs over recorded programs rather than
#: source text (R11 also has the AST sibling below; R13 is program-only).
PROGRAM_RULES = ("R11", "R13")

#: (path suffix, function name or "*") pairs where explicit float64 is the
#: documented host-side design contract (masks and filter coefficients are
#: designed in float64 numpy once, applied on the card in the data dtype).
FLOAT64_DESIGN_ALLOWLIST: Tuple[Tuple[str, str], ...] = (
    (f"{PACKAGE}/ops/fk.py", "*"),
    (f"{PACKAGE}/ops/filters.py", "*"),
)

#: R11: (path suffix, function) pairs where a bf16 cast is the gated
#: rounding of the ``"matmul-bf16"`` engine.
BF16_GATED: Tuple[Tuple[str, str], ...] = (
    (f"{PACKAGE}/ops/mxu.py", "correlate_taps"),
)

#: R14: file suffixes that mark a path literal as a durable artifact,
#: the open() modes that mutate one, and the files exempt from the rule
#: (the durable-write layer itself is where the raw idiom must live).
_ARTIFACT_SUFFIXES = (".json", ".jsonl", ".npz")
_ARTIFACT_WRITE_MODES = frozenset({
    "w", "a", "x", "wt", "at", "xt", "wb", "ab", "xb",
    "w+", "a+", "x+", "w+b", "a+b", "wb+", "ab+",
})
_R14_EXEMPT_SUFFIXES = (f"{PACKAGE}/utils/artifacts.py",)

#: R15: receiver names that read as a child process.
_R15_PROC_RECEIVER = re.compile(r"(proc|popen|child|worker)", re.I)

#: Attribute reads that yield Python metadata, not device values.
_STATIC_ATTRS = frozenset({"shape", "ndim", "dtype", "size", "itemsize", "device",
                           "is_cuda", "layout"})

#: Tensor methods that return Python metadata, not device values.
_STATIC_METHODS = frozenset({"numel", "dim", "size", "stride", "element_size",
                             "nelement", "is_contiguous", "data_ptr", "get_device"})

#: Builtin casts that read a tensor's value on the host.
_SYNC_CASTS = frozenset({"float", "int", "bool", "complex"})

#: Tensor methods that wait for the card and read its value on the host.
_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})

#: Dotted calls that wait for the whole card.
_SYNC_DOTTED = frozenset({"torch.cuda.synchronize"})

#: Path components of the device-path packages (R1, R3).
_DEVICE_SCOPE = frozenset({"ops", "parallel", "models"})

#: Path components scoped for the R6 sync-in-loop audit (host code that
#: runs device programs; viz/analysis/eval host-only code is exempt).
_R6_SCOPE = frozenset({"ops", "parallel", "models", "workflows", "io"})

#: R7 shares R6's scope; ``telemetry/`` is outside it.
_R7_SCOPE = _R6_SCOPE

#: dotted calls that make a perf_counter bracket honest.
_R7_SYNC_DOTTED = frozenset({"torch.cuda.synchronize", "numpy.asarray", "numpy.array"})

#: final-attribute calls treated as syncs for R7: the counted dispatch
#: helpers (``fetch``/``sync``), an in-flight handle's ``resolve``, a
#: future's ``result``, a CUDA event's ``synchronize``/``elapsed_time``
#: and the tensor reads.
_R7_SYNC_ATTRS = frozenset({
    "fetch", "sync", "resolve", "result", "synchronize", "elapsed_time",
    "item", "cpu", "tolist", "numpy",
})

#: bare-name calls that are plain host work, never a launch.
_R7_HOST_CALLS = frozenset({
    "len", "min", "max", "round", "abs", "sum", "int", "float", "str",
    "bool", "repr", "format", "sorted", "list", "dict", "tuple", "set",
    "print", "isinstance", "getattr", "setattr", "hasattr", "range",
    "enumerate", "zip", "map", "filter", "any", "all", "type", "id",
})

#: torch's double-width dtypes (R3).
_TORCH_F64 = frozenset({"torch.float64", "torch.double", "torch.complex128",
                        "torch.cdouble"})

_ALLOW_RE = re.compile(r"daslint:\s*(?:allow\[([A-Za-z0-9,\s]+)\]|ignore)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One hazard at one source location."""

    rule: str      # "R1".."R15"
    code: str      # stable slug, e.g. "host-sync-cast"
    path: str      # canonical repo-relative posix path
    line: int      # 1-indexed
    col: int       # 0-indexed
    symbol: str    # enclosing function chain ("a.b") or "<module>"
    message: str

    def key(self) -> Tuple[str, str, str]:
        """Baseline identity: stable across line-number churn."""
        return (self.rule, self.path, self.symbol)

    def format(self) -> str:
        return (f"{self.path}:{self.line}:{self.col + 1}: "
                f"{self.rule}[{self.code}] {self.message} (in {self.symbol})")


def canonical_path(path: str) -> str:
    """Normalize to a repo-anchored posix path: everything from the LAST
    ``das4whales_tpu_torch`` component on, so baseline entries match
    whatever directory the analyzer was invoked from (the JAX package's
    analyzer anchors at ``das4whales_tpu``: a port path anchored there
    would miss every scope)."""
    parts = PurePosixPath(str(path).replace("\\", "/")).parts
    for i in range(len(parts) - 1, -1, -1):
        if parts[i] == PACKAGE:
            return str(PurePosixPath(*parts[i:]))
    return str(PurePosixPath(*parts))


def line_allowed(lines: Sequence[str], f: Finding) -> bool:
    """Inline suppression: ``# daslint: allow[R1,...]`` / ``daslint:
    ignore`` on the finding's line, or standalone on the line above."""
    for ln in (f.line, f.line - 1):
        if not 1 <= ln <= len(lines):
            continue
        text = lines[ln - 1]
        if ln != f.line and not text.lstrip().startswith("#"):
            # a trailing allow comment licenses ONLY its own line
            continue
        m = _ALLOW_RE.search(text)
        if m:
            if m.group(1) is None:  # daslint: ignore
                return True
            allowed = {r.strip().upper() for r in m.group(1).split(",")}
            if f.rule in allowed:
                return True
    return False


def _in_scope(path: str, scope: frozenset) -> bool:
    return any(part in scope for part in PurePosixPath(path).parts[:-1])


class _Imports:
    """Alias resolution: maps local names to dotted module paths so the
    rules recognize ``np``/``torch``/``F`` however the file spelled its
    imports."""

    def __init__(self, tree: ast.AST):
        self.modules = {}   # local name -> dotted module ("np" -> "numpy")
        self.names = {}     # local name -> dotted object ("perf_counter" -> "time.perf_counter")
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.modules[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0]
                    )
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                for a in node.names:
                    self.names[a.asname or a.name] = f"{node.module}.{a.name}"

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Dotted path of a Name/Attribute chain, aliases applied."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        head = node.id
        if head in self.names:
            base = self.names[head]
        elif head in self.modules:
            base = self.modules[head]
        else:
            base = head
        return ".".join([base] + list(reversed(parts)))


def _is_tensor_annotation(ann: Optional[ast.AST]) -> bool:
    """An annotation that names ``Tensor`` (``torch.Tensor``,
    ``Optional[torch.Tensor]``, ``"torch.Tensor"``, ``Tensor | None``)."""
    if ann is None:
        return False
    for sub in ast.walk(ann):
        if isinstance(sub, ast.Attribute) and sub.attr == "Tensor":
            return True
        if isinstance(sub, ast.Name) and sub.id == "Tensor":
            return True
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str) \
                and re.search(r"\bTensor\b", sub.value):
            return True
    return False


def _tensor_params(fn: ast.FunctionDef) -> Set[str]:
    args = fn.args
    every = args.posonlyargs + args.args + args.kwonlyargs
    if args.vararg is not None:
        every = every + [args.vararg]
    return {a.arg for a in every if _is_tensor_annotation(a.annotation)}


def _expr_tainted(node: ast.AST, taint: Set[str]) -> bool:
    """Does this expression reach a tensor? Shape/dtype reads and
    ``len()`` yield Python metadata and cut the taint."""
    if isinstance(node, ast.Name):
        return node.id in taint
    if isinstance(node, ast.Attribute):
        if node.attr in _STATIC_ATTRS:
            return False
        return _expr_tainted(node.value, taint)
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Name) and node.func.id in _SYNC_CASTS | {"len"}:
            return False   # a host value (the cast itself is the hazard)
        if isinstance(node.func, ast.Attribute) and node.func.attr in _SYNC_METHODS:
            return False   # host data from here on
        if isinstance(node.func, ast.Attribute) and node.func.attr in _STATIC_METHODS:
            return False
        return any(_expr_tainted(a, taint) for a in node.args) or any(
            _expr_tainted(kw.value, taint) for kw in node.keywords
        ) or _expr_tainted(node.func, taint)
    if isinstance(node, ast.Constant):
        return False
    return any(_expr_tainted(c, taint) for c in ast.iter_child_nodes(node))


def _chained_read(node: ast.AST) -> bool:
    """Is ``node`` itself a host read (``x.cpu()`` in ``x.cpu().numpy()``)?
    The chain is one hazard, reported once, at its first read."""
    return (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr in _SYNC_METHODS)


def _numpy_float64_nodes(imports: _Imports, node: ast.AST):
    """Sub-nodes that reference float64 the numpy way: ``np.float64`` /
    ``np.double`` attributes, and the string ``"float64"`` passed as a
    dtype keyword (JAX's rule, unchanged)."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr in ("float64", "double"):
            if imports.resolve(sub) in ("numpy.float64", "numpy.double"):
                yield sub
        elif isinstance(sub, ast.keyword) and sub.arg == "dtype":
            v = sub.value
            if isinstance(v, ast.Constant) and v.value == "float64":
                yield v


def _enclosing_fn(fn_spans, line: int) -> str:
    best, best_span = "<module>", None
    for start, end, name in fn_spans:
        if start <= line <= end and (best_span is None or end - start < best_span):
            best, best_span = name, end - start
    return best


class _Analyzer(ast.NodeVisitor):
    def __init__(self, path: str, source_lines: Sequence[str],
                 rules: Sequence[str]):
        self.path = path
        self.lines = source_lines
        self.rules = set(rules)
        self.findings: List[Finding] = []
        self.imports: _Imports = None  # set in run()
        self._fn_stack: List[ast.FunctionDef] = []
        self._loop_depth = 0
        # the enclosing functions' tensor names, innermost last (R1), and
        # the loop depth of R1's statement walk (its casts in loops are R6's)
        self._taint_stack: List[Set[str]] = []
        self._r1_loop = 0

    # -- plumbing ----------------------------------------------------------

    def run(self, tree: ast.AST) -> List[Finding]:
        self.imports = _Imports(tree)
        self.visit(tree)
        return [f for f in self.findings if not line_allowed(self.lines, f)]

    def _symbol(self) -> str:
        return ".".join(f.name for f in self._fn_stack) or "<module>"

    def _emit(self, rule: str, code: str, node: ast.AST, message: str,
              symbol: Optional[str] = None):
        if rule in self.rules:
            self.findings.append(Finding(
                rule=rule, code=code, path=self.path,
                line=getattr(node, "lineno", 1),
                col=getattr(node, "col_offset", 0),
                symbol=symbol or self._symbol(), message=message,
            ))

    # -- structure ---------------------------------------------------------

    def visit_FunctionDef(self, node: ast.FunctionDef):
        self._fn_stack.append(node)
        self._check_unblocked_timing(node)
        r1 = bool({"R1", "R6"} & self.rules) and _in_scope(self.path, _DEVICE_SCOPE)
        if r1:
            inherited = self._taint_stack[-1] if self._taint_stack else set()
            taint = set(inherited) | _tensor_params(node)
            self._taint_stack.append(taint)
            loop, self._r1_loop = self._r1_loop, 0
            self._walk_r1(node.body, taint)
            self._r1_loop = loop
        loop_depth, self._loop_depth = self._loop_depth, 0
        self.generic_visit(node)
        self._loop_depth = loop_depth
        if r1:
            self._taint_stack.pop()
        self._fn_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_For(self, node):
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    visit_While = visit_For
    visit_AsyncFor = visit_For

    def visit_Call(self, node: ast.Call):
        self._check_sync_in_loop(node)
        self._check_artifact_write(node)
        self._check_subprocess_wait(node)
        self.generic_visit(node)

    def visit_Module(self, node):
        self.generic_visit(node)
        if "R3" in self.rules and _in_scope(self.path, _DEVICE_SCOPE):
            self._float64(node)

    # -- R1 ----------------------------------------------------------------

    def _walk_r1(self, body, taint: Set[str]):
        """Statement-ordered walk of one function's own body with forward
        taint propagation; nested defs are walked when visited."""
        for stmt in body:
            self._r1_statement(stmt, taint)

    def _r1_statement(self, stmt: ast.stmt, taint: Set[str]):
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return
        if isinstance(stmt, ast.Assign):
            self._r1_expr(stmt.value, taint)
            if _expr_tainted(stmt.value, taint):
                for tgt in stmt.targets:
                    for name in ast.walk(tgt):
                        if isinstance(name, ast.Name):
                            taint.add(name.id)
            return
        if isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            if stmt.value is not None:
                self._r1_expr(stmt.value, taint)
                if _expr_tainted(stmt.value, taint):
                    for name in ast.walk(stmt.target):
                        if isinstance(name, ast.Name):
                            taint.add(name.id)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._r1_expr(stmt.iter, taint)
            if _expr_tainted(stmt.iter, taint):
                target = stmt.target
                it = stmt.iter
                if (isinstance(it, ast.Call) and isinstance(it.func, ast.Attribute)
                        and it.func.attr in ("items", "keys") and not it.args):
                    # a mapping of tensors: its keys are not tensors
                    target = (target.elts[1] if it.func.attr == "items"
                              and isinstance(target, ast.Tuple) and len(target.elts) == 2
                              else None)
                for name in ast.walk(target) if target is not None else ():
                    if isinstance(name, ast.Name):
                        taint.add(name.id)
            self._r1_loop += 1
            self._walk_r1(stmt.body, taint)
            self._r1_loop -= 1
            self._walk_r1(stmt.orelse, taint)
            return
        if isinstance(stmt, ast.While):
            self._r1_loop += 1
            self._r1_expr(stmt.test, taint)
            self._walk_r1(stmt.body, taint)
            self._r1_loop -= 1
            self._walk_r1(stmt.orelse, taint)
            return
        if isinstance(stmt, ast.If):
            self._r1_expr(stmt.test, taint)
            self._walk_r1(stmt.body, taint)
            self._walk_r1(stmt.orelse, taint)
            return
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._r1_expr(item.context_expr, taint)
            self._walk_r1(stmt.body, taint)
            return
        if isinstance(stmt, ast.Try):
            self._walk_r1(stmt.body, taint)
            for h in stmt.handlers:
                self._walk_r1(h.body, taint)
            self._walk_r1(stmt.orelse, taint)
            self._walk_r1(stmt.finalbody, taint)
            return
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                self._r1_expr(child, taint)

    def _r1_expr(self, expr: ast.expr, taint: Set[str]):
        for node in ast.walk(expr):
            if isinstance(node, ast.Lambda) or not isinstance(node, ast.Call):
                continue
            func = node.func
            if isinstance(func, ast.Name) and func.id in _SYNC_CASTS:
                if (func.id not in self.imports.names
                        and any(_expr_tainted(a, taint) for a in node.args)):
                    self._emit("R1", "host-sync-cast", node,
                               f"`{func.id}()` of a tensor waits for the card and "
                               "reads the value on the host — keep it a tensor")
                    if self._r1_loop and _in_scope(self.path, _R6_SCOPE):
                        # R6's other syncs need no taint (_check_sync_in_loop);
                        # a cast is one only where R1 knows it reads a tensor
                        self._emit("R6", "cast-in-loop", node,
                                   f"`{func.id}()` of a tensor inside a loop body — a "
                                   "device→host round trip per iteration; read the "
                                   "values once outside the loop")
                continue
            if (isinstance(func, ast.Attribute) and func.attr in _SYNC_METHODS
                    and not _chained_read(func.value)
                    and _expr_tainted(func.value, taint)):
                self._emit("R1", "host-sync-" + ("transfer" if func.attr in ("cpu", "numpy")
                                                 else "item"), node,
                           f"`.{func.attr}()` of a tensor waits for the card and "
                           "copies to the host")
                continue
            if self.imports.resolve(func) in _SYNC_DOTTED:
                self._emit("R1", "host-sync-synchronize", node,
                           "`torch.cuda.synchronize()` on the device path stalls "
                           "the host until every queued launch is done")

    # -- R3 ----------------------------------------------------------------

    def _float64_allowed(self, symbol: str) -> bool:
        return any(self.path.endswith(suffix) and fn in ("*", symbol)
                   for suffix, fn in FLOAT64_DESIGN_ALLOWLIST)

    def _float64(self, tree: ast.Module):
        fn_spans = [(fn.lineno, fn.end_lineno or fn.lineno, fn.name)
                    for fn in ast.walk(tree)
                    if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))]
        seen: Set[int] = set()
        for node in ast.walk(tree):
            hits = []
            if isinstance(node, ast.Call):
                dotted = self.imports.resolve(node.func) or ""
                if dotted.startswith("numpy."):
                    hits = [(n, "float64-host-constant", (
                        "explicit float64 host constant in a device-path package — "
                        "consumers upload it at double width; design in the data "
                        "dtype, or allowlist if this is deliberate float64 filter "
                        "design")) for n in _numpy_float64_nodes(self.imports, node)]
                elif (isinstance(node.func, ast.Attribute)
                      and node.func.attr == "double" and not node.args):
                    hits = [(node, "float64-tensor",
                             "`.double()` moves a tensor to float64 on the device "
                             "path — keep the data dtype")]
            elif isinstance(node, ast.Attribute) and \
                    self.imports.resolve(node) in _TORCH_F64:
                hits = [(node, "float64-tensor",
                         f"`{self.imports.resolve(node)}` on the device path — a "
                         "double-width tensor runs at a fraction of the float32 "
                         "rate; keep the data dtype, or allowlist host-side design")]
            for sub, code, msg in hits:
                if id(sub) in seen:
                    continue
                seen.add(id(sub))
                symbol = _enclosing_fn(fn_spans, sub.lineno)
                if self._float64_allowed(symbol):
                    continue
                self.findings.append(Finding(
                    rule="R3", code=code, path=self.path, line=sub.lineno,
                    col=sub.col_offset, symbol=symbol, message=msg,
                ))

    # -- R6, R7, R14, R15 ----------------------------------------------------

    def _check_sync_in_loop(self, node: ast.Call):
        """R6: host syncs inside a for/while body in the R6-scoped
        packages."""
        if ("R6" not in self.rules or not self._loop_depth
                or not _in_scope(self.path, _R6_SCOPE)):
            return
        dotted = self.imports.resolve(node.func) or ""
        if dotted in _SYNC_DOTTED:
            self._emit("R6", "sync-in-loop", node,
                       f"`{dotted}` inside a loop body — one device sync per "
                       "iteration serializes the dispatch pipeline; dispatch the "
                       "whole loop's work first (parallel.dispatch) and sync once, "
                       "or baseline this as an intentional drain point")
        elif (isinstance(node.func, ast.Attribute)
              and node.func.attr in _SYNC_METHODS and not node.args
              and not node.keywords and not _chained_read(node.func.value)):
            self._emit("R6", "item-in-loop" if node.func.attr in ("item", "tolist")
                       else "transfer-in-loop", node,
                       f"`.{node.func.attr}()` inside a loop body — a device→host "
                       "round trip per iteration; read the whole result once "
                       "outside the loop")
        elif (dotted in ("numpy.asarray", "numpy.array")
              and any(isinstance(a, ast.Call) for a in node.args)):
            self._emit("R6", "host-transfer-in-loop", node,
                       f"`{dotted.replace('numpy', 'np', 1)}` over a freshly "
                       "computed result inside a loop body — if the callee runs "
                       "on the card this is one device→host transfer (and sync) "
                       "per iteration; batch the computation or fetch once after "
                       "the loop")

    def _check_unblocked_timing(self, fn: ast.FunctionDef):
        """R7: a perf_counter bracket timing a launch-suspect call with
        no sync between the clock reads. One function at a time; nodes
        inside nested defs belong to the nested function's own check."""
        if "R7" not in self.rules or not _in_scope(self.path, _R7_SCOPE):
            return
        nested_ids: Set[int] = set()
        for nd in ast.walk(fn):
            if isinstance(nd, (ast.FunctionDef, ast.AsyncFunctionDef)) and nd is not fn:
                nested_ids.update(id(sub) for sub in ast.walk(nd))
        own = [n for n in ast.walk(fn) if id(n) not in nested_ids]
        assigns: dict = {}
        for n in own:
            if (isinstance(n, ast.Assign) and len(n.targets) == 1
                    and isinstance(n.targets[0], ast.Name)
                    and isinstance(n.value, ast.Call)
                    and self.imports.resolve(n.value.func) == "time.perf_counter"):
                assigns.setdefault(n.targets[0].id, []).append(n.lineno)
        if not assigns:
            return
        calls = [n for n in own if isinstance(n, ast.Call)]
        for n in own:
            if not (isinstance(n, ast.BinOp) and isinstance(n.op, ast.Sub)
                    and isinstance(n.right, ast.Name) and n.right.id in assigns
                    and isinstance(n.left, ast.Call)
                    and self.imports.resolve(n.left.func) == "time.perf_counter"):
                continue
            l2 = n.lineno
            starts = [ln for ln in assigns[n.right.id] if ln < l2]
            if not starts:
                continue
            l1 = max(starts)   # the nearest preceding assignment
            suspect, synced = None, False
            for c in calls:
                if not l1 < c.lineno <= l2:
                    continue
                dotted = self.imports.resolve(c.func) or ""
                attr = c.func.attr if isinstance(c.func, ast.Attribute) else ""
                if dotted in _R7_SYNC_DOTTED:
                    synced = True
                    break
                if dotted.startswith("torch."):
                    # torch calls launch asynchronously (torch.asarray too):
                    # they never clear the bracket
                    suspect = suspect or c
                    continue
                if attr in _R7_SYNC_ATTRS:
                    synced = True
                    break
                if dotted == "time.perf_counter":
                    continue
                if isinstance(c.func, ast.Name):
                    if (c.func.id not in _R7_HOST_CALLS
                            and not c.func.id.endswith(("Error", "Exception"))):
                        suspect = suspect or c   # an opaque callable: may launch
                elif (attr == "launch" or "detect" in attr or "dispatch" in attr):
                    suspect = suspect or c
            if suspect is not None and not synced:
                self._emit(
                    "R7", "unblocked-timing", n,
                    "`time.perf_counter()` bracket times a launch-suspect call "
                    "with no sync between the clock reads — CUDA launches are "
                    "asynchronous, so this wall measures the LAUNCH, not the "
                    "work; synchronize inside the bracket (or time with CUDA "
                    "events), or baseline with the reason the sync happens "
                    "inside a callee",
                )

    def _check_artifact_write(self, node: ast.Call):
        """R14: direct writes to artifact-suffixed path LITERALS must
        flow through ``utils.artifacts`` (the crash-only write layer)."""
        if "R14" not in self.rules or self.path.endswith(_R14_EXEMPT_SUFFIXES):
            return
        dotted = self.imports.resolve(node.func) or ""
        if dotted == "open":
            mode = node.args[1] if len(node.args) > 1 else next(
                (kw.value for kw in node.keywords if kw.arg == "mode"), None)
            if not (isinstance(mode, ast.Constant) and isinstance(mode.value, str)
                    and mode.value in _ARTIFACT_WRITE_MODES):
                return
            verb = f"open(.., {mode.value!r})"
        elif dotted in ("numpy.savez", "numpy.savez_compressed", "numpy.save"):
            verb = f"{dotted.replace('numpy', 'np', 1)}(..)"
        else:
            return
        path_arg = node.args[0] if node.args else None
        suffix = None
        if path_arg is not None:
            for nd in ast.walk(path_arg):
                if isinstance(nd, ast.Constant) and isinstance(nd.value, str):
                    suffix = next((s for s in _ARTIFACT_SUFFIXES if nd.value.endswith(s)),
                                  None)
                    if suffix:
                        break
        if suffix is None:
            return
        self._emit("R14", "non-durable-artifact-write", node,
                   f"direct `{verb}` on a `{suffix}` artifact path — durable "
                   "state must go through utils.artifacts (atomic_json/"
                   "atomic_file/append_record: atomic tmp+fsync+rename, "
                   "checksummed appends), or a crash mid-write strands a torn "
                   "artifact the resume/report paths then choke on")

    def _check_subprocess_wait(self, node: ast.Call):
        """R15: a child-process wait with no deadline."""
        if "R15" not in self.rules or not isinstance(node.func, ast.Attribute):
            return
        method = node.func.attr
        if method not in ("wait", "communicate"):
            return
        if any(kw.arg == "timeout" for kw in node.keywords):
            return
        recv = node.func.value
        name = (recv.id if isinstance(recv, ast.Name)
                else recv.attr if isinstance(recv, ast.Attribute) else "")
        if method == "wait":
            if node.args or not _R15_PROC_RECEIVER.search(name):
                return
        elif method == "communicate" and len(node.args) > 1:
            return
        self._emit("R15", "unbounded-subprocess-wait", node,
                   f"`{name or '<expr>'}.{method}()` with no timeout — a wedged "
                   "child process blocks this caller forever; pass `timeout=` "
                   "and handle subprocess.TimeoutExpired (the supervisor must "
                   "outlive any worker it watches)")


def analyze_source(source: str, path: str,
                   rules: Sequence[str] = ALL_RULES) -> List[Finding]:
    """Analyze one file's source text. ``path`` scopes the path-sensitive
    rules and the allowlists, so virtual paths work for tests."""
    cpath = canonical_path(path)
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as exc:
        return [Finding(rule="E0", code="syntax-error", path=cpath,
                        line=exc.lineno or 1, col=(exc.offset or 1) - 1,
                        symbol="<module>", message=f"cannot parse: {exc.msg}")]
    lines = source.splitlines()
    findings = _Analyzer(cpath, lines, rules).run(tree)
    if any(r in rules for r in ("R8", "R9", "R10")):
        from . import concurrency

        findings += [f for f in concurrency.analyze(tree, cpath, lines, rules)
                     if not line_allowed(lines, f)]
    if "R11" in rules:
        from . import programs

        findings += [f for f in programs.analyze(tree, cpath, lines, rules)
                     if not line_allowed(lines, f)]
    return findings


def analyze_file(path, rules: Sequence[str] = ALL_RULES) -> List[Finding]:
    with open(path, "r", encoding="utf-8") as fh:
        return analyze_source(fh.read(), str(path), rules)


def iter_python_files(paths: Iterable[str]):
    """Expand files/directories into .py files, deterministic order."""
    import os

    for p in paths:
        if os.path.isdir(p):
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs if d not in ("__pycache__", ".git"))
                for name in sorted(files):
                    if name.endswith(".py"):
                        yield os.path.join(root, name)
        else:
            yield p


def analyze_paths(paths: Iterable[str],
                  rules: Sequence[str] = ALL_RULES) -> List[Finding]:
    findings: List[Finding] = []
    for f in iter_python_files(paths):
        findings.extend(analyze_file(f, rules))
    return findings
