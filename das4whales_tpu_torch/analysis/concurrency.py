"""daslint concurrency rules (R8–R10) for the port: locks, ordering,
thread hygiene (the counterpart of ``das4whales_tpu.analysis.concurrency``).

The service (``service/``), the fleet (``fleet/``) and the slab route's
reader and copy threads share state across threads; R1–R7 gate the
device invariants, this module gates the concurrency ones, over the
THREAD-SPAWNING modules only (:func:`in_scope`):

* every file of ``service/``, ``telemetry/`` and ``fleet/``;
* ``io/stream.py`` (the prefetch readers and the slab copy thread),
  ``io/native.py`` (the native reader's pool), ``io/staging.py`` (the
  pinned ring the copy thread and the detect loop share),
  ``parallel/dispatch.py`` (the resolve watchdog), ``utils/locks.py``
  (the traced locks), ``faults.py`` (the watchdog pool),
  ``workflows/campaign.py`` (the mesh campaign's reader pool; its
  ``SlabExecutor`` runs in the service's scheduler thread) and
  ``ops/mxu.py`` (the calibration pool and the table's path locks).

Out of scope: modules that take a lock but start no thread
(``utils/artifacts.py``, ``utils/memory.py``), and ``__main__.py``,
whose only thread primitive is the ``fleet`` verb's stop event.

R8  ``unsynchronized-shared-state`` — a GuardedBy-style pass per class:
    the lock discipline of each attribute is inferred from the MAJORITY
    of its accesses that hold a ``self._lock``-style lock; the
    unguarded minority is flagged. A ``# daslint: guarded-by[_lock]``
    comment on the attribute's initializing assignment pins the
    discipline explicitly. A third clause catches the snapshot-API
    hazard: an attribute MUTATED in one method and Python-iterated in a
    PUBLIC method with no common lock between the two. ``__init__``
    writes are construction and exempt.
R9  ``lock-order`` / ``blocking-under-lock`` — the static
    lock-acquisition graph from ``with``-statement nesting (closed over
    same-namespace calls): a cycle is a deadlock waiting for a schedule.
    Plus blockers held under a lock: ``.resolve()``, the counted
    ``fetch``/``sync``, ``push_wait``, ``time.sleep``, file reads and
    writes, ``open``, ``.join``/``.result``, socket sends, and the card's
    waits — ``torch.cuda.synchronize``, an event's or stream's
    ``synchronize``, ``.item()`` and ``.cpu()``. ``Condition.wait`` on a
    condition whose lock is the held lock is NOT a blocker.
R10 ``thread-hygiene`` — ``Condition.wait()`` outside a predicate
    ``while``, ``Event.wait()``/``Thread.join()`` without a timeout,
    threads and pools spawned without a ``name=`` /
    ``thread_name_prefix=``, and ``time.sleep`` polling loops in
    classes that already own a ``Condition``.

Static honesty: the pass sees ``self``/``cls`` attribute accesses and
direct ``with`` nesting per class (plus one same-namespace call level
for the order graph). Cross-object mutation is invisible — which is why
the runtime half (``analysis/concurrency_runtime.py``'s ``race_guard``
over ``utils/locks.py``'s TracedLock graph) exists.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from pathlib import PurePosixPath
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .rules import PACKAGE, Finding, _Imports

CONCURRENCY_RULES = ("R8", "R9", "R10")

#: directories whose every file spawns or serves threads
_SCOPE_DIR_PARTS = frozenset({"service", "telemetry", "fleet"})
#: individual thread-spawning modules outside those directories
_SCOPE_FILE_SUFFIXES = tuple(f"{PACKAGE}/{p}" for p in (
    "io/stream.py", "io/native.py", "io/staging.py", "parallel/dispatch.py",
    "utils/locks.py", "faults.py", "workflows/campaign.py", "ops/mxu.py",
))

_GUARDED_BY_RE = re.compile(r"daslint:\s*guarded-by\[(\w+)\]")

#: attribute method calls that mutate their container in place
_MUTATORS = frozenset({
    "append", "appendleft", "extend", "extendleft", "insert", "add",
    "remove", "discard", "pop", "popleft", "popitem", "clear", "update",
    "setdefault", "rotate",
})

#: final attributes whose call blocks the calling thread (R9's
#: blocking-under-lock set); ``wait`` is handled separately (a
#: Condition.wait on the HELD lock releases it and is fine).
_BLOCKING_ATTRS = frozenset({
    "resolve", "fetch", "sync", "synchronize", "item", "cpu",
    "push_wait", "result", "join", "sendall", "send", "recv",
    "read", "readline", "readlines", "write",
})
_BLOCKING_DOTTED = frozenset({"time.sleep", "torch.cuda.synchronize"})


@dataclasses.dataclass
class _Access:
    attr: str
    kind: str          # "read" | "write" | "mut"
    held: Tuple[str, ...]
    method: str
    lineno: int
    col: int
    iterates: bool = False
    in_init: bool = False


def in_scope(path: str) -> bool:
    parts = PurePosixPath(path).parts
    if any(p in _SCOPE_DIR_PARTS for p in parts[:-1]):
        return True
    return any(path.endswith(sfx) for sfx in _SCOPE_FILE_SUFFIXES)


def _resolves_to(imports: _Imports, node: ast.AST, *suffixes: str) -> bool:
    dotted = imports.resolve(node) or ""
    return any(dotted == s or dotted.endswith("." + s.split(".")[-1])
               and dotted.split(".")[-1] == s.split(".")[-1]
               for s in suffixes)


def _dotted(imports: _Imports, node: ast.AST) -> str:
    return imports.resolve(node) or ""


def _lockish_name(name: str) -> bool:
    return "lock" in name.lower()


class _Namespace:
    """One lock-discipline namespace: a class (``self.X`` attrs) or the
    module top level (bare names). Collects lock/condition/event
    declarations, attribute accesses with held-lock context, the local
    acquisition graph, and the R9/R10 findings of its methods."""

    def __init__(self, pass_, name: str, is_module: bool):
        self.p = pass_
        self.name = name
        self.is_module = is_module
        self.locks: Set[str] = set()
        self.conditions: Dict[str, str] = {}   # cond name -> lock it wraps
        self.events: Set[str] = set()
        self.methods: Set[str] = set()
        self.pinned: Dict[str, str] = {}       # attr -> guarded-by lock
        self.accesses: List[_Access] = []
        # (held, acquired) -> (lineno, col, symbol), first site wins
        self.edges: Dict[Tuple[str, str], Tuple[int, int, str]] = {}
        self.direct_locks: Dict[str, Set[str]] = {}  # method -> locks taken
        # method -> [(callee, held at the call, lineno, col)]
        self.calls: Dict[str, List[Tuple[str, Tuple[str, ...], int, int]]] = {}

    # -- declaration scan ---------------------------------------------------

    def declare(self, name: str, value: ast.AST, lineno: int) -> None:
        imports = self.p.imports
        if isinstance(value, ast.Call):
            if _resolves_to(imports, value.func, "threading.Lock",
                            "threading.RLock", "locks.new_lock",
                            "locks.TracedLock"):
                self.locks.add(name)
                return
            if _resolves_to(imports, value.func, "threading.Condition"):
                wrapped = name
                if value.args:
                    arg = value.args[0]
                    if (isinstance(arg, ast.Attribute)
                            and isinstance(arg.value, ast.Name)
                            and arg.value.id in ("self", "cls")):
                        wrapped = arg.attr
                    elif isinstance(arg, ast.Name):
                        wrapped = arg.id
                self.conditions[name] = wrapped
                return
            if _resolves_to(imports, value.func, "threading.Event"):
                self.events.add(name)
                return
        if _lockish_name(name):
            # e.g. ``self._lock = lock`` (a lock handed in by the owner,
            # the metrics-registry pattern) — the NAME is the contract
            self.locks.add(name)
        # guarded-by annotation on the declaring line (or line above)
        pin = self.p.annotation_at(lineno)
        if pin is not None:
            self.pinned[name] = pin

    def lock_of(self, expr: ast.AST) -> Optional[str]:
        """The lock name a ``with`` context expression acquires, or
        None. Conditions map to the lock they wrap."""
        name = None
        if (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)):
            if expr.value.id in ("self", "cls"):
                name = expr.attr
            elif _lockish_name(expr.attr):
                # a lock reached through a local object (``idx.lock``):
                # named by its attribute — the lock-class node
                return expr.attr
        elif isinstance(expr, ast.Name):
            if (expr.id in self.p.module.locks
                    or expr.id in self.p.module.conditions):
                ns = self.p.module
                return ns.conditions.get(expr.id, expr.id)
            if _lockish_name(expr.id):
                return expr.id
            return None
        if name is None:
            return None
        if name in self.conditions:
            return self.conditions[name]
        if name in self.locks or _lockish_name(name):
            return name
        return None

    def condition_names(self) -> Set[str]:
        return set(self.conditions)


class _ConcurrencyPass:
    def __init__(self, path: str, lines: Sequence[str],
                 rules: Sequence[str]):
        self.path = path
        self.lines = lines
        self.rules = set(rules)
        self.findings: List[Finding] = []
        self.imports: _Imports = None
        self.module: _Namespace = None

    # -- plumbing -----------------------------------------------------------

    def annotation_at(self, lineno: int) -> Optional[str]:
        for ln in (lineno, lineno - 1):
            if not 1 <= ln <= len(self.lines):
                continue
            text = self.lines[ln - 1]
            if ln != lineno and not text.lstrip().startswith("#"):
                continue
            m = _GUARDED_BY_RE.search(text)
            if m:
                return m.group(1)
        return None

    def _emit(self, rule: str, code: str, lineno: int, col: int,
              symbol: str, message: str) -> None:
        if rule in self.rules:
            self.findings.append(Finding(
                rule=rule, code=code, path=self.path, line=lineno,
                col=col, symbol=symbol, message=message,
            ))

    # -- entry --------------------------------------------------------------

    def run(self, tree: ast.Module) -> List[Finding]:
        self.imports = _Imports(tree)
        self.module = _Namespace(self, "<module>", is_module=True)
        # module-level lock/condition/event declarations
        for st in tree.body:
            if isinstance(st, ast.Assign) and len(st.targets) == 1 \
                    and isinstance(st.targets[0], ast.Name):
                self.module.declare(st.targets[0].id, st.value, st.lineno)
        for st in tree.body:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.module.methods.add(st.name)
        for st in tree.body:
            if isinstance(st, ast.ClassDef):
                self._class(st)
            elif isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._walk_method(self.module, st, st.name)
        self._finish_namespace(self.module)
        return self.findings

    # -- class pass ---------------------------------------------------------

    def _class(self, cls: ast.ClassDef) -> None:
        ns = _Namespace(self, cls.name, is_module=False)
        # class-level declarations (``_index_lock = threading.Lock()``)
        for st in cls.body:
            if isinstance(st, ast.Assign) and len(st.targets) == 1 \
                    and isinstance(st.targets[0], ast.Name):
                ns.declare(st.targets[0].id, st.value, st.lineno)
            elif isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                ns.methods.add(st.name)
        # ``self.X = threading.Lock()`` declarations anywhere in methods
        for st in cls.body:
            if not isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for sub in ast.walk(st):
                if (isinstance(sub, ast.Assign) and len(sub.targets) == 1
                        and isinstance(sub.targets[0], ast.Attribute)
                        and isinstance(sub.targets[0].value, ast.Name)
                        and sub.targets[0].value.id in ("self", "cls")):
                    ns.declare(sub.targets[0].attr, sub.value, sub.lineno)
        for st in cls.body:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._walk_method(ns, st, f"{cls.name}.{st.name}")
            elif isinstance(st, ast.ClassDef):
                self._class(st)   # nested class: its own namespace
        self._finish_namespace(ns)

    # -- method walk --------------------------------------------------------

    def _walk_method(self, ns: _Namespace, fn, symbol: str) -> None:
        method = fn.name
        in_init = method in ("__init__", "__post_init__")
        iterated = self._iterated_nodes(fn)
        self._stmts(ns, fn.body, method, symbol, in_init,
                    held=(), while_depth=0, loop_depth=0,
                    iterated=iterated)

    def _iterated_nodes(self, fn) -> Set[int]:
        """ids of ``self.X`` Attribute nodes in Python-iteration
        position: a ``for`` iterable or a comprehension source, either
        directly or through a ``.items()/.values()/.keys()`` call."""
        out: Set[int] = set()

        def mark(expr: ast.AST) -> None:
            node = expr
            if (isinstance(node, ast.Call) and not node.args
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in ("items", "values", "keys")):
                node = node.func.value
            if (isinstance(node, ast.Attribute)
                    and isinstance(node.value, ast.Name)
                    and node.value.id in ("self", "cls")):
                out.add(id(node))

        for node in ast.walk(fn):
            if isinstance(node, (ast.For, ast.AsyncFor)):
                mark(node.iter)
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                                   ast.GeneratorExp)):
                for gen in node.generators:
                    mark(gen.iter)
        return out

    def _stmts(self, ns, body, method, symbol, in_init, held,
               while_depth, loop_depth, iterated) -> None:
        for st in body:
            self._stmt(ns, st, method, symbol, in_init, held,
                       while_depth, loop_depth, iterated)

    def _stmt(self, ns, st, method, symbol, in_init, held,
              while_depth, loop_depth, iterated) -> None:
        kw = dict(method=method, symbol=symbol, in_init=in_init,
                  while_depth=while_depth, loop_depth=loop_depth,
                  iterated=iterated)
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested def: runs later, with no lock held at entry
            self._stmts(ns, st.body, method, symbol, in_init, (),
                        0, 0, iterated | self._iterated_nodes(st))
            return
        if isinstance(st, (ast.With, ast.AsyncWith)):
            acquired = []
            for item in st.items:
                lk = ns.lock_of(item.context_expr)
                if lk is not None:
                    # items of one ``with a, b:`` acquire SEQUENTIALLY —
                    # earlier items are held when later ones acquire, so
                    # they order-edge exactly like nested withs
                    for h in held + tuple(acquired):
                        if (h, lk) not in ns.edges and h != lk:
                            ns.edges[(h, lk)] = (item.context_expr.lineno,
                                                 item.context_expr.col_offset,
                                                 symbol)
                    ns.direct_locks.setdefault(method, set()).add(lk)
                    acquired.append(lk)
                else:
                    self._expr(ns, item.context_expr, held, **kw)
            self._stmts(ns, st.body, method, symbol, in_init,
                        held + tuple(acquired), while_depth, loop_depth,
                        iterated)
            return
        if isinstance(st, ast.While):
            self._expr(ns, st.test, held, **kw)
            self._stmts(ns, st.body, method, symbol, in_init, held,
                        while_depth + 1, loop_depth + 1, iterated)
            self._stmts(ns, st.orelse, method, symbol, in_init, held,
                        while_depth, loop_depth, iterated)
            return
        if isinstance(st, (ast.For, ast.AsyncFor)):
            self._expr(ns, st.iter, held, **kw)
            self._stmts(ns, st.body, method, symbol, in_init, held,
                        while_depth, loop_depth + 1, iterated)
            self._stmts(ns, st.orelse, method, symbol, in_init, held,
                        while_depth, loop_depth, iterated)
            return
        if isinstance(st, ast.If):
            self._expr(ns, st.test, held, **kw)
            self._stmts(ns, st.body, method, symbol, in_init, held,
                        while_depth, loop_depth, iterated)
            self._stmts(ns, st.orelse, method, symbol, in_init, held,
                        while_depth, loop_depth, iterated)
            return
        if isinstance(st, ast.Try):
            for blk in (st.body, st.orelse, st.finalbody):
                self._stmts(ns, blk, method, symbol, in_init, held,
                            while_depth, loop_depth, iterated)
            for h in st.handlers:
                self._stmts(ns, h.body, method, symbol, in_init, held,
                            while_depth, loop_depth, iterated)
            return
        if isinstance(st, ast.Assign):
            for tgt in st.targets:
                self._write_target(ns, tgt, held, **kw)
            self._expr(ns, st.value, held, **kw)
            return
        if isinstance(st, ast.AugAssign):
            self._write_target(ns, st.target, held, **kw)
            self._expr(ns, st.value, held, **kw)
            return
        if isinstance(st, ast.AnnAssign):
            if st.value is not None:
                self._write_target(ns, st.target, held, **kw)
                self._expr(ns, st.value, held, **kw)
            return
        for child in ast.iter_child_nodes(st):
            if isinstance(child, ast.expr):
                self._expr(ns, child, held, **kw)
            elif isinstance(child, ast.stmt):
                self._stmt(ns, child, method, symbol, in_init, held,
                           while_depth, loop_depth, iterated)

    def _write_target(self, ns, tgt, held, *, method, symbol, in_init,
                      while_depth, loop_depth, iterated) -> None:
        node = tgt
        via_subscript = False
        while isinstance(node, ast.Subscript):
            node = node.value
            via_subscript = True
        if (isinstance(node, ast.Attribute)
                and isinstance(node.value, ast.Name)
                and node.value.id in ("self", "cls")):
            ns.accesses.append(_Access(
                attr=node.attr, kind="mut" if via_subscript else "write",
                held=held, method=method, lineno=node.lineno,
                col=node.col_offset, in_init=in_init,
            ))
        elif isinstance(tgt, (ast.Tuple, ast.List)):
            for el in tgt.elts:
                self._write_target(ns, el, held, method=method,
                                   symbol=symbol, in_init=in_init,
                                   while_depth=while_depth,
                                   loop_depth=loop_depth, iterated=iterated)
        elif via_subscript or isinstance(tgt, ast.Subscript):
            self._expr(ns, node, held, method=method, symbol=symbol,
                       in_init=in_init, while_depth=while_depth,
                       loop_depth=loop_depth, iterated=iterated)

    def _expr(self, ns, expr, held, *, method, symbol, in_init,
              while_depth, loop_depth, iterated) -> None:
        for node in ast.walk(expr):
            if isinstance(node, ast.Attribute):
                if (isinstance(node.value, ast.Name)
                        and node.value.id in ("self", "cls")
                        and isinstance(node.ctx, ast.Load)):
                    ns.accesses.append(_Access(
                        attr=node.attr, kind="read", held=held,
                        method=method, lineno=node.lineno,
                        col=node.col_offset,
                        iterates=id(node) in iterated, in_init=in_init,
                    ))
            elif isinstance(node, ast.Call):
                self._call(ns, node, held, method=method, symbol=symbol,
                           while_depth=while_depth, loop_depth=loop_depth)

    def _call(self, ns, node: ast.Call, held, *, method, symbol,
              while_depth, loop_depth) -> None:
        imports = self.imports
        dotted = _dotted(imports, node.func)
        attr = node.func.attr if isinstance(node.func, ast.Attribute) else ""
        base = (node.func.value
                if isinstance(node.func, ast.Attribute) else None)
        # ``self.X.wait()``: the waited object is the attribute X
        self_base = (isinstance(base, ast.Attribute)
                     and isinstance(base.value, ast.Name)
                     and base.value.id in ("self", "cls"))
        base_attr = base.attr if self_base else None
        # ``self.m()``: a same-namespace method call
        self_method = (isinstance(base, ast.Name)
                       and base.id in ("self", "cls"))

        # mutating container calls: ``self.X.append(...)``
        if (attr in _MUTATORS and isinstance(base, ast.Attribute)
                and isinstance(base.value, ast.Name)
                and base.value.id in ("self", "cls")):
            ns.accesses.append(_Access(
                attr=base.attr, kind="mut", held=held, method=method,
                lineno=base.lineno, col=base.col_offset,
                in_init=method in ("__init__", "__post_init__"),
            ))

        # same-namespace calls feed the order graph's one-level closure
        if self_method and attr in ns.methods:
            ns.calls.setdefault(method, []).append(
                (attr, held, node.lineno, node.col_offset))
        elif (isinstance(node.func, ast.Name)
              and node.func.id in self.module.methods and ns.is_module):
            ns.calls.setdefault(method, []).append(
                (node.func.id, held, node.lineno, node.col_offset))

        # -- R10: thread hygiene -------------------------------------------
        if dotted == "threading.Thread" or dotted.endswith(
                ".threading.Thread"):
            if not any(k.arg == "name" for k in node.keywords):
                self._emit(
                    "R10", "unnamed-thread", node.lineno, node.col_offset,
                    symbol,
                    "`threading.Thread(...)` without a `name=` — traces, "
                    "logs and the lock metrics attribute this thread's "
                    "work to `Thread-N`; name it after its component",
                )
        elif dotted.split(".")[-1] == "ThreadPoolExecutor":
            if not any(k.arg == "thread_name_prefix"
                       for k in node.keywords):
                self._emit(
                    "R10", "unnamed-thread", node.lineno, node.col_offset,
                    symbol,
                    "`ThreadPoolExecutor(...)` without a "
                    "`thread_name_prefix=` — pool workers show up as "
                    "`ThreadPoolExecutor-N_M` in traces and lock metrics; "
                    "name the pool after its component",
                )
        cond_names = ns.condition_names() | self.module.condition_names()
        if attr == "wait":
            is_condition = self_base and base_attr in cond_names
            if not self_base and isinstance(base, ast.Name):
                is_condition = base.id in self.module.conditions
            if is_condition:
                if while_depth == 0 and "R10" in self.rules:
                    self._emit(
                        "R10", "condition-wait-no-predicate",
                        node.lineno, node.col_offset, symbol,
                        "`Condition.wait()` outside a predicate `while` "
                        "loop — spurious wakeups and missed notifies "
                        "require `while not pred: cond.wait(...)`",
                    )
            else:
                known_event = (self_base and base_attr in (
                    ns.events | self.module.events))
                if (isinstance(base, ast.Name)
                        and base.id in self.module.events):
                    known_event = True
                if known_event and not node.args and not node.keywords:
                    self._emit(
                        "R10", "unbounded-wait", node.lineno,
                        node.col_offset, symbol,
                        "`Event.wait()` without a timeout in a service "
                        "module — an unbounded wait can never be "
                        "watchdogged; pass a timeout and loop",
                    )
                if known_event and held and "R9" in self.rules:
                    self._emit(
                        "R9", "blocking-under-lock", node.lineno,
                        node.col_offset, symbol,
                        f"`.wait()` on an Event while holding "
                        f"{self._held_str(held)} — every thread queued "
                        "on the lock stalls behind this wait",
                    )
                return
        if attr == "join" and not node.args and not node.keywords:
            self._emit(
                "R10", "unbounded-wait", node.lineno, node.col_offset,
                symbol,
                "`.join()` without a timeout in a service module — a "
                "wedged worker turns shutdown into a hang; join with a "
                "timeout and escalate",
            )
        if (dotted == "time.sleep" and loop_depth > 0
                and (ns.conditions or (not ns.is_module
                                       and self.module.conditions))):
            self._emit(
                "R10", "sleep-polling", node.lineno, node.col_offset,
                symbol,
                "`time.sleep` polling loop in a namespace that already "
                "owns a `Condition` — wait on the condition (with a "
                "timeout) instead of burning wakeups",
            )

        # -- R9: blocking work under a held lock ---------------------------
        if held and "R9" in self.rules:
            blocking = (dotted in _BLOCKING_DOTTED
                        or attr in _BLOCKING_ATTRS
                        or (isinstance(node.func, ast.Name)
                            and node.func.id == "open"))
            if attr == "join" and node.args:
                # ``", ".join(parts)`` is string plumbing and a
                # ``t.join(timeout)`` is bounded — only the unbounded
                # zero-arg join blocks a lock indefinitely
                blocking = False
            if attr == "wait" and self_base and base_attr in cond_names:
                # Condition.wait on the held lock RELEASES it
                blocking = ns.conditions.get(
                    base_attr, base_attr) not in held
            if blocking:
                what = dotted or (f".{attr}()" if attr else "open()")
                self._emit(
                    "R9", "blocking-under-lock", node.lineno,
                    node.col_offset, symbol,
                    f"`{what}` while holding {self._held_str(held)} — a "
                    "dispatch/IO blocker under a lock serializes every "
                    "thread queued on it (move the slow work outside the "
                    "critical section, or baseline with the reason the "
                    "hold is bounded)",
                )

    @staticmethod
    def _held_str(held) -> str:
        return " + ".join(f"`{h}`" for h in held)

    # -- namespace wrap-up: R8 discipline + R9 cycles -----------------------

    def _finish_namespace(self, ns: _Namespace) -> None:
        if not ns.is_module and "R8" in self.rules:
            self._r8(ns)
        if "R9" in self.rules:
            self._r9_cycles(ns)

    def _r8(self, ns: _Namespace) -> None:
        infra = (ns.locks | set(ns.conditions) | ns.events | ns.methods)
        by_attr: Dict[str, List[_Access]] = {}
        for a in ns.accesses:
            if a.attr in infra or a.in_init:
                continue
            by_attr.setdefault(a.attr, []).append(a)
        flagged: Set[Tuple[str, int]] = set()
        for attr, accs in sorted(by_attr.items()):
            pinned = ns.pinned.get(attr)
            unguarded = [a for a in accs if not a.held]
            if pinned is not None:
                for a in accs:
                    if pinned not in a.held:
                        flagged.add((attr, a.lineno))
                        self._emit(
                            "R8", "unsynchronized-shared-state",
                            a.lineno, a.col, f"{ns.name}.{a.method}",
                            f"`self.{attr}` is pinned `guarded-by"
                            f"[{pinned}]` but this {a.kind} does not "
                            f"hold `{pinned}`",
                        )
                continue
            # majority inference: the most common guarding lock
            per_lock: Dict[str, int] = {}
            for a in accs:
                for h in a.held:
                    per_lock[h] = per_lock.get(h, 0) + 1
            if not per_lock or not unguarded:
                continue
            lock, n = max(per_lock.items(), key=lambda kv: kv[1])
            if n >= 2 and n > len(unguarded):
                for a in unguarded:
                    flagged.add((attr, a.lineno))
                    self._emit(
                        "R8", "unsynchronized-shared-state",
                        a.lineno, a.col, f"{ns.name}.{a.method}",
                        f"`self.{attr}` is guarded by `{lock}` in "
                        f"{n} accesses but this {a.kind} holds no lock "
                        "— take the lock, or pin a different discipline "
                        "with `# daslint: guarded-by[...]` / baseline "
                        "with the reason the access is safe (GIL-atomic "
                        "single-field read, thread-confined, ...)",
                    )
        # the snapshot-API clause: mutated in one method, Python-iterated
        # in a public method, no common lock
        for attr, accs in sorted(by_attr.items()):
            writes = [a for a in accs if a.kind in ("write", "mut")]
            if not writes:
                continue
            for a in accs:
                if (not a.iterates or a.method.startswith("_")
                        or (attr, a.lineno) in flagged):
                    continue
                racing = [w for w in writes
                          if w.method != a.method
                          and not (set(w.held) & set(a.held))]
                if racing:
                    self._emit(
                        "R8", "unguarded-snapshot-read",
                        a.lineno, a.col, f"{ns.name}.{a.method}",
                        f"public `{a.method}` iterates `self.{attr}` "
                        f"while `{racing[0].method}` mutates it with no "
                        "common lock — a torn iteration (RuntimeError: "
                        "changed size) under concurrent callers; "
                        "snapshot under a shared lock or copy-on-read "
                        "(C-atomic `list(x)`/`dict(x)`)",
                    )

    def _r9_cycles(self, ns: _Namespace) -> None:
        # one-level interprocedural closure: locks a method acquires,
        # directly or through same-namespace calls (fixpoint)
        acquires: Dict[str, Set[str]] = {
            m: set(v) for m, v in ns.direct_locks.items()}
        changed = True
        while changed:
            changed = False
            for m, calls in ns.calls.items():
                cur = acquires.setdefault(m, set())
                for callee, _held, _l, _c in calls:
                    extra = acquires.get(callee, set()) - cur
                    if extra:
                        cur |= extra
                        changed = True
        edges = dict(ns.edges)
        for m, calls in ns.calls.items():
            for callee, held, lineno, col in calls:
                for lk in acquires.get(callee, ()):
                    for h in held:
                        if h != lk and (h, lk) not in edges:
                            edges[(h, lk)] = (
                                lineno, col,
                                f"{ns.name}.{m}" if not ns.is_module
                                else m)
        graph: Dict[str, Set[str]] = {}
        for (a, b) in edges:
            graph.setdefault(a, set()).add(b)
        seen_cycles: Set[frozenset] = set()
        for (a, b), (lineno, col, symbol) in sorted(
                edges.items(), key=lambda kv: kv[1][:2]):
            path = self._path(b, a, graph)
            if path is None:
                continue
            cyc = frozenset([a] + path)
            if cyc in seen_cycles:
                continue
            seen_cycles.add(cyc)
            self._emit(
                "R9", "lock-order", lineno, col, symbol,
                "lock acquisition cycle "
                + " -> ".join([a] + path)
                + " — two threads entering from opposite ends deadlock; "
                "impose one global order (acquire "
                f"`{min([a] + path)}` first everywhere)",
            )

    @staticmethod
    def _path(src: str, dst: str, graph: Dict[str, Set[str]],
              _seen=None) -> Optional[List[str]]:
        if _seen is None:
            _seen = set()
        if src == dst:
            return [dst]
        _seen.add(src)
        for nxt in sorted(graph.get(src, ())):
            if nxt in _seen:
                continue
            sub = _ConcurrencyPass._path(nxt, dst, graph, _seen)
            if sub is not None:
                return [src] + sub
        return None


def analyze(tree: ast.Module, path: str, lines: Sequence[str],
            rules: Sequence[str] = CONCURRENCY_RULES) -> List[Finding]:
    """Run the concurrency rules over one parsed module. ``path`` is
    the canonical repo-relative path — out-of-scope files return []."""
    wanted = [r for r in rules if r in CONCURRENCY_RULES]
    if not wanted or not in_scope(path):
        return []
    return _ConcurrencyPass(path, lines, wanted).run(tree)
