"""Port parity, the static analyzer: ``das4whales_tpu_torch.analysis``'s
rules, baseline and command line against ``das4whales_tpu.analysis``.

* **Shared rules** (R3's numpy spellings, R8–R10, R11's ``dtype=float``,
  R14, R15): the same snippet through both analyzers, at
  ``das4whales_tpu/<p>`` and at ``das4whales_tpu_torch/<p>``, gives the
  same (rule, code, line, col, symbol) list.
* **Spelling pairs** (R1, R6, R7): a JAX spelling and its torch spelling
  are flagged at the same lines; their clean counterparts are clean in
  both.
* **Anchoring**: each scoped rule fires on a port path, and not on the
  same file anchored at the JAX package's name.
* **The gate**: the port is clean against its own ``baseline.toml``, no
  entry is stale, and the command line (in-process) is red on an injected
  hazard and green after ``--write-baseline``.
"""

from __future__ import annotations

import textwrap

import pytest

from das4whales_tpu import analysis as janalysis
from das4whales_tpu.analysis import baseline as jbaseline
from das4whales_tpu_torch import analysis
from das4whales_tpu_torch.analysis import baseline as baseline_mod
from das4whales_tpu_torch.analysis.__main__ import main as daslint_main

from tests.test_torch_imports import PORT
from tests.torch_threads import one_torch_thread  # noqa: F401


def _port(src, p, rules=analysis.ALL_RULES):
    return analysis.analyze_source(textwrap.dedent(src), f"das4whales_tpu_torch/{p}", rules)


def _jax(src, p, rules=janalysis.ALL_RULES):
    return janalysis.analyze_source(textwrap.dedent(src), f"das4whales_tpu/{p}", rules)


def _rows(findings):
    return sorted((f.rule, f.code, f.line, f.col, f.symbol) for f in findings)


# ---------------------------------------------------------------------------
# Shared rules: one snippet, both analyzers, the same findings
# ---------------------------------------------------------------------------

SHARED = {
    "R8-majority-and-torn-snapshot": ("service/scratch.py", ("R8",), """
        import threading

        class Ledger:
            def __init__(self):
                self._lock = threading.Lock()
                self.rows = []

            def add(self, r):
                with self._lock:
                    self.rows.append(r)

            def drop(self):
                with self._lock:
                    self.rows.clear()

            def peek(self):
                return self.rows[-1]

            def snapshot(self):
                return [r for r in self.rows]
        """),
    "R8-guarded-by-pin": ("service/scratch.py", ("R8",), """
        import threading

        class Box:
            def __init__(self):
                self._lock = threading.Lock()
                self.value = 0  # daslint: guarded-by[_lock]

            def set(self, v):
                self.value = v

            def get(self):
                with self._lock:
                    return self.value
        """),
    "R9-lock-order-cycle": ("service/scratch.py", ("R9",), """
        import threading

        class Pair:
            def __init__(self):
                self._a_lock = threading.Lock()
                self._b_lock = threading.Lock()

            def ab(self):
                with self._a_lock:
                    with self._b_lock:
                        pass

            def ba(self):
                with self._b_lock:
                    with self._a_lock:
                        pass
        """),
    "R9-blocking-under-lock": ("telemetry/scratch.py", ("R9",), """
        import threading
        import time

        class Sink:
            def __init__(self):
                self._lock = threading.Lock()

            def flush(self, handle, path):
                with self._lock:
                    time.sleep(0.1)
                    handle.resolve()
                    with open(path) as fh:
                        return fh.read()
        """),
    "R10-hygiene": ("service/scratch.py", ("R10",), """
        import threading
        from concurrent.futures import ThreadPoolExecutor

        class Worker:
            def __init__(self):
                self._cond = threading.Condition()
                self._done = threading.Event()

            def start(self, fn):
                t = threading.Thread(target=fn)
                pool = ThreadPoolExecutor(2)
                t.join()
                return pool

            def wait_ready(self):
                with self._cond:
                    self._cond.wait(1.0)
                self._done.wait()
        """),
    "R14-artifact-writes": ("workflows/scratch.py", ("R14",), """
        import json
        import os
        import numpy as np

        def save(outdir, payload, picks):
            with open(os.path.join(outdir, "manifest.json"), "w") as fh:
                json.dump(payload, fh)
            np.savez(f"{outdir}/picks.npz", picks=picks)
            with open(os.path.join(outdir, "notes.txt"), "w") as fh:
                fh.write("ok")
        """),
    "R15-subprocess-waits": ("fleet/scratch.py", ("R15",), """
        import subprocess

        def reap(proc, child, argv):
            proc.wait()
            child.wait(timeout=5)
            out, _ = subprocess.Popen(argv).communicate()
            return out
        """),
    "R3-numpy-spellings": ("ops/scratch.py", ("R3",), """
        import numpy as np

        def taper(n):
            w = np.zeros(n, dtype=np.float64)
            v = np.ones(n, dtype="float64")
            return w + v
        """),
    "R11-builtin-dtype": ("ops/scratch.py", ("R11",), """
        import numpy as np

        def gains(h):
            a = np.asarray(h, dtype=complex)
            return np.zeros(4, dtype=float) + a.real
        """),
}


@pytest.mark.parametrize("case", sorted(SHARED), ids=str)
def test_shared_rule_gives_the_same_findings_in_both_packages(case):
    p, rules, src = SHARED[case]
    got, ref = _port(src, p, rules), _jax(src, p, rules)
    assert ref, f"the snippet must provoke JAX's {rules}"
    assert _rows(got) == _rows(ref)


# ---------------------------------------------------------------------------
# Spelling pairs: R1, R6, R7
# ---------------------------------------------------------------------------

#: (rule, path, JAX spelling, torch spelling, flagged): the two sources
#: keep their flagged lines aligned.
PAIRS = {
    "R1-cast": ("R1", "ops/scratch.py", """
        import jax

        @jax.jit
        def f(x):
            return float(x.sum())
        """, """
        import torch

        @torch.no_grad()
        def f(x: torch.Tensor):
            return float(x.sum())
        """, True),
    "R1-item": ("R1", "models/scratch.py", """
        import jax

        @jax.jit
        def f(x):
            y = x * 2
            return y.item()
        """, """
        import torch

        @torch.no_grad()
        def f(x: torch.Tensor):
            y = x * 2
            return y.item()
        """, True),
    "R1-host-transfer": ("R1", "parallel/scratch.py", """
        import jax
        import numpy as np

        @jax.jit
        def f(x):
            y = x + 1
            return np.asarray(y)
        """, """
        import torch
        import numpy as np

        @torch.no_grad()
        def f(x: torch.Tensor):
            y = x + 1
            return y.cpu()
        """, True),
    "R1-shape-read-is-clean": ("R1", "ops/scratch.py", """
        import jax

        @jax.jit
        def f(x):
            return x * float(x.shape[0])
        """, """
        import torch

        @torch.no_grad()
        def f(x: torch.Tensor):
            return x * float(x.shape[0])
        """, False),
    "R1-static-argument-is-clean": ("R1", "ops/scratch.py", """
        import functools
        import jax

        @functools.partial(jax.jit, static_argnums=1)
        def f(x, n):
            return x * int(n)
        """, """
        import functools
        import torch

        @torch.no_grad()
        def f(x: torch.Tensor, n: int):
            return x * int(n)
        """, False),
    "R6-sync": ("R6", "workflows/scratch.py", """
        import jax

        def drain(xs, step):
            for x in xs:
                jax.block_until_ready(step(x))
        """, """
        import torch

        def drain(xs, step):
            for x in xs:
                step(x); torch.cuda.synchronize()
        """, True),
    "R6-item": ("R6", "io/scratch.py", """
        def total(xs, step):
            out = 0.0
            for x in xs:
                out += step(x).item()
            return out
        """, """
        def total(xs, step):
            out = 0.0
            for x in xs:
                out += step(x).item()
            return out
        """, True),
    "R6-transfer": ("R6", "models/scratch.py", """
        import jax

        def gather(xs, step):
            for x in xs:
                yield jax.device_get(step(x))
        """, """
        import torch

        def gather(xs, step):
            for x in xs:
                yield step(x).cpu()
        """, True),
    "R6-np-asarray-of-a-result": ("R6", "parallel/scratch.py", """
        import numpy as np

        def loop(xs, step):
            for x in xs:
                yield np.asarray(step(x))
        """, """
        import numpy as np

        def loop(xs, step):
            for x in xs:
                yield np.asarray(step(x))
        """, True),
    "R6-sync-after-the-loop-is-clean": ("R6", "workflows/scratch.py", """
        import jax

        def drain(xs, step):
            ys = [step(x) for x in xs]
            return jax.block_until_ready(ys)
        """, """
        import torch

        def drain(xs, step):
            ys = [step(x) for x in xs]
            return torch.cuda.synchronize()
        """, False),
    "R7-unblocked": ("R7", "parallel/scratch.py", """
        import time
        import jax

        def timed(step, x):
            t0 = time.perf_counter()
            y = step(x)
            return y, time.perf_counter() - t0
        """, """
        import time
        import torch

        def timed(step, x):
            t0 = time.perf_counter()
            y = step(x)
            return y, time.perf_counter() - t0
        """, True),
    "R7-async-asarray-does-not-clear": ("R7", "ops/scratch.py", """
        import time
        import jax.numpy as jnp

        def timed(x):
            t0 = time.perf_counter()
            y = jnp.asarray(x)
            return y, time.perf_counter() - t0
        """, """
        import time
        import torch

        def timed(x):
            t0 = time.perf_counter()
            y = torch.asarray(x)
            return y, time.perf_counter() - t0
        """, True),
    "R7-synced-is-clean": ("R7", "parallel/scratch.py", """
        import time
        import jax

        def timed(step, x):
            t0 = time.perf_counter()
            y = jax.block_until_ready(step(x))
            return y, time.perf_counter() - t0
        """, """
        import time
        import torch

        def timed(step, x):
            t0 = time.perf_counter()
            y = step(x); torch.cuda.synchronize()
            return y, time.perf_counter() - t0
        """, False),
    "R7-counted-fetch-is-clean": ("R7", "workflows/scratch.py", """
        import time
        from das4whales_tpu.parallel import dispatch

        def timed(step, x):
            t0 = time.perf_counter()
            y = dispatch.fetch(dispatch.launch(step, x))
            return y, time.perf_counter() - t0
        """, """
        import time
        from das4whales_tpu_torch.parallel import dispatch

        def timed(step, x):
            t0 = time.perf_counter()
            y = dispatch.fetch(dispatch.launch(step, x))
            return y, time.perf_counter() - t0
        """, False),
}


@pytest.mark.parametrize("case", sorted(PAIRS), ids=str)
def test_spelling_pair_is_flagged_at_the_same_lines(case):
    rule, p, jsrc, tsrc, flagged = PAIRS[case]
    ref = [f.line for f in _jax(jsrc, p, (rule,))]
    got = [f.line for f in _port(tsrc, p, (rule,))]
    assert sorted(got) == sorted(ref)
    assert bool(got) is flagged


# ---------------------------------------------------------------------------
# Anchoring: the port's scopes are spelled das4whales_tpu_torch/...
# ---------------------------------------------------------------------------

SCOPED = {
    "R1": ("ops/x.py", "import torch\n\ndef f(x: torch.Tensor):\n    return x.item()\n"),
    "R3": ("models/x.py", "import torch\n\ndef f(x):\n    return x.to(torch.float64)\n"),
    "R6": ("io/x.py", "def f(xs):\n    for x in xs:\n        x.cpu()\n"),
    "R7": ("workflows/x.py", "import time\n\ndef f(g):\n    t0 = time.perf_counter()\n"
           "    g()\n    return time.perf_counter() - t0\n"),
    "R8": ("fleet/x.py", SHARED["R8-guarded-by-pin"][2]),
    "R10": ("io/stream.py", "import threading\n\ndef f(g):\n"
            "    threading.Thread(target=g).start()\n"),
    "R11": ("ops/x.py", "import torch\n\ndef f(x):\n    return x.bfloat16()\n"),
    "R14": ("utils/x.py", "def f(d):\n    open(d + '/m.json', 'w')\n"),
}


@pytest.mark.parametrize("rule", sorted(SCOPED), ids=str)
def test_scoped_rule_fires_on_a_port_path_only(rule):
    """Scopes are read below the port's package root: the rule fires on
    the port path, and not on an out-of-scope port module whose checkout
    sits under a directory named like the scope (nor, for the rules
    scoped by file, on the JAX package's spelling of the file)."""
    p, src = SCOPED[rule]
    src = textwrap.dedent(src)
    on_port = analysis.analyze_source(src, f"/x/das4whales_tpu_torch/{p}", (rule,))
    assert on_port and {f.rule for f in on_port} == {rule}
    assert on_port[0].path == f"das4whales_tpu_torch/{p}"
    if rule == "R14":   # unscoped: only its write layer is exempt
        return
    scope_dir = p.split("/")[0]
    elsewhere = f"/{scope_dir}/checkout/das4whales_tpu_torch/viz/x.py"
    assert analysis.analyze_source(src, elsewhere, (rule,)) == []
    if p == "io/stream.py":
        assert analysis.analyze_source(src, f"das4whales_tpu/{p}", (rule,)) == []


@pytest.mark.parametrize("exempt", [
    ("R3", "ops/fk.py", "import torch\n\ndef f(x):\n    return x.double()\n"),
    ("R11", "ops/mxu.py", "import torch\n\ndef correlate_taps(x):\n"
     "    return x.to(torch.bfloat16).to(torch.float32)\n"),
    ("R14", "utils/artifacts.py", "def f(d):\n    open(d + '/m.json', 'w')\n"),
], ids=lambda e: e[0])
def test_allowlisted_port_sites_are_clean(exempt):
    rule, p, src = exempt
    assert analysis.analyze_source(src, f"das4whales_tpu_torch/{p}", (rule,)) == []


def test_a_tensor_cast_in_a_loop_is_r6_and_a_mapping_s_keys_are_not_tensors():
    src = textwrap.dedent("""
        from typing import Dict
        import torch

        def f(x: torch.Tensor, corr: Dict[str, torch.Tensor]):
            out = {}
            for name, c in corr.items():
                scale = 0.9 if name == "HF" else 1.0
                out[name] = float(scale) + float(c.amax())
            for i in range(3):
                out[i] = int(x[i])
            return out
        """)
    got = [(f.rule, f.code, f.line) for f in _port(src, "models/x.py", ("R1", "R6"))]
    assert got == [("R1", "host-sync-cast", 9), ("R6", "cast-in-loop", 9),
                   ("R1", "host-sync-cast", 11), ("R6", "cast-in-loop", 11)]


def test_inline_allow_and_ignore_suppress():
    src = ("import torch\n\ndef f(x: torch.Tensor):\n"
           "    a = x.item()  # daslint: allow[R1]\n"
           "    # daslint: ignore\n    return x.cpu()\n")
    assert _port(src, "ops/x.py", ("R1",)) == []


# ---------------------------------------------------------------------------
# Baseline: parity, round trip, caps, stale keys
# ---------------------------------------------------------------------------

BASELINE_TEXT = '''\
# a comment
[[finding]]
rule = "R8"
path = "das4whales_tpu_torch/service/x.py"
symbol = "A.b"
code = "unsynchronized-shared-state"
count = 2
reason = "a \\"quoted\\" reason"

[[finding]]
rule = "R6"
path = "das4whales_tpu_torch/io/y.py"
symbol = "<module>"
'''


def test_baseline_text_parses_the_same_in_both_packages():
    assert baseline_mod.parse(BASELINE_TEXT) == jbaseline.parse(BASELINE_TEXT)
    with pytest.raises(baseline_mod.BaselineError):
        baseline_mod.parse("rule = \"R1\"\n")


def _f(rule="R6", path="das4whales_tpu_torch/io/y.py", symbol="f", line=1):
    return analysis.Finding(rule=rule, code="c", path=path, line=line, col=0, symbol=symbol,
                            message="m")


def test_baseline_round_trip_caps_and_stale_keys(tmp_path):
    fs = [_f(line=1), _f(line=9), _f(rule="R8", path="das4whales_tpu_torch/service/x.py",
                                   symbol="A.b")]
    path = tmp_path / "b.toml"
    path.write_text(baseline_mod.dump(fs, {fs[0].key(): "why"}))
    bl = baseline_mod.load(path)
    assert bl == {fs[0].key(): 2, fs[2].key(): 1}
    assert baseline_mod.reasons_of(path) == {fs[0].key(): "why"}
    # a third finding at a baselined key is above its count: the new one
    new, supp = baseline_mod.apply(fs + [_f(line=20)], bl)
    assert [f.line for f in new] == [20] and len(supp) == 3
    # a fixed hazard leaves its entry stale, judged only where scanned
    live = fs[:2]
    assert baseline_mod.stale_keys(live, bl) == [fs[2].key()]
    assert baseline_mod.stale_keys(live, bl, rules=("R6",)) == []
    assert baseline_mod.stale_keys(live, bl, scanned_paths=[fs[0].path]) == []


# ---------------------------------------------------------------------------
# The port's gate and its command line
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def package_findings():
    return analysis.analyze_paths([str(PORT)])


def test_port_is_clean_against_its_baseline_with_no_stale_entry(package_findings):
    assert not [f for f in package_findings if f.rule == "E0"]
    bl = baseline_mod.load(analysis.DEFAULT_BASELINE)
    new, suppressed = baseline_mod.apply(package_findings, bl)
    assert not new, "\n".join(f.format() for f in new)
    assert suppressed
    assert baseline_mod.stale_keys(package_findings, bl) == []
    # every entry names its own site's reason
    entries = baseline_mod.parse(open(analysis.DEFAULT_BASELINE).read())
    reasons = [e.get("reason", "") for e in entries]
    assert all(len(r) > 40 for r in reasons) and len(set(reasons)) == len(reasons)
    assert all(str(e["path"]).startswith("das4whales_tpu_torch/") for e in entries)


def test_cli_red_on_an_injected_hazard_then_green_after_write_baseline(tmp_path, capsys):
    ops = tmp_path / "das4whales_tpu_torch" / "ops"
    ops.mkdir(parents=True)
    bad = ops / "scratch.py"
    bad.write_text("import torch\n\ndef f(x):\n    return x.to(torch.float64)\n")
    bl = tmp_path / "baseline.toml"
    argv = [str(bad), "--baseline", str(bl), "--check"]
    assert daslint_main(argv + ["--rules", "R3"]) == 1
    assert "das4whales_tpu_torch/ops/scratch.py:4:" in capsys.readouterr().out
    assert daslint_main(argv + ["--write-baseline"]) == 0
    assert daslint_main(argv) == 0
    assert daslint_main([str(bad), "--rules", "R2"]) == 2      # no R2 in the port
    # the default path is the port, clean against the shipped baseline
    assert daslint_main(["--check", "--rules", "R8,R9,R10"]) == 0


def test_programs_without_a_card_raise_rather_than_run_on_the_cpu(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: --programs records there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        daslint_main([str(tmp_path), "--programs", "--no-baseline"])
