#!/usr/bin/env python3
"""A/B of the PyTorch port's CUDA pick kernel between source trees, on one card.

    python3 scripts/ab_torch_picks.py TREE [TREE ...]

Each TREE is the root of a checkout of this repository, for example the
parent commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists, and ``.`` for this one. Give the trees in the order
to run them, as in ``PARENT . . PARENT``. For each, a process of its own
puts the tree first on ``sys.path``, builds the tree's
``das4whales_tpu_torch/csrc/fused_picks.cu`` and runs the tree's
``ops.fused_picks.picks_cuda`` at ``chip_smoke.py``'s main launch (1024
rows x 12000 samples from the same seed, ``pack`` K=64 and ``topk``
K=256). It checks the five outputs bitwise against the tree's own
``picks_plain`` and times a call three ways, with this tree's
``chip_smoke.py`` timers for every tree: a call by CUDA events (20 in a
row), the device time a launch (``torch.profiler``) and the host time a
call. One JSON line a run, then a table. Needs one CUDA card.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
CASES = (("pack", 64), ("topk", 256))


def _timers():
    """This tree's ``chip_smoke.py``, loaded by path: the same timers for
    every tree, whichever ``chip_smoke`` the tree under test carries."""
    spec = importlib.util.spec_from_file_location("ab_chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_one(tree: Path) -> dict:
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    from das4whales_tpu_torch.ops import fused_picks, spectral

    cs = _timers()
    if not torch.cuda.is_available():
        cs.fail("ab: no CUDA device")
    rows, T = 1024, cs.CANONICAL[1]
    rng = np.random.default_rng(cs.SEED)
    corr = torch.as_tensor(rng.standard_normal((rows, T)).astype(np.float32), device="cuda")
    X = spectral.analytic_signal(corr)
    thr = torch.as_tensor(np.linspace(2.0, 4.5, rows).astype(np.float32), device="cuda")
    out = {"tree": str(tree), "module": fused_picks.__file__}
    for method, K in CASES:
        cs._compare(fused_picks.picks_cuda(X, thr, K, method),
                    fused_picks.picks_plain(X, thr, K, method))
        call = lambda: fused_picks.picks_cuda(X, thr, K, method)  # noqa: E731
        out[method] = {"call_ms": cs._cuda_ms(call, 20),
                       "device_ms": cs._device_ms(call, 20, "fused_picks"),
                       "host_us": cs._host_us(call, 200)}
    return out


def main(argv: list[str]) -> int:
    if len(argv) >= 2 and argv[0] == "--one":
        print(json.dumps(run_one(Path(argv[1]).resolve())), flush=True)
        return 0
    if not argv:
        print(__doc__)
        return 2
    runs = []
    for tree in argv:
        p = subprocess.run([sys.executable, __file__, "--one", tree], capture_output=True,
                           text=True, timeout=900)
        if p.returncode != 0:
            print(p.stdout[-4000:] + p.stderr[-4000:], flush=True)
            print(f"FAIL ab: the run of {tree} exited {p.returncode}", flush=True)
            return 1
        runs.append(json.loads(p.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    print("| run | tree | " + " | ".join(
        f"{m} K={k} call ms | device ms | host us" for m, k in CASES) + " |")
    print("| --- | --- | " + " | ".join("--- | --- | ---" for _ in CASES) + " |")
    for i, r in enumerate(runs):
        print(f"| {i + 1} | {r['tree']} | " + " | ".join(
            f"{r[m]['call_ms']:.4f} | {r[m]['device_ms']:.4f} | {r[m]['host_us']:.1f}"
            for m, _ in CASES) + " |")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
