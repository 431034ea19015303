"""das4whales_tpu_torch.analysis — hazard analysis of the port (the
counterpart of ``das4whales_tpu.analysis``).

Three halves, one invariant ("the work stays on the card, in the intended
dtype, and what is done once per shape is done once"):

* **Static** (:mod:`.rules`, :mod:`.concurrency`, :mod:`.baseline`): an
  AST linter with the rules that have a meaning for eager PyTorch (R1,
  R3, R6–R11, R14, R15; :mod:`.rules` says why R2, R4, R5 and R12 have
  none), gated against the port's own ``baseline.toml``. CLI: ``python
  -m das4whales_tpu_torch.analysis``.
* **Program** (:mod:`.programs`): the R11/R13 contract audit over the
  recorded stream of aten operations of a priced program's run, the one
  the memory preflight's probe makes (no program runs twice), with the
  two hand-written kernels as one entry each. CLI: ``--programs`` /
  ``--write-contracts``; snapshot: ``contracts.json``.
* **Runtime** (:mod:`.runtime`, :mod:`.concurrency_runtime`,
  :mod:`.pytest_plugin`): the probe-and-build count guard, the seeded
  interleaving guard over ``utils.locks`` and the retrace forensics,
  as the ``torch_compile_guard`` / ``torch_race_guard`` /
  ``torch_retrace_guard`` fixtures.

The static half is pure stdlib; only :mod:`.programs` (to record a run),
:mod:`.runtime` and the guards import torch or the port, and only when
they are used.
"""

import os as _os

from .baseline import apply as apply_baseline  # noqa: F401
from .baseline import dump as dump_baseline  # noqa: F401
from .baseline import load as load_baseline  # noqa: F401
from .baseline import stale_keys as stale_baseline_keys  # noqa: F401
from .rules import (  # noqa: F401
    ALL_RULES,
    FLOAT64_DESIGN_ALLOWLIST,
    PROGRAM_RULES,
    Finding,
    analyze_file,
    analyze_paths,
    analyze_source,
    canonical_path,
    iter_python_files,
)

#: The shipped baseline, package-relative: the gate's default ledger.
DEFAULT_BASELINE = _os.path.join(_os.path.dirname(__file__), "baseline.toml")
