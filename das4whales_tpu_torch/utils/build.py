"""Build the port's CUDA kernels with ``nvcc`` at first use.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``build/kernels/<name>-<hash>.so`` at the repository root (a
directory ``.gitignore`` lists), where ``<hash>`` covers the source and
that kernel's own flags (:func:`nvcc_flags`), so an edited kernel never
loads a stale library. The library
is loaded with ``ctypes``; callers declare ``argtypes`` with
``ctypes.c_void_p`` for every pointer and the stream, so no pointer is
cut to 32 bits. A failed build raises with the compiler's output: there
is no fallback.

Build commands run in this process's caller, never at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

#: Hopper only: ``sm_90a`` keeps the arch-specific instructions available
#: to later kernels. ``-fmad=false`` stops the compiler contracting a
#: multiply and an add into an FMA, so float arithmetic in the kernels
#: rounds exactly as PyTorch's separate elementwise kernels do.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: Kernels compared with their plain version by tolerance, not bit for
#: bit, keep FMA contraction on: ``-fmad=false`` would split every FMA of
#: a contraction in two and halve its float32 rate.
FMA_KERNELS = frozenset({"fused_stft"})


def nvcc_flags(name: str) -> tuple:
    """The flags ``csrc/<name>.cu`` is compiled with."""
    if name in FMA_KERNELS:
        return tuple(f for f in NVCC_FLAGS if f != "-fmad=false")
    return NVCC_FLAGS


def nvcc_path() -> str:
    """``nvcc`` on ``PATH``, else under ``CUDA_HOME`` or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and under CUDA_HOME or "
        "/usr/local/cuda); the CUDA kernels are built from source at first use"
    )


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes() + " ".join(nvcc_flags(name)).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(name: str) -> tuple[Path, float, str]:
    """Compile ``csrc/<name>.cu`` unless its library already exists.
    Returns ``(library path, seconds spent compiling, ptxas report)``;
    the seconds are 0.0 when the library was already built."""
    out = library_path(name)
    log = out.with_suffix(".log")
    if out.exists():
        return out, 0.0, log.read_text() if log.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: two processes building at
    # once each produce a whole library and the last rename wins
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *nvcc_flags(name), "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed to build {name} (exit {proc.returncode}):\n"
            f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
        )
    report = proc.stdout + proc.stderr
    log.write_text(report)
    os.replace(tmp, out)
    return out, seconds, report


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, compiled on first use.
    Memoized per process: the library is content-addressed, so the cache
    can only ever hold the one build of the current source."""
    path, _, _ = build(name)
    return ctypes.CDLL(str(path))
