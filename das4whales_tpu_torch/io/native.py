"""ctypes binding for the native C++ ingest engine (host side).

The port's copy of ``das4whales_tpu.io.native``, over its own copy of the
engine (``das4whales_tpu_torch/native/ingest.cpp``). h5py is consulted
once per file for metadata and the contiguous dataset byte offset; the
C++ engine then pread()s the strided channel selection in parallel and
fuses int->float32 + demean + scale-to-strain into the same pass. An
async submit/wait pipeline (:class:`Prefetcher`) overlaps the host read
of file k+1 with the card's compute on file k.

The library is compiled with ``g++`` at first use into ``build/native/``
at the repository root (a directory ``.gitignore`` lists), named by a
hash of the source and flags, so an edited source never loads a stale
library. :func:`available` is False where it cannot be built;
``engine="auto"`` readers then take h5py, and ``engine="native"`` raises.
Set ``DAS4WHALES_NO_NATIVE=1`` to disable it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "native" / "ingest.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-shared")

#: dtype codes shared with ingest.cpp (enum DType).
_DTYPE_CODES = {
    np.dtype(np.int16): 0,
    np.dtype(np.int32): 1,
    np.dtype(np.float32): 2,
    np.dtype(np.float64): 3,
}

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_failed = False


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libdasingest-{digest}.so"


#: seconds the last compile of :func:`build` took in this process (0.0
#: while none ran: the library was already built)
build_seconds = 0.0


def build() -> Path:
    """Compile ``native/ingest.cpp`` unless its library exists; returns
    its path. Raises ``RuntimeError`` with the compiler's output when
    ``g++`` fails."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build to a private name and publish with an atomic rename, so
    # concurrent first-use builds never load a partly written library
    tmp = out.with_name(f"{out.name}.build.{os.getpid()}.{threading.get_ident()}")
    cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as exc:
        raise RuntimeError(f"g++ could not build the ingest engine: {exc}") from exc
    if proc.returncode != 0:
        if tmp.exists():
            tmp.unlink()
        raise RuntimeError(f"g++ failed to build the ingest engine:\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library, or None where it
    cannot be built or loaded."""
    global _lib, _lib_failed
    if _lib is not None:
        return _lib
    if _lib_failed or os.environ.get("DAS4WHALES_NO_NATIVE"):
        return None
    with _lib_lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError):
            _lib_failed = True
            return None
        lib.dw_abi_version.restype = ctypes.c_int32
        lib.dw_read_strided.restype = ctypes.c_int32
        lib.dw_read_strided.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_double, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.dw_raw2strain_f32.restype = ctypes.c_int32
        lib.dw_raw2strain_f32.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_double, ctypes.c_int32,
        ]
        lib.dw_pipe_create.restype = ctypes.c_void_p
        lib.dw_pipe_create.argtypes = [ctypes.c_int32, ctypes.c_int32]
        lib.dw_pipe_destroy.argtypes = [ctypes.c_void_p]
        lib.dw_pipe_submit.restype = ctypes.c_int64
        lib.dw_pipe_submit.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_double,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.dw_pipe_wait.restype = ctypes.c_int32
        lib.dw_pipe_wait.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        if lib.dw_abi_version() != 1:
            _lib_failed = True
            return None
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def contiguous_layout(dataset):
    """(byte_offset, numpy_dtype) of an h5py dataset if the native engine
    can read it directly (contiguous, uncompressed, supported dtype);
    None otherwise."""
    try:
        if dataset.chunks is not None or dataset.compression is not None:
            return None
        offset = dataset.id.get_offset()
        if offset is None:
            return None
        dt = np.dtype(dataset.dtype)
        if dt not in _DTYPE_CODES:
            return None
        return int(offset), dt
    except Exception:
        return None


def _float_ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def read_strided(
    path: str,
    offset: int,
    dtype: np.dtype,
    nx: int,
    ns: int,
    start: int,
    stop: int,
    step: int,
    *,
    fuse: bool = True,
    scale: float = 1.0,
    nthreads: int | None = None,
    out: np.ndarray | None = None,
) -> np.ndarray:
    """Strided channel read (+ fused demean/scale when ``fuse``) into a
    float32 ``[n_sel x ns]`` array."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native ingest engine unavailable")
    n_sel = len(range(start, stop, step))
    if out is None:
        out = np.empty((n_sel, ns), dtype=np.float32)
    elif out.shape != (n_sel, ns) or out.dtype != np.float32 or not out.flags.c_contiguous:
        # real checks, not asserts: the C++ side writes n_sel*ns floats
        # through this pointer, so a wrong buffer is memory corruption
        raise ValueError(
            f"out must be C-contiguous float32 of shape {(n_sel, ns)}, "
            f"got {out.dtype} {out.shape}"
        )
    if n_sel == 0:
        # valid-but-empty selection: the C engine rejects it with -22, but a
        # user slicing an empty range deserves the h5py-style empty block
        return out
    rc = lib.dw_read_strided(
        path.encode(), offset, _DTYPE_CODES[np.dtype(dtype)], nx, ns,
        start, stop, step, int(fuse), float(scale),
        nthreads or os.cpu_count() or 4, _float_ptr(out),
    )
    if rc != 0:
        raise IOError(f"native read failed (code {rc}) for {path}")
    return out


def read_strided_raw(
    path: str,
    offset: int,
    dtype: np.dtype,
    nx: int,
    ns: int,
    start: int,
    stop: int,
    step: int,
) -> np.ndarray:
    """Strided channel read of the STORED dtype, no conditioning — the
    narrow wire format (``io.stream`` ``wire="raw"``): raw interrogator
    counts cross host→device untouched (int16 stays 2 bytes/sample) and
    demean/scale runs on device (``ops.conditioning``). Consumes the same
    ``contiguous_layout`` probe as the fused C++ path but needs only a
    numpy memmap, so it works even where the engine failed to build."""
    mm = np.memmap(path, dtype=np.dtype(dtype), mode="r", offset=offset,
                   shape=(nx, ns))
    try:
        return np.ascontiguousarray(mm[start:stop:step])
    finally:
        del mm


def raw2strain_inplace(block: np.ndarray, scale: float, nthreads: int | None = None) -> np.ndarray:
    """Threaded in-place demean+scale of a float32 [nx x ns] block."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native ingest engine unavailable")
    if block.dtype != np.float32 or block.ndim != 2 or not block.flags.c_contiguous:
        raise ValueError("block must be a C-contiguous 2-D float32 array")
    rc = lib.dw_raw2strain_f32(_float_ptr(block), block.shape[0], block.shape[1],
                               float(scale), nthreads or os.cpu_count() or 4)
    if rc != 0:
        raise IOError(f"native raw2strain failed (code {rc})")
    return block


class Prefetcher:
    """Async submit/wait front-end over the native pipeline.

    Workers write directly into the numpy buffer allocated at submit time
    (zero internal copies); ``wait`` blocks until that buffer is complete.
    Typical double-buffered use::

        pf = Prefetcher()
        t0 = pf.submit(spec0); t1 = pf.submit(spec1)
        block0 = pf.wait(t0)          # compute on block0 while spec1 loads
    """

    def __init__(self, nworkers: int = 2, io_threads_per_job: int | None = None):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native ingest engine unavailable")
        self._lib = lib
        self._handle = lib.dw_pipe_create(
            nworkers, io_threads_per_job or max(1, (os.cpu_count() or 4) // nworkers)
        )
        self._pending: dict[int, np.ndarray] = {}
        self._lock = threading.Lock()

    def submit(self, path, offset, dtype, nx, ns, start, stop, step,
               *, fuse=True, scale=1.0) -> int:
        if self._handle is None:
            raise RuntimeError("Prefetcher is closed")
        n_sel = len(range(start, stop, step))
        out = np.empty((n_sel, ns), dtype=np.float32)
        ticket = self._lib.dw_pipe_submit(
            self._handle, path.encode(), offset, _DTYPE_CODES[np.dtype(dtype)],
            nx, ns, start, stop, step, int(fuse), float(scale), _float_ptr(out),
        )
        with self._lock:
            self._pending[int(ticket)] = out
        return int(ticket)

    def wait(self, ticket: int) -> np.ndarray:
        if self._handle is None:
            raise RuntimeError("Prefetcher is closed")
        with self._lock:
            if ticket not in self._pending:
                # an unknown/already-consumed ticket would block on the
                # completion cv forever; claiming the buffer inside the
                # lock also makes concurrent double-waits race-free
                raise KeyError(f"unknown or already-waited ticket {ticket}")
            out = self._pending.pop(ticket)
        rc = self._lib.dw_pipe_wait(self._handle, ticket)
        if rc != 0:
            raise IOError(f"native prefetch failed (code {rc})")
        return out

    def close(self):
        if self._handle is not None:
            self._lib.dw_pipe_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
