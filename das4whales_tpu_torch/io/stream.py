"""Multi-file streaming: ordered host reads, placement on the card through
pinned memory (the port's copy of ``das4whales_tpu.io.stream``).

Ingest of file k+1 overlaps the card's compute on file k: the native C++
engine (``io.native``) or an ordered thread pool reads and conditions
ahead, strictly in submission order. A block bound for the card crosses
through a pinned staging buffer on a side stream (``io.staging``); the
consumer's stream waits on the copy's event, and the block's memory is
kept from reuse until the consumer is done with it. Nothing falls back
to a pageable copy: when pinning or the side stream fails, the stream
raises.

``wire="raw"`` streams the stored dtype (int16 TDMS counts, int32 or
float32 OptaSense) untouched, and the demean + scale runs on the card in
the consuming detector (``ops.conditioning``).

:func:`stream_batched_slabs` groups consecutive same-bucket files into
``[B, C, T_bucket]`` slabs for the batched detector (``parallel.batch``).
On the card it allocates each slab there and copies each file's real
``[C, n_real]`` samples into its slice as soon as the file is read,
zeroing the pad and the empty file slots on the card: the host never
builds the padded stack, and the pinned pool holds two file-sized
buffers however large the slab. ``as_numpy=True`` yields the padded host
stack instead (:func:`assemble_slab`), which :func:`subdivide_slab`
rebuilds from.

Not in this slice: ``read_deadline_s`` and ``fault_plan`` come with the
campaign (ROADMAP item 'Campaign'), the telemetry spans with it, and
``stream_file_batches`` (the sharded multi-device stacks) with
'Multi-GPU'.
"""

from __future__ import annotations

import dataclasses
import functools
import queue
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np
import torch

from ..config import (
    AcquisitionMetadata,
    ChannelSelection,
    as_bucket_config,
    as_metadata,
)
from ..config import not_in_slice as _not_in_slice
from ..utils.device import resolve_device
from . import native
from .hdf5 import StrainBlock, assemble_block
from .interrogators import get_acquisition_parameters
from .staging import PinnedStager, torch_dtype

WIRE_FORMATS = ("conditioned", "raw")


def _check_not_in_slice(read_deadline_s, fault_plan, sharding) -> None:
    if read_deadline_s is not None:
        raise _not_in_slice("read_deadline_s", "Campaign")
    if fault_plan is not None:
        raise _not_in_slice("fault_plan", "Campaign")
    if sharding is not None:
        raise _not_in_slice("sharding", "Multi-GPU")


@dataclass
class _FileSpec:
    path: str
    meta: AcquisitionMetadata
    t0_us: int
    layout: tuple | None  # (offset, disk_dtype, nx, ns) when natively readable


def _is_tdms(path: str) -> bool:
    return path.lower().endswith(".tdms")


def _probe(path: str, interrogator: str, metadata) -> _FileSpec:
    if _is_tdms(path) and metadata is None and interrogator == "optasense":
        interrogator = "silixa"  # the extension beats the h5-centric default
    meta = as_metadata(metadata) if metadata is not None else get_acquisition_parameters(
        path, interrogator=interrogator
    )
    if _is_tdms(path) or meta.interrogator == "silixa":
        # a single-segment contiguous TDMS file reads through the same
        # native engine as HDF5; irregular files keep the host parser,
        # which reads the GPS t0 during its own parse
        if native.available():
            from .tdms import contiguous_layout as _tdms_layout

            lay = _tdms_layout(path)
            if lay is not None:
                off, dt, nx, ns, t0_us = lay
                return _FileSpec(path=path, meta=meta, t0_us=t0_us,
                                 layout=(off, dt, nx, ns))
        return _FileSpec(path=path, meta=meta, t0_us=0, layout=None)
    import h5py

    layout = None
    with h5py.File(path, "r") as fp:
        raw = fp["Acquisition/Raw[0]/RawData"]
        t0_us = int(fp["Acquisition/Raw[0]/RawDataTime"][0])
        if native.available():
            lay = native.contiguous_layout(raw)
            if lay is not None:
                layout = (lay[0], lay[1], raw.shape[0], raw.shape[1])
    return _FileSpec(path=path, meta=meta, t0_us=t0_us, layout=layout)


# The host readers return (block, read seconds, host conditioning seconds).

def _read_h5py_host(spec: _FileSpec, sel: ChannelSelection) -> tuple:
    import h5py

    t0 = time.perf_counter()
    with h5py.File(spec.path, "r") as fp:
        block = fp["Acquisition/Raw[0]/RawData"][sel.start : sel.stop : sel.step, :]
    t1 = time.perf_counter()
    x = block.astype(np.float32)
    x -= x.mean(axis=1, keepdims=True)
    x *= spec.meta.scale_factor
    return x, t1 - t0, time.perf_counter() - t1


def _read_tdms_host(spec: _FileSpec, sel: ChannelSelection, raw: bool = False) -> tuple:
    """Read a Silixa TDMS file (conditioning on the host unless ``raw``),
    taking ``spec.t0_us`` from its ``GPSTimeStamp`` property when present."""
    from .tdms import read_measurement_block

    t0 = time.perf_counter()
    x, t0_us = read_measurement_block(spec.path, sel.start, sel.stop, sel.step, raw=raw)
    t1 = time.perf_counter()
    if not raw:
        x -= x.mean(axis=1, keepdims=True)
        x *= spec.meta.scale_factor
    if t0_us is not None:
        spec.t0_us = t0_us
    return x, t1 - t0, time.perf_counter() - t1


def _read_host(spec: _FileSpec, sel: ChannelSelection) -> tuple:
    if _is_tdms(spec.path) or spec.meta.interrogator == "silixa":
        return _read_tdms_host(spec, sel)
    return _read_h5py_host(spec, sel)


def _read_host_raw(spec: _FileSpec, sel: ChannelSelection, engine: str = "auto") -> tuple:
    """Narrow-wire host read: the stored dtype, untouched. Natively probed
    layouts go through a numpy memmap; irregular files through their
    format reader with conditioning skipped. ``engine="h5py"`` forces the
    format readers, ``"native"`` raises on files without a layout."""
    t0 = time.perf_counter()
    if engine != "h5py" and spec.layout is not None:
        offset, dt, nx, ns = spec.layout
        x = native.read_strided_raw(spec.path, offset, dt, nx, ns, sel.start,
                                    min(sel.stop, nx), sel.step)
        return x, time.perf_counter() - t0, 0.0
    if engine == "native":
        raise ValueError(
            f"{spec.path} is not natively readable but the stream started "
            "on the native engine; pass engine='h5py' for mixed file sets"
        )
    if _is_tdms(spec.path) or spec.meta.interrogator == "silixa":
        return _read_tdms_host(spec, sel, raw=True)
    import h5py

    with h5py.File(spec.path, "r") as fp:
        x = fp["Acquisition/Raw[0]/RawData"][sel.start : sel.stop : sel.step, :]
    return x, time.perf_counter() - t0, 0.0


class _Placed:
    """A block on the card whose copy may still be in flight: handed over
    to the consumer's stream at yield time."""

    def __init__(self, tensor, ready):
        self.tensor, self.ready = tensor, ready

    def hand_over(self) -> torch.Tensor:
        return PinnedStager.hand_over(self.tensor, self.ready)


def stream_strain_blocks(
    files: Sequence[str],
    selected_channels,
    metadata=None,
    *,
    interrogator: str = "optasense",
    prefetch: int = 2,
    engine: str = "auto",
    device=None,
    sharding=None,
    as_numpy: bool = False,
    wire: str = "conditioned",
    overlap_transfers: bool | None = None,
    read_deadline_s: float | None = None,
    fault_plan=None,
) -> Iterator[StrainBlock]:
    """Yield :class:`StrainBlock`\\ s for ``files`` in order, reading ahead
    ``prefetch`` files while the caller computes.

    ``metadata`` may be None (probed per file), one metadata for all files,
    or a sequence aligned with ``files``. Each block lands on ``device``
    (``None``: the card; ``"cpu"``: a tensor sharing the host array), or
    stays host numpy with ``as_numpy=True``. On the card the copy goes
    through pinned memory on a side stream (module docstring);
    ``overlap_transfers`` (default on) starts file k+1's copy the moment
    its read completes, on the read worker, instead of at yield time.

    ``wire="raw"`` streams the STORED dtype untouched: ``.trace`` is raw
    counts and ``.wire == "raw"``. ``engine="auto"`` picks the native
    path iff the *first* file is natively readable; a later file that
    breaks that assumption raises — pass ``engine="h5py"`` for
    heterogeneous sets. Each block carries its host ``read_s`` and
    ``condition_s``.
    """
    _check_not_in_slice(read_deadline_s, fault_plan, sharding)
    if prefetch < 1:
        raise ValueError("prefetch must be >= 1")
    if engine not in ("auto", "native", "h5py"):
        raise ValueError(f"unknown engine {engine!r}; expected 'auto', 'native', or 'h5py'")
    if wire not in WIRE_FORMATS:
        raise ValueError(f"unknown wire {wire!r}; expected one of {WIRE_FORMATS}")
    if as_numpy and device is not None:
        raise ValueError("as_numpy=True returns host arrays; drop device")
    if as_numpy and overlap_transfers:
        raise ValueError("as_numpy=True never transfers; drop overlap_transfers")
    overlap = (not as_numpy) if overlap_transfers is None else bool(overlap_transfers)
    files = list(files)
    if not files:
        return
    dev = None if as_numpy else resolve_device(device)
    sel = ChannelSelection.from_list(selected_channels)
    metas = (
        [None] * len(files)
        if metadata is None
        else ([metadata] * len(files) if not isinstance(metadata, (list, tuple)) else list(metadata))
    )
    if len(metas) != len(files):
        raise ValueError(f"got {len(metas)} metadata entries for {len(files)} files")

    stager = PinnedStager(dev, n_buffers=prefetch + 1) if dev is not None and dev.type == "cuda" else None

    def place(host: np.ndarray):
        if stager is not None:
            return _Placed(*stager.place(host))
        return torch.from_numpy(np.ascontiguousarray(host))

    def finish(spec: _FileSpec, payload, read_s: float, cond_s: float) -> StrainBlock:
        if isinstance(payload, _Placed):
            payload = payload.hand_over()
        elif not as_numpy and isinstance(payload, np.ndarray):
            payload = place(payload)
            if isinstance(payload, _Placed):
                payload = payload.hand_over()
        blk = assemble_block(payload, spec.meta, sel, spec.t0_us, wire=wire)
        blk.read_s, blk.condition_s = read_s, cond_s
        return blk

    first = _probe(files[0], interrogator, metas[0])
    use_native = engine in ("auto", "native") and first.layout is not None
    if engine == "native" and not use_native:
        raise ValueError(f"engine='native' but {files[0]} is not natively readable")

    # probe lazily, right before each read, and DEFER errors to the failing
    # file's own position in the yield order
    specs: dict[int, _FileSpec] = {0: first}

    def spec_for(i: int) -> _FileSpec:
        if i not in specs:
            specs[i] = _probe(files[i], interrogator, metas[i])
        return specs[i]

    if use_native and wire == "conditioned":
        yield from _native_stream(files, sel, specs, spec_for, prefetch, place, finish,
                                  as_numpy, overlap)
        return

    reader = functools.partial(_read_host_raw, engine=engine) if wire == "raw" else _read_host

    def probe_and_read(i):
        spec = spec_for(i) if i == 0 else _probe(files[i], interrogator, metas[i])
        host, read_s, cond_s = reader(spec, sel)
        if overlap and not as_numpy:
            # start the copy from the read worker, the moment the read is done
            return spec, place(host), read_s, cond_s
        return spec, host, read_s, cond_s

    with ThreadPoolExecutor(max_workers=prefetch, thread_name_prefix="das-read") as ex:
        futs = {i: ex.submit(probe_and_read, i) for i in range(min(prefetch, len(files)))}
        for i in range(len(files)):
            fut = futs.pop(i)
            nxt = i + prefetch
            if nxt < len(files):
                futs[nxt] = ex.submit(probe_and_read, nxt)
            yield finish(*fut.result())        # submission order


def _native_stream(files, sel, specs, spec_for, prefetch, place, finish, as_numpy, overlap):
    """The native-engine stream body: the C++ prefetcher reads and
    conditions ahead; with ``overlap`` the wait-and-copy handoff runs on
    an ordered transfer thread, so file k+1's copy starts during the
    consumer's work on file k. ``read_s`` is the time spent waiting on a
    file's fused read (its conditioning is inside it)."""
    n = len(files)

    with native.Prefetcher(nworkers=prefetch) as pf:
        def submit(i):
            try:
                spec = spec_for(i)
                if spec.layout is None:
                    raise ValueError(
                        f"{spec.path} is not natively readable but the stream "
                        "started on the native engine; pass engine='h5py' for "
                        "mixed file sets"
                    )
                offset, dt, nx, ns = spec.layout
                return pf.submit(spec.path, offset, dt, nx, ns,
                                 sel.start, min(sel.stop, nx), sel.step,
                                 fuse=True, scale=spec.meta.scale_factor)
            except Exception as exc:  # noqa: BLE001 — re-raised in order
                return ("__probe_error__", exc)

        tickets = {i: submit(i) for i in range(min(prefetch, n))}
        next_read = min(prefetch, n)

        def hand(j):
            ticket = tickets.pop(j)
            if isinstance(ticket, tuple) and ticket[0] == "__probe_error__":
                raise ticket[1]
            t0 = time.perf_counter()
            host = pf.wait(ticket)
            read_s = time.perf_counter() - t0
            return specs.pop(j), (host if as_numpy else place(host)), read_s, 0.0

        if not overlap or as_numpy:
            for i in range(n):
                if next_read < n and next_read <= i + prefetch:
                    tickets[next_read] = submit(next_read)
                    next_read += 1
                yield finish(*hand(i))
            return

        with ThreadPoolExecutor(max_workers=1, thread_name_prefix="das-h2d") as tx:
            handed = 0
            futs: deque = deque()
            for i in range(n):
                while next_read < min(n, i + prefetch + 1):
                    tickets[next_read] = submit(next_read)
                    next_read += 1
                # keep this file and one successor on the transfer thread
                while handed <= min(n - 1, i + 1):
                    futs.append(tx.submit(hand, handed))
                    handed += 1
                yield finish(*futs.popleft().result())


def stream_file_batches(*args, **kwargs):
    """The sharded ``[file x channel x time]`` stacks of the multi-device
    step; not in this slice."""
    raise _not_in_slice("stream_file_batches", "Multi-GPU")


# ---------------------------------------------------------------------------
# Batched-slab assembly (the single-card batched ingest)
# ---------------------------------------------------------------------------


@dataclass
class BatchSlab:
    """One assembled ``[B, channel, time]`` batch for the batched detector
    (``parallel.batch``).

    ``stack`` is the padded batch (a tensor on the stream's device, or
    host numpy with ``as_numpy=True``); file slots past ``n_valid`` are
    zeros. ``blocks``/``paths``/``n_real`` are aligned with the
    ``n_valid`` real files in stream order (``blocks`` keep their host
    traces); ``index0`` is the first file's index in the file list.
    ``bucket_ns`` is the padded time length; each file's real samples are
    ``stack[j, :, :n_real[j]]``. On the card, ``copies`` holds each
    file's ``(start event, end event, bytes)`` of its copy."""

    stack: object
    blocks: tuple
    paths: tuple
    index0: int
    bucket_ns: int
    n_real: tuple
    copies: tuple = ()

    @property
    def n_valid(self) -> int:
        return len(self.blocks)


def assemble_slab(blocks, paths, index0: int, batch: int,
                  bucket_ns: int) -> BatchSlab:
    """Stack same-bucket host blocks into one host :class:`BatchSlab` —
    THE bucket/padding rule of the batched ingest: every block is
    zero-padded on the time axis to ``bucket_ns`` and the stack holds the
    FULL ``batch`` file slots (trailing slots zero)."""
    blocks = tuple(blocks)
    if not 1 <= len(blocks) <= batch:
        raise ValueError(f"got {len(blocks)} blocks for a batch of {batch}")
    tr0 = np.asarray(blocks[0].trace)
    stack = np.zeros((batch, tr0.shape[0], int(bucket_ns)), tr0.dtype)
    n_reals = []
    for j, b in enumerate(blocks):
        tr = np.asarray(b.trace)
        stack[j, :, : tr.shape[1]] = tr
        n_reals.append(tr.shape[1])
    return BatchSlab(
        stack=stack, blocks=blocks, paths=tuple(paths), index0=int(index0),
        bucket_ns=int(bucket_ns), n_real=tuple(n_reals),
    )


def subdivide_slab(slab: BatchSlab, batch: int) -> list:
    """Split one :class:`BatchSlab` into host slabs of at most ``batch``
    files each, re-assembled from its host blocks (the device ``stack``
    is never touched). File order, paths, ``n_real`` and ``bucket_ns``
    are kept, so per-file picks are the same at every size."""
    if batch < 1:
        raise ValueError("batch must be >= 1")
    return [
        assemble_slab(slab.blocks[s : s + batch], slab.paths[s : s + batch],
                      slab.index0 + s, batch, slab.bucket_ns)
        for s in range(0, slab.n_valid, batch)
    ]


class SlabReadError(RuntimeError):
    """A file failed to probe/read/bucket during slab assembly.

    ``index`` is the culprit's position in the file list handed to the
    assembler and ``path`` its path — raised AFTER any partial slab of
    already-read earlier files has been yielded, so a campaign records
    exactly one failure and resumes at ``index + 1``.
    """

    def __init__(self, path: str, index: int, cause: Exception):
        super().__init__(f"{path}: {type(cause).__name__}: {cause}")
        self.path = path
        self.index = index
        self.cause = cause
        self.__cause__ = cause


def _bucketed_blocks(files, selected_channels, metadata, *, bucket_cfg, interrogator,
                     prefetch, engine, wire):
    """The ordered host blocks of ``files`` with their slab key
    ``(channels, bucket_ns, dtype)``: yields ``(i, block, key)``; a file
    that fails to probe, read or bucket raises :class:`SlabReadError`."""
    stream = stream_strain_blocks(
        files, selected_channels, metadata, interrogator=interrogator,
        prefetch=prefetch, engine=engine, as_numpy=True, wire=wire,
    )
    try:
        for i in range(len(files)):
            try:
                blk = next(stream)
                tr = np.asarray(blk.trace)
                b_ns = bucket_cfg.bucket_ns(tr.shape[1])
            except StopIteration:  # defensive: the stream ended early
                return
            except Exception as exc:  # noqa: BLE001 — per-file attribution
                raise SlabReadError(files[i], i, exc)
            yield i, blk, (tr.shape[0], b_ns, tr.dtype)
    finally:
        stream.close()


def _assemble_host_slabs(files, selected_channels, metadata, *, batch, **kw):
    """Host slabs: CONSECUTIVE same-key files, padded and stacked, strictly
    in file order (a key change flushes the current partial slab); on a
    read error the partial slab of earlier files comes first."""
    pending, idx0, cur_key = [], 0, None

    def flush():
        nonlocal pending
        slab = assemble_slab(pending, files[idx0 : idx0 + len(pending)], idx0, batch,
                             cur_key[1])
        pending = []
        return slab

    try:
        for i, blk, key in _bucketed_blocks(files, selected_channels, metadata, **kw):
            if pending and key != cur_key:
                yield flush()
            if not pending:
                idx0 = i
            cur_key = key
            pending.append(blk)
            if len(pending) == batch:
                yield flush()
    except SlabReadError:
        if pending:
            yield flush()
        raise
    if pending:
        yield flush()


def stream_batched_slabs(
    files: Sequence[str],
    selected_channels,
    metadata=None,
    *,
    batch: int,
    bucket="pow2",
    interrogator: str = "optasense",
    prefetch: int = 2,
    engine: str = "h5py",
    wire: str = "conditioned",
    device=None,
    sharding=None,
    as_numpy: bool = False,
    in_flight: int = 2,
    read_deadline_s: float | None = None,
    fault_plan=None,
) -> Iterator[BatchSlab]:
    """Coalesce the ordered read pipeline into ``[batch, channel, time]``
    slabs for the batched detector (``parallel.batch``).

    Consecutive files sharing a shape bucket (``bucket``:
    ``config.BatchBucketConfig`` / mode string / fixed-length sequence)
    are zero-padded to the bucket length and stacked; a bucket change or
    the end of the list flushes a PARTIAL slab (``n_valid < batch``,
    trailing file slots zero).

    On the card (``device=None`` or ``"cuda"``) a transfer thread builds
    each slab there, file by file through pinned memory on a side stream
    (module docstring), while the caller computes on the previous slab;
    at most ``in_flight + 1`` slabs are resident on the card at once,
    counting the one the caller holds (it is released when the caller
    asks for the next). ``device="cpu"`` yields the host stack as a
    tensor; ``as_numpy=True`` yields it as numpy.

    A file that fails to probe/read/bucket raises :class:`SlabReadError`
    carrying its index — after any partial slab of earlier healthy files
    has been yielded.
    """
    _check_not_in_slice(read_deadline_s, fault_plan, sharding)
    if batch < 1:
        raise ValueError("batch must be >= 1")
    if in_flight < 1:
        raise ValueError("in_flight must be >= 1")
    kw = dict(bucket_cfg=as_bucket_config(bucket), interrogator=interrogator,
              prefetch=prefetch, engine=engine, wire=wire)
    files = list(files)
    if as_numpy:
        if device is not None:
            raise ValueError("as_numpy=True returns host stacks; drop device")
        yield from _assemble_host_slabs(files, selected_channels, metadata, batch=batch, **kw)
        return
    dev = resolve_device(device)
    if dev.type == "cpu":
        for slab in _assemble_host_slabs(files, selected_channels, metadata, batch=batch, **kw):
            yield dataclasses.replace(slab, stack=torch.from_numpy(slab.stack))
        return
    yield from _device_slabs(files, selected_channels, metadata, batch=batch,
                             in_flight=in_flight, device=dev, **kw)


def _device_slabs(files, selected_channels, metadata, *, batch, in_flight, device, **kw):
    """The card's slab assembler (see :func:`stream_batched_slabs`)."""
    stager = PinnedStager(device, n_buffers=2, keep_copies=True)
    permits = threading.Semaphore(in_flight + 1)
    out: queue.Queue = queue.Queue()
    stop = threading.Event()

    def produce():
        cur = None

        def flush():
            nonlocal cur
            nv = len(cur["blocks"])
            if nv < batch:
                stager.zero(cur["stack"][nv:])
            slab = BatchSlab(
                stack=cur["stack"], blocks=tuple(cur["blocks"]),
                paths=tuple(files[cur["idx0"] : cur["idx0"] + nv]), index0=cur["idx0"],
                bucket_ns=cur["key"][1],
                n_real=tuple(int(np.shape(b.trace)[1]) for b in cur["blocks"]),
                copies=tuple(stager.copies),
            )
            stager.copies.clear()
            out.put(("slab", slab, stager.ready()))
            cur = None

        gen = _bucketed_blocks(files, selected_channels, metadata, **kw)
        try:
            for i, blk, key in gen:
                if cur is not None and key != cur["key"]:
                    flush()
                if cur is None:
                    while not permits.acquire(timeout=0.1):
                        if stop.is_set():
                            return
                    C, b_ns, dt = key
                    cur = dict(stack=stager.empty((batch, C, b_ns), torch_dtype(dt)),
                               blocks=[], idx0=i, key=key)
                j, host = len(cur["blocks"]), np.asarray(blk.trace)
                n = host.shape[1]
                stager.copy_into(cur["stack"][j, :, :n], host)
                if n < key[1]:
                    stager.zero(cur["stack"][j, :, n:])
                cur["blocks"].append(blk)
                if len(cur["blocks"]) == batch:
                    flush()
                if stop.is_set():
                    return
            if cur is not None:
                flush()
            out.put(("end", None, None))
        except SlabReadError as exc:
            if cur is not None:
                flush()
            out.put(("error", exc, None))
        except BaseException as exc:  # noqa: BLE001 — re-raised on the consumer
            out.put(("error", exc, None))
        finally:
            gen.close()

    worker = threading.Thread(target=produce, name="das-h2d-slab", daemon=True)
    worker.start()
    held = False
    try:
        while True:
            if held:
                permits.release()      # the caller is done with the slab it held
                held = False
            kind, payload, ready = out.get()
            if kind == "end":
                return
            if kind == "error":
                raise payload
            PinnedStager.hand_over(payload.stack, ready)
            held = True
            yield payload
    finally:
        stop.set()
        for _ in range(in_flight + 2):
            permits.release()
        worker.join()
