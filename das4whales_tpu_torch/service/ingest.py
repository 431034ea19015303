"""Continuous ingest: bounded ring buffers, file replay, slab slicing
(the port's copy of ``das4whales_tpu.service.ingest``).

The service's input side, per tenant:

* :class:`RingBuffer` — a BOUNDED per-stream queue of ingest items with
  an explicit backpressure contract: a full ring either REJECTS the push
  (the HTTP surface answers 429 and the interrogator retries) or DROPS
  THE OLDEST item to admit the newest (live monitoring prefers fresh
  data over complete data) — per tenant config, with every drop counted
  as ``das_ingest_dropped_total{tenant}``.
* :class:`FileReplaySource` — replays existing HDF5/TDMS files through
  ``io.stream.stream_strain_blocks`` (host numpy) at a configurable
  real-time factor: 60 s files at factor 1.0 arrive once a minute,
  factor 0/None replays as fast as the reader runs (tests, backfill).
  Read failures become items carrying the error, so the scheduler
  dispositions them with the campaign's classified-failure contract
  instead of killing the source thread.
* :class:`SlabSlicer` — the continuous analog of the batch campaign's
  slab assembler: consecutive same-bucket blocks coalesce into
  ``[B, channel, time]`` host slabs through the SAME
  ``io.stream.assemble_slab`` bucket/padding rule, so a slab formed from
  a ring buffer is bit-identical to one the batch campaign would have
  formed from the same files in the same order — the foundation of the
  service's picks-parity guarantee.

Everything here is host-side numpy: the scheduler puts a slab on the
card (through pinned staging) when it dispatches it.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..config import as_bucket_config
from ..telemetry import metrics
from ..utils import locks
from ..utils.log import get_logger

log = get_logger("das4whales_tpu_torch.service.ingest")

_c_dropped = metrics.counter(
    "das_ingest_dropped_total",
    "ingest items dropped by a full ring buffer (drop-oldest policy)",
    ("tenant",),
)
_c_rejected = metrics.counter(
    "das_ingest_rejected_total",
    "ingest pushes rejected by a full ring buffer (reject policy -> 429)",
    ("tenant",),
)
_c_accepted = metrics.counter(
    "das_ingest_accepted_total",
    "ingest items accepted into a tenant's ring buffer",
    ("tenant",),
)
_g_depth = metrics.gauge(
    "das_ingest_ring_depth",
    "items currently buffered in a tenant's ring",
    ("tenant",),
)

#: ring overflow policies (TenantSpec.overflow)
OVERFLOW_POLICIES = ("reject", "drop_oldest")


@dataclass
class IngestItem:
    """One unit of ingest: a named block, or a read failure.

    ``block`` is anything with ``.trace`` (host ``[channel, time]``
    array) and ``.metadata`` (``config.AcquisitionMetadata``) — the
    stream's ``StrainBlock`` for replay, a live push's assembled block
    for the HTTP feed. ``error`` carries a source-side failure for the
    scheduler to disposition at this item's position (the campaign's
    per-file attribution contract, kept at ring granularity).
    ``t_ingest`` is the ``time.monotonic()`` CAPTURE STAMP the ring
    writes at admission (``RingBuffer.push``/``push_wait``) — the zero
    point of the ingest→pick-settled freshness SLO (``telemetry.slo``);
    a caller-provided stamp is kept (a source that knows the true
    capture time may pre-stamp)."""

    path: str
    block: object | None = None
    error: Exception | None = None
    t_ingest: float | None = None


class RingBuffer:
    """Bounded FIFO of :class:`IngestItem`\\ s with counted backpressure.

    ``policy="reject"``: a full ring refuses the push (returns False —
    the HTTP ingest surface maps that to 429 + Retry-After).
    ``policy="drop_oldest"``: the oldest buffered item is evicted to
    admit the newest, counted as ``das_ingest_dropped_total{tenant}``
    (a dropped item gets no manifest record: it was never admitted to
    detection — the counter is its only trace, by design).

    ``close()`` marks the stream ended (replay finished / drain):
    pushes are refused and consumers can distinguish "empty for now"
    from "no more data ever" (:meth:`exhausted`).
    """

    def __init__(self, tenant: str, capacity: int = 8,
                 policy: str = "reject"):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if policy not in OVERFLOW_POLICIES:
            raise ValueError(
                f"unknown overflow policy {policy!r}; expected one of "
                f"{OVERFLOW_POLICIES}"
            )
        self.tenant = tenant
        self.capacity = int(capacity)
        self.policy = policy
        self._q: deque = deque()
        # a TracedLock (utils.locks): ring contention lands in the
        # das_lock_wait/held_seconds{name="ring"} histograms and the
        # lock-order graph
        self._lock = locks.new_lock("ring")
        self._not_empty = threading.Condition(self._lock)
        # notified by pop(): push_wait blocks HERE instead of
        # sleep-polling
        self._space = threading.Condition(self._lock)
        self._closed = False

    def __len__(self) -> int:
        with self._lock:
            return len(self._q)

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def exhausted(self) -> bool:
        """No more data ever: closed AND drained."""
        with self._lock:
            return self._closed and not self._q

    def close(self) -> None:
        with self._not_empty:
            self._closed = True
            self._not_empty.notify_all()
            self._space.notify_all()   # blocked push_wait callers: drain

    def push(self, item: IngestItem) -> bool:
        """Admit ``item`` under the ring's overflow policy. Returns True
        when the item is buffered, False when it was refused (full ring
        under ``reject``, or a closed ring)."""
        with self._not_empty:
            if self._closed:
                return False
            if len(self._q) >= self.capacity:
                if self.policy == "reject":
                    _c_rejected.inc(tenant=self.tenant)
                    return False
                self._q.popleft()   # drop-oldest: newest data wins
                _c_dropped.inc(tenant=self.tenant)
            if item.t_ingest is None:
                item.t_ingest = time.monotonic()   # the SLO's zero point
            self._q.append(item)
            _c_accepted.inc(tenant=self.tenant)
            _g_depth.set(len(self._q), tenant=self.tenant)
            self._not_empty.notify()
            return True

    def push_wait(self, item: IngestItem, poll_s: float | None = None,
                  timeout_s: float | None = None) -> bool:
        """Blocking push for sources that must never lose items (the
        file-replay source): wait for space instead of dropping. Blocks
        on the ``_space`` condition ``pop()`` notifies (no sleep-poll —
        the waiter wakes the moment a slot frees). Returns False only
        when the ring closes (drain) or ``timeout_s`` expires.
        ``poll_s`` is accepted for back-compat and ignored."""
        deadline = None if timeout_s is None else time.monotonic() + timeout_s
        with self._space:
            while True:
                if self._closed:
                    return False
                if len(self._q) < self.capacity:
                    if item.t_ingest is None:
                        item.t_ingest = time.monotonic()
                    self._q.append(item)
                    _c_accepted.inc(tenant=self.tenant)
                    _g_depth.set(len(self._q), tenant=self.tenant)
                    self._not_empty.notify()
                    return True
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return False
                # bounded wait even without a caller timeout: a missed
                # notify (or a consumer that died) must not hang the
                # replay thread forever
                self._space.wait(min(remaining or 1.0, 1.0))

    def pop(self) -> Optional[IngestItem]:
        """The oldest buffered item, or None when the ring is empty
        (non-blocking: the scheduler decides how to idle)."""
        with self._space:
            if not self._q:
                return None
            item = self._q.popleft()
            _g_depth.set(len(self._q), tenant=self.tenant)
            self._space.notify()   # a blocked push_wait can land now
            return item


class FileReplaySource:
    """Replay ``files`` into a ring buffer at a real-time factor.

    The test stand-in for a live interrogator feed — and the
    backfill path for recorded archives. Blocks are read in order via
    ``io.stream.stream_strain_blocks`` (host numpy; the slicer owns the
    eventual H2D) and pushed with :meth:`RingBuffer.push_wait`, so a
    slow consumer backpressures the reader instead of losing files.

    ``realtime_factor``: 1.0 paces the replay at the recording's own
    rate (each block sleeps ``record_seconds / factor`` before the
    next); 2.0 replays twice as fast; 0/None replays as fast as the
    reader runs. A read failure is pushed as an error item at the
    failing file's own position and the replay CONTINUES past it — the
    campaign's per-file isolation, source-side.
    """

    def __init__(self, ring: RingBuffer, files, selected_channels,
                 metadata=None, *, interrogator: str = "optasense",
                 engine: str = "h5py", wire: str = "conditioned",
                 prefetch: int = 2, realtime_factor: float | None = None,
                 read_deadline_s: float | None = None, fault_plan=None,
                 close_when_done: bool = True):
        self.ring = ring
        self.files = list(files)
        self.sel = selected_channels
        self.metadata = metadata
        self.interrogator = interrogator
        self.engine = engine
        self.wire = wire
        self.prefetch = prefetch
        self.factor = float(realtime_factor or 0.0)
        self.read_deadline_s = read_deadline_s
        self.fault_plan = fault_plan
        self.close_when_done = close_when_done
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> "FileReplaySource":
        self._thread = threading.Thread(
            target=self._run, name=f"replay-{self.ring.tenant}", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()

    def join(self, timeout: float | None = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    def _run(self) -> None:
        from ..io.stream import stream_strain_blocks

        i = 0
        try:
            while i < len(self.files) and not self._stop.is_set():
                stream = stream_strain_blocks(
                    self.files[i:], self.sel, self._metas(i),
                    interrogator=self.interrogator, engine=self.engine,
                    prefetch=self.prefetch, as_numpy=True, wire=self.wire,
                    read_deadline_s=self.read_deadline_s,
                    fault_plan=self.fault_plan,
                )
                while not self._stop.is_set():
                    path = self.files[i] if i < len(self.files) else None
                    try:
                        block = next(stream)
                    except StopIteration:
                        i = len(self.files)
                        break
                    except Exception as exc:  # noqa: BLE001 — per-file isolation
                        # the failure surfaces at ITS file's ring slot;
                        # the stream restarts past the culprit (exactly
                        # the campaign runner's restart discipline)
                        self.ring.push_wait(IngestItem(path=path, error=exc))
                        i += 1
                        break
                    if not self.ring.push_wait(
                            IngestItem(path=path, block=block)):
                        return   # ring closed: drain in progress
                    i += 1
                    if self.factor > 0 and block is not None:
                        dur = block_duration_s(block)
                        if dur > 0:
                            # pace on the stop Event, not time.sleep: a
                            # drain request wakes the replay immediately
                            # instead of after the block's remaining
                            # real-time budget
                            self._stop.wait(dur / self.factor)
                del stream
        finally:
            if self.close_when_done:
                self.ring.close()

    def _metas(self, i: int):
        if self.metadata is None or not isinstance(self.metadata,
                                                   (list, tuple)):
            return self.metadata
        return list(self.metadata[i:])


class SlabSlicer:
    """Coalesce a tenant's ordered ingest items into batch slabs.

    The continuous analog of ``io.stream.stream_batched_slabs``'s host
    assembler: consecutive blocks sharing a bucket key ``(channels,
    bucket_ns, dtype)`` group into ``[batch, C, T]`` host stacks via
    ``io.stream.assemble_slab`` — THE shared bucket/padding rule — so
    service slabs are bit-identical to batch-campaign slabs over the
    same blocks in the same order. A bucket change flushes the partial
    group first (stream order is slab order, like the assembler).

    Because the stream is unbounded there is no end-of-list flush;
    instead ``linger_s`` bounds how long a partial group may wait for
    batch-mates: :meth:`take_ready` flushes it once the linger expires
    (or immediately when ``force``/the ring is exhausted). Error items
    surface in order as ``(None, [error items...])`` markers so the
    scheduler dispositions them exactly where the campaign would have.
    """

    def __init__(self, batch: int, bucket="pow2", linger_s: float = 0.25):
        if batch < 1:
            raise ValueError("batch must be >= 1")
        self.batch = int(batch)
        self.bucket_cfg = as_bucket_config(bucket)
        self.linger_s = float(linger_s)
        self._pending: List[IngestItem] = []
        self._cur_key: Tuple | None = None
        self._first_at: float = 0.0
        self._index = 0   # running per-tenant file index (slab.index0)

    def _flush(self):
        from ..io.stream import assemble_slab

        group = self._pending
        self._pending = []
        _C, b_ns, _dt = self._cur_key
        slab = assemble_slab(
            [it.block for it in group], [it.path for it in group],
            self._index, self.batch, b_ns,
        )
        self._index += len(group)
        return slab

    def offer(self, item: IngestItem):
        """Feed one ingest item; returns a list of outputs ready NOW —
        each either a flushed ``BatchSlab`` or the error item itself
        (surfaced after any earlier healthy partial slab, preserving
        stream-order attribution)."""
        out: list = []
        if item.error is not None:
            if self._pending:
                out.append(self._flush())
            self._index += 1   # the failed slot consumes its position
            out.append(item)
            return out
        tr = np.asarray(item.block.trace)
        b_ns = self.bucket_cfg.bucket_ns(tr.shape[1])
        key = (tr.shape[0], b_ns, tr.dtype)
        if self._pending and key != self._cur_key:
            out.append(self._flush())
        if not self._pending:
            self._first_at = time.monotonic()
        self._cur_key = key
        self._pending.append(item)
        if len(self._pending) == self.batch:
            out.append(self._flush())
        return out

    def pending(self) -> int:
        return len(self._pending)

    def linger_expired(self) -> bool:
        return bool(self._pending) and (
            time.monotonic() - self._first_at >= self.linger_s
        )

    def flush_partial(self):
        """Force the partial group out (linger expiry, ring exhausted,
        drain). None when nothing is pending."""
        return self._flush() if self._pending else None


def block_duration_s(block) -> float:
    """A block's recorded duration (for replay pacing)."""
    meta = getattr(block, "metadata", None)
    fs = float(getattr(meta, "fs", 0.0) or 0.0)
    ns = int(np.asarray(block.trace).shape[-1])
    return ns / fs if fs > 0 else 0.0


@dataclass
class LiveBlock:
    """A minimal block for the HTTP live-ingest path: the service's
    slicer and executor only need ``.trace`` + ``.metadata`` (the
    replay path's ``StrainBlock`` carries more axes the service never
    reads)."""

    trace: np.ndarray
    metadata: object = None
    wire: str = "conditioned"
    t0_utc: object = field(default=None)
