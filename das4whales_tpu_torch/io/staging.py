"""Host-to-card placement through pinned memory on a side stream.

Every host block the ingest path puts on the card goes through a
:class:`PinnedStager`: it is copied into a page-locked staging buffer
from a small pool that is reused from file to file, and from there to
the card by an asynchronous copy on the stager's own CUDA stream, so the
copy runs beside the consumer's compute. A buffer is refilled only after
its previous copy has finished (an event recorded after each copy). The
consumer's stream waits on a ready event before it touches the tensor
(:meth:`PinnedStager.hand_over`), and the tensor is ``record_stream``-ed
on that stream, so the caching allocator does not hand its memory to the
side stream while the consumer still reads it.

Nothing here falls back: when a buffer cannot be pinned or the side
stream cannot be made, the call raises; a pageable host array never
reaches the card by this path. On the CPU (``device="cpu"``) placement
is ``torch.from_numpy``, without a copy.
"""

from __future__ import annotations

import threading

import numpy as np
import torch


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (via an empty array)."""
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


class PinnedStager:
    """A pool of ``n_buffers`` pinned staging buffers and one side stream
    on ``device`` (a CUDA device). With ``keep_copies``, ``copies`` lists,
    per :meth:`copy_into`, the ``(start, end)`` CUDA events around the
    copy on the side stream and the bytes it moved, for the caller's
    timing (read them after the events have completed; the caller clears
    the list)."""

    def __init__(self, device: torch.device, n_buffers: int = 2, keep_copies: bool = False):
        if device.type != "cuda":
            raise ValueError(f"pinned staging is for a CUDA device, got {device}")
        self.device = device
        self.stream = torch.cuda.Stream(device=device)   # raises when it cannot
        self._bufs = [None] * n_buffers       # (uint8 pinned tensor, last copy's event)
        self._held = [threading.Lock() for _ in range(n_buffers)]
        self._next = 0
        self._lock = threading.Lock()
        self.keep_copies = keep_copies
        self.copies: list = []

    def _buffer(self, nbytes: int) -> tuple:
        """``(index, buffer)``: the next pool buffer, at least ``nbytes``
        long, held by the caller (until :meth:`_release`) and free of its
        last copy."""
        with self._lock:
            i = self._next
            self._next = (i + 1) % len(self._bufs)
        self._held[i].acquire()
        buf, ev = self._bufs[i] or (None, None)
        if ev is not None:
            ev.synchronize()
        if buf is None or buf.numel() < nbytes:
            self._bufs[i] = buf = None   # drop the old buffer before pinning a larger one
            buf = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
            if not buf.is_pinned():
                self._held[i].release()
                raise RuntimeError(f"could not pin a {nbytes}-byte staging buffer")
        return i, buf

    def _release(self, i: int, buf: torch.Tensor, ev) -> None:
        self._bufs[i] = (buf, ev)
        self._held[i].release()

    def empty(self, shape, dtype) -> torch.Tensor:
        """A device tensor allocated on the side stream."""
        with torch.cuda.stream(self.stream):
            return torch.empty(shape, dtype=dtype, device=self.device)

    def copy_into(self, dst: torch.Tensor, host: np.ndarray) -> None:
        """Copy ``host`` into the device view ``dst`` (same shape) through a
        pinned buffer, asynchronously on the side stream."""
        host = np.ascontiguousarray(host)
        if tuple(dst.shape) != host.shape:
            raise ValueError(f"host block {host.shape} into a device view {tuple(dst.shape)}")
        if torch_dtype(host.dtype) != dst.dtype:
            raise ValueError(f"host dtype {host.dtype} into a {dst.dtype} device view")
        i, buf = self._buffer(host.nbytes)
        end = None
        try:
            src = buf[: host.nbytes].view(dst.dtype).view(host.shape)
            np.copyto(src.numpy(), host)     # host may be a read-only memmap view
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            with torch.cuda.stream(self.stream):
                start.record()
                dst.copy_(src, non_blocking=True)
                end.record()
        finally:
            self._release(i, buf, end)
        if self.keep_copies:
            self.copies.append((start, end, host.nbytes))

    def zero(self, dst: torch.Tensor) -> None:
        """Zero a device view on the side stream."""
        with torch.cuda.stream(self.stream):
            dst.zero_()

    def ready(self) -> torch.cuda.Event:
        """An event after everything queued on the side stream so far."""
        ev = torch.cuda.Event()
        ev.record(self.stream)
        return ev

    @staticmethod
    def hand_over(tensor: torch.Tensor, ready: torch.cuda.Event) -> torch.Tensor:
        """Make the calling thread's current stream wait for ``ready`` and
        keep ``tensor``'s memory from reuse until that stream's work on it
        is done. Call on the consumer's thread."""
        consumer = torch.cuda.current_stream(tensor.device)
        consumer.wait_event(ready)
        tensor.record_stream(consumer)
        return tensor

    def place(self, host: np.ndarray) -> tuple:
        """A new device tensor holding ``host``: ``(tensor, ready event)``."""
        dst = self.empty(host.shape, torch_dtype(host.dtype))
        self.copy_into(dst, host)
        return dst, self.ready()


def to_device(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host array on ``device``: through a pinned buffer and a side
    stream on a card (ready for the calling thread's stream), a tensor
    sharing its memory on the CPU."""
    if device.type == "cpu":
        return torch.from_numpy(np.ascontiguousarray(host))
    stager = PinnedStager(device, n_buffers=1)
    dst, ready = stager.place(host)
    return PinnedStager.hand_over(dst, ready)
