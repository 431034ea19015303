"""Hooks of the program recorder (``analysis.programs``).

A priced program's run can be recorded as its stream of aten operations
(``analysis.programs.record_ops``). Two kinds of code mark themselves
for it here, at no cost when nothing records:

* the hand-written kernels' wrappers (``ops.fused_picks``,
  ``ops.fused_stft``) wrap their routing in :func:`kernel`: the recorder
  notes one entry ``kernel:<name>`` and does not descend into the launch
  or, on the CPU, into the kernel's plain version, so one stream holds
  for the CPU and the card;
* the counted reads (``parallel.dispatch.fetch``/``sync``,
  ``models.matched_filter.PackedFetch``, a family facade's one read of
  its heavy output) wrap their copy in :func:`counted_read`: one entry
  ``fetch``, so a device-to-host copy or scalar read outside such a
  scope is a host read the audit flags (R13).

The recorder is per thread: a dispatch mode records only the thread that
entered it, and so do these scopes.
"""

from __future__ import annotations

import threading

_tls = threading.local()


def active():
    """The recorder recording on this thread, or None."""
    return getattr(_tls, "recorder", None)


def set_active(recorder) -> None:
    """Install (or clear, with None) this thread's recorder."""
    _tls.recorder = recorder


class _Scope:
    """One opaque entry in the recorded stream: noted on entry, nothing
    recorded inside."""

    __slots__ = ("entry", "rec")

    def __init__(self, entry: str):
        self.entry = entry
        self.rec = None

    def __enter__(self):
        rec = getattr(_tls, "recorder", None)
        if rec is not None:
            rec.enter_scope(self.entry)
            self.rec = rec
        return self

    def __exit__(self, *exc):
        if self.rec is not None:
            self.rec.exit_scope()
            self.rec = None


def kernel(name: str) -> _Scope:
    """Scope of one call of a hand-written kernel's wrapper (its launch on
    the card, its plain version on the CPU)."""
    return _Scope(f"kernel:{name}")


def counted_read() -> _Scope:
    """Scope of a program's counted device-to-host read."""
    return _Scope("fetch")
