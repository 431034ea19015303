"""Deterministic crash-point injection at durability boundaries (the
port's copy of ``das4whales_tpu.crashpoints``).

Every durable write in this package (``utils.artifacts``) announces the
boundary it is about to cross by calling :func:`hit` with one of the
:data:`POINTS` names. A disarmed hit is one tuple compare — the
telemetry on/off contract: picks, manifests and compile counts are
bitwise/count-identical with the subsystem dormant. An armed hit fires
ONCE (single-shot, then self-disarms) in one of four modes:

* ``kill``   — ``SIGKILL`` this process: the unclean-death drill. No
  ``atexit``, no flush, no ``finally`` — the honest model of OOM-killer
  / power loss at that exact instruction.
* ``enospc`` — raise :class:`InjectedDiskFull` (``errno.ENOSPC``).
* ``eio``    — raise :class:`InjectedWriteIOError` (``errno.EIO``).
* ``short``  — raise :class:`InjectedShortWrite`: a write(2) that
  persisted only part of its buffer.

Arming: programmatic (:func:`arm` / :func:`disarm`, in-process tests),
environment (subprocess drill — ``DAS_CRASHPOINT=<point>``,
``DAS_CRASHPOINT_MODE=kill|enospc|eio|short`` default ``kill``,
``DAS_CRASHPOINT_SKIP=N`` to fire on the N+1th crossing of the point),
or a campaign fault plan (``faults.FaultPlan`` accepts
``crash_point=``/``crash_mode=`` and arms on construction).

The points, in the order one atomic write crosses them
(``utils.artifacts.atomic_file``):

* ``pre-write``   — before the tmp sibling is even created.
* ``post-tmp``    — tmp written + fsynced, not yet renamed.
* ``pre-rename``  — immediately before ``os.replace`` (same window as
  post-tmp from the filesystem's view; distinct so the matrix proves
  both call sites recover).
* ``post-rename`` — artifact durable under its final name, directory
  entry not yet fsynced.
* ``pre-dirsync`` — before the containing-directory fsync.
* ``append-mid-line`` — inside ``utils.artifacts.append_record`` after
  HALF the record's bytes reached the OS: the torn-manifest-tail
  generator.

This module is stdlib-only and import-cycle-free: ``faults`` re-exports
it (``faults.crashpoints``) and ``utils.artifacts`` imports it
directly.
"""
from __future__ import annotations

import errno
import os
import signal
from typing import Optional, Tuple

#: Canonical crash-point names, in write order (see module docstring).
POINTS = ("pre-write", "post-tmp", "pre-rename", "post-rename",
          "pre-dirsync", "append-mid-line")

#: Supported failure modes for an armed point.
MODES = ("kill", "enospc", "eio", "short")


class InjectedWriteFault(OSError):
    """Marker base for write faults injected at a crash point. Carries
    ``injected = True`` so logs/tests can tell drill faults from real
    ones; classification is left to ``faults.classify_failure``'s
    ordinary errno taxonomy (the injected error must walk the same
    recovery path a real one would)."""

    injected = True


class InjectedDiskFull(InjectedWriteFault):
    """``ENOSPC`` at a durability boundary (classifies ``corrupt`` —
    not transient — so the file disposes immediately and a resume run
    rehabilitates it, exactly like a real full disk that was freed)."""


class InjectedWriteIOError(InjectedWriteFault):
    """``EIO`` at a durability boundary (classifies ``transient``)."""


class InjectedShortWrite(InjectedWriteFault):
    """A write that persisted only part of its buffer before failing
    (``EIO``; raised after the partial bytes really reached the OS, so
    the torn state is genuine, not simulated)."""


# ---------------------------------------------------------------- state
_armed: Optional[Tuple[str, str]] = None   # (point, mode)
_skip_remaining: int = 0


def arm(point: str, mode: str = "kill", skip: int = 0) -> None:
    """Arm ``point`` to fire once in ``mode`` after ``skip`` benign
    crossings. Re-arming replaces any previous arming."""
    global _armed, _skip_remaining
    if point not in POINTS:
        raise ValueError(f"unknown crash point {point!r}; one of {POINTS}")
    if mode not in MODES:
        raise ValueError(f"unknown crash mode {mode!r}; one of {MODES}")
    _armed = (point, mode)
    _skip_remaining = int(skip)


def disarm() -> None:
    """Disarm whatever is armed (idempotent)."""
    global _armed, _skip_remaining
    _armed = None
    _skip_remaining = 0


def armed() -> Optional[Tuple[str, str]]:
    """The ``(point, mode)`` currently armed, or None."""
    return _armed


def pending(point: str) -> bool:
    """True when ``point`` is armed and due to fire on its next hit
    (skip budget exhausted). ``append_record`` uses this to decide
    whether to take the split-write path that makes ``append-mid-line``
    a genuine torn line."""
    return _armed is not None and _armed[0] == point and _skip_remaining <= 0


def hit(point: str) -> None:
    """Cross a durability boundary. Disarmed (the production state):
    one tuple compare, no allocation, no syscall."""
    global _armed, _skip_remaining
    if _armed is None or _armed[0] != point:
        return
    if _skip_remaining > 0:
        _skip_remaining -= 1
        return
    mode = _armed[1]
    _armed = None                          # single-shot
    if mode == "kill":
        os.kill(os.getpid(), signal.SIGKILL)
    if mode == "enospc":
        raise InjectedDiskFull(
            errno.ENOSPC, f"injected ENOSPC at crash point {point!r}")
    if mode == "eio":
        raise InjectedWriteIOError(
            errno.EIO, f"injected EIO at crash point {point!r}")
    raise InjectedShortWrite(
        errno.EIO, f"injected short write at crash point {point!r}")


def _arm_from_env() -> None:
    spec = os.environ.get("DAS_CRASHPOINT", "").strip()
    if not spec:
        return
    arm(spec,
        os.environ.get("DAS_CRASHPOINT_MODE", "kill").strip() or "kill",
        int(os.environ.get("DAS_CRASHPOINT_SKIP", "0") or "0"))


_arm_from_env()
