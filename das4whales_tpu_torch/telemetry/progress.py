"""Span-aware progress: tqdm when present, a FAITHFUL fallback otherwise
(the port's copy of ``das4whales_tpu.telemetry.progress``).

Without tqdm the fallback is a thin wrapper that preserves
``__len__`` (from ``total`` or the iterable's own length), keeps
``desc``/``total`` readable, and supports the tqdm surface the repo
actually uses (iteration, ``set_description``, ``update``, ``close``).
Either way the whole iteration is wrapped in a ``progress`` span when
tracing is on, so a campaign trace shows host loops by name.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Optional

from . import trace

__all__ = ["progress"]


class _PlainProgress:
    """The no-tqdm fallback: iteration order untouched, sizing and
    description semantics preserved."""

    def __init__(self, iterable: Iterable, desc: Optional[str],
                 total: Optional[int]):
        self.iterable = iterable
        self.desc = desc
        if total is None:
            try:
                total = len(iterable)  # type: ignore[arg-type]
            except TypeError:
                total = None
        self.total = total
        self.n = 0

    def __iter__(self) -> Iterator:
        for item in self.iterable:
            yield item
            self.n += 1

    def __len__(self) -> int:
        if self.total is None:
            raise TypeError(
                f"progress over an unsized iterable has no len() "
                f"(desc={self.desc!r}); pass total="
            )
        return self.total

    def set_description(self, desc: str) -> None:
        self.desc = desc

    def update(self, n: int = 1) -> None:
        self.n += n

    def close(self) -> None:
        pass


def _wrap_span(it: Iterable, desc: Optional[str], total: Optional[int]):
    with trace.span("progress", desc=desc or "", total=total):
        yield from it


def progress(iterable: Iterable, desc: str | None = None,
             total: int | None = None) -> Iterator:
    """tqdm when available (the reference's surface), the faithful
    :class:`_PlainProgress` wrapper otherwise — host loops only; device
    work never needs this. With tracing enabled the iteration records a
    ``progress`` span named by ``desc``."""
    try:
        from tqdm import tqdm

        bar = tqdm(iterable, desc=desc, total=total)
    except ImportError:
        bar = _PlainProgress(iterable, desc, total)
    if not trace.enabled():
        return bar
    return _SpanWrapped(_wrap_span(bar, desc, total), bar)


class _SpanWrapped:
    """Span-wrapped bar that PRESERVES the underlying bar's surface —
    ``len()``, ``set_description``/``update``/``close``/``n``/… all
    reach the real bar, so a caller's behavior never diverges on
    whether tracing happens to be enabled."""

    def __init__(self, gen, bar):
        self._gen = gen
        self.bar = bar

    def __iter__(self):
        return iter(self._gen)

    def __len__(self):
        return len(self.bar)

    def __getattr__(self, name):
        return getattr(self.bar, name)
