"""Pick exchange with Raven selection tables (the port of
``das4whales_tpu.io.annotations``; host csv, no torch).

Raven's tab-separated selection table is the field's exchange format for
reviewed detections. A row spans a time/frequency box; a pick is a point,
so each pick becomes a box centred on its time with its template's
duration and band. The ``DAS Channel`` column keeps the array position
through the round trip. For the same picks this module writes the same
bytes as the JAX package's.
"""

from __future__ import annotations

import csv
from typing import Dict

import numpy as np

_COLUMNS = [
    "Selection", "View", "Channel", "Begin Time (s)", "End Time (s)",
    "Low Freq (Hz)", "High Freq (Hz)", "Template", "DAS Channel",
]


def to_raven_selection_table(
    path: str,
    picks: Dict[str, np.ndarray],
    fs: float,
    template_configs: dict | None = None,
    t_offset_s: float = 0.0,
) -> str:
    """Write ``{template: (2, n) [channel_idx, time_idx]}`` picks as ONE
    Raven selection table (rows sorted by begin time; selection numbers
    are 1-based as Raven expects). ``template_configs`` supplies each
    template's ``(fmin, fmax, duration)`` box geometry — e.g.
    ``MatchedFilterDetector.template_configs``; templates without a
    config get a zero-height box at the pick instant. ``t_offset_s``
    shifts times to absolute (e.g. a file's UTC offset in seconds).
    """
    rows = []
    cfgs = template_configs or {}
    for name, pk in picks.items():
        pk = np.asarray(pk)
        cfg = cfgs.get(name)
        fmin = getattr(cfg, "fmin", 0.0) if cfg is not None else 0.0
        fmax = getattr(cfg, "fmax", 0.0) if cfg is not None else 0.0
        dur = getattr(cfg, "duration", 0.0) if cfg is not None else 0.0
        for ch, t_idx in pk.T:
            t0 = t_offset_s + float(t_idx) / fs - dur / 2.0
            rows.append((t0, t0 + dur, float(fmin), float(fmax),
                         name, int(ch)))
    rows.sort()
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh, delimiter="\t")
        w.writerow(_COLUMNS)
        for i, (b, e, lo, hi, name, ch) in enumerate(rows, start=1):
            w.writerow([i, "Spectrogram 1", 1, f"{b:.6f}", f"{e:.6f}",
                        f"{lo:.3f}", f"{hi:.3f}", name, ch])
    return path


def from_raven_selection_table(
    path: str, fs: float, skipped: list | None = None
) -> Dict[str, np.ndarray]:
    """Inverse of :func:`to_raven_selection_table`: selection table ->
    ``{template: (2, n)}`` picks (box centers back to sample indices).
    Tables from Raven itself work too — rows missing the ``Template`` /
    ``DAS Channel`` extension columns land under template ``"SELECTION"``
    with channel 0. Header matching tolerates Raven's capitalization and
    spacing variants (lookup is case/whitespace-insensitive); a table
    without any recognizable ``Begin Time (s)`` column raises a
    descriptive ``ValueError`` up front, and rows whose time cells are
    empty/unparseable are skipped (reported via ``skipped``, a list that
    receives ``(line_number, reason)`` tuples) instead of crashing
    mid-iteration. When rows are dropped and no ``skipped`` list was
    passed, ONE summary ``warnings.warn`` fires: silent row loss must
    never pass unnoticed."""
    def norm(s: str) -> str:
        return " ".join(str(s).split()).lower()

    groups: Dict[str, list] = {}
    n_dropped = 0
    with open(path, newline="") as fh:
        reader = csv.DictReader(fh, delimiter="\t")
        headers = {norm(h): h for h in (reader.fieldnames or [])}

        def col(name: str) -> str | None:
            return headers.get(norm(name))

        begin_col = col("Begin Time (s)")
        if begin_col is None:
            raise ValueError(
                f"{path}: not a Raven selection table — no 'Begin Time (s)' "
                f"column (found: {reader.fieldnames})"
            )
        end_col = col("End Time (s)")
        tmpl_col = col("Template")
        ch_col = col("DAS Channel")
        for lineno, row in enumerate(reader, start=2):
            name = (row.get(tmpl_col) if tmpl_col else None) or "SELECTION"
            try:
                begin = float(row[begin_col])
                end = float((row.get(end_col) if end_col else None) or begin)
                ch = int(float((row.get(ch_col) if ch_col else None) or 0))
            except (TypeError, ValueError) as e:
                n_dropped += 1
                if skipped is not None:
                    skipped.append((lineno, repr(e)))
                continue
            center = (begin + end) / 2.0
            groups.setdefault(name, []).append((ch, int(round(center * fs))))
    if n_dropped and skipped is None:
        import warnings

        warnings.warn(
            f"{path}: {n_dropped} selection-table row(s) skipped "
            "(empty/unparseable time or channel cells); pass skipped=[] "
            "to collect per-row (line_number, reason) details"
        )
    return {
        name: np.asarray(sorted(v), dtype=np.int64).T.reshape(2, -1)
        for name, v in groups.items()
    }
