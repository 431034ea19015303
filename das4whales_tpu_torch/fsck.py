"""``fsck`` for campaign artifact state: verify and repair (the port's
copy of ``das4whales_tpu.fsck``; either package's ``fsck_outdir`` reads
the other's output directories).

The offline half of the crash-only durability contract
(``utils.artifacts`` is the write half). Walks an output tree — a campaign outdir or a service root
with per-tenant subdirectories, uniformly: anything holding a
``manifest.jsonl`` — and detects every way an unclean death (or bit
rot) can leave it:

* ``orphan-tmp``             — ``*.tmp-<pid>`` residue of a kill
  between tmp write and rename (repair: unlink).
* ``torn-tail``              — newline-less, unparseable final manifest
  segment from SIGKILL mid-append (repair: truncate to the last valid
  record).
* ``corrupt-record``         — a complete interior line that fails its
  CRC32 or does not parse (repair: quarantine the raw line into
  ``manifest.corrupt.jsonl``, atomically rewrite the manifest from the
  surviving lines byte-for-byte).
* ``truncated-export``       — ``cost_cards.json`` / ``quality.json``
  / ``trace.json`` / ``summary.json`` that is not valid JSON (repair:
  set aside as ``<name>.corrupt`` — exports are derived state, the
  next campaign/drain rewrites them).
* ``missing-artifact``       — a settled ``done`` record whose
  ``picks_file`` is absent or unreadable (repair: quarantine that
  path's ``done`` records so resume re-runs the file).
* ``unreferenced-artifact``  — a ``picks/*.npz`` no manifest record
  references (repair: unlink).

Every finding increments ``das_fsck_findings_total{kind}``.
:func:`fsck_outdir` (with ``repair=True`` to fix) and
:func:`render_findings` are the entry points; the same machinery backs :func:`startup_check`, the cheap verify pass
campaign runners execute before trusting
a resume manifest — a torn tail (the EXPECTED unclean-death residue)
is healed automatically; deeper corruption refuses startup unless
auto-repair is on (``DAS_FSCK_AUTOREPAIR=1`` or the explicit flag).
"""
from __future__ import annotations

import contextlib
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from .telemetry import metrics
from .utils import artifacts
from .utils.log import get_logger

log = get_logger("das4whales_tpu_torch.fsck")

MANIFEST = "manifest.jsonl"
CORRUPT_SIDECAR = "manifest.corrupt.jsonl"

#: Derived-state JSON exports fsck validates next to each manifest.
EXPORT_NAMES = ("cost_cards.json", "quality.json", "trace.json",
                "summary.json")

#: Every corruption class fsck can report (the ``kind`` label set).
FINDING_KINDS = ("orphan-tmp", "torn-tail", "corrupt-record",
                 "truncated-export", "missing-artifact",
                 "unreferenced-artifact")

_findings_total = metrics.counter(
    "das_fsck_findings_total",
    "Artifact corruption findings by kind (fsck + startup verify)",
    ("kind",))
_orphans_swept = metrics.counter(
    "das_orphan_tmps_swept_total",
    "Orphan *.tmp-<pid> files removed by the startup sweep / fsck")


@dataclass
class Finding:
    """One detected (and possibly repaired) corruption."""

    kind: str
    path: str
    detail: str = ""
    repaired: bool = False

    def as_dict(self) -> Dict:
        return {"kind": self.kind, "path": self.path,
                "detail": self.detail, "repaired": self.repaired}


def _record_finding(findings: List[Finding], kind: str, path: str,
                    detail: str = "", repaired: bool = False) -> Finding:
    f = Finding(kind, path, detail, repaired)
    findings.append(f)
    _findings_total.inc(kind=kind)
    return f


def _quarantine(manifest: str, scan: artifacts.LedgerScan,
                bad_raw: Sequence[bytes],
                drop_offsets: Optional[set] = None) -> None:
    """Repair a manifest in place: append the raw ``bad_raw`` lines to
    the quarantine sidecar, then atomically rewrite the manifest from
    the surviving good lines BYTE-FOR-BYTE (CRC suffixes, key order and
    whitespace all preserved — repair must not launder history)."""
    sidecar = os.path.join(os.path.dirname(manifest) or ".",
                           CORRUPT_SIDECAR)
    if bad_raw:
        # raw quarantined bytes, not JSON records — the one append in
        # the repo that bypasses append_record on purpose
        with open(sidecar, "ab") as fh:
            for raw in bad_raw:
                fh.write(raw if raw.endswith(b"\n") else raw + b"\n")
            fh.flush()
            os.fsync(fh.fileno())
    drop = drop_offsets or set()
    keep = b"".join(raw for off, raw, _rec in scan.good if off not in drop)
    artifacts.atomic_bytes(manifest, keep)


def _truncate_tail(manifest: str, offset: int) -> None:
    with open(manifest, "rb+") as fh:
        fh.truncate(offset)
        fh.flush()
        os.fsync(fh.fileno())


def _settled_view(records: Sequence[Dict]) -> Dict[str, Dict]:
    """Last file-record per path (mirrors ``campaign._load_settled``:
    ledger events — lines without both ``path`` and ``status`` — are
    ignored; last record wins)."""
    last: Dict[str, Dict] = {}
    for rec in records:
        if "path" in rec and "status" in rec:
            last[rec["path"]] = rec
    return last


def _npz_readable(path: str) -> bool:
    import numpy as np
    import zipfile

    try:
        with np.load(path, allow_pickle=False) as z:
            _ = z.files
        return True
    except (OSError, ValueError, zipfile.BadZipFile):
        return False


def _check_manifest(manifest: str, findings: List[Finding],
                    repair: bool, deep: bool) -> None:
    scan = artifacts.scan_ledger(manifest)
    bad_raw: List[bytes] = []
    drop_offsets: set = set()

    if scan.torn_tail is not None:
        torn = scan.size - scan.torn_tail
        f = _record_finding(
            findings, "torn-tail", manifest,
            f"{torn} unterminated bytes at offset {scan.torn_tail}")
        if repair:
            _truncate_tail(manifest, scan.torn_tail)
            f.repaired = True

    for offset, raw, verdict in scan.bad:
        f = _record_finding(findings, "corrupt-record", manifest,
                            f"{verdict} line at offset {offset}")
        if repair:
            bad_raw.append(raw)
            f.repaired = True

    referenced = set()
    if deep:
        outdir = os.path.dirname(manifest) or "."
        settled = _settled_view(scan.records)
        for rec in scan.records:
            if rec.get("picks_file"):
                referenced.add(os.path.abspath(rec["picks_file"]))
        for path, rec in settled.items():
            if rec.get("status") != "done":
                continue
            picks = rec.get("picks_file")
            if picks and _npz_readable(picks):
                continue
            f = _record_finding(
                findings, "missing-artifact", manifest,
                f"done record for {path!r} but picks artifact "
                f"{picks!r} is missing/unreadable")
            if repair:
                # quarantine every done record for that path: the file
                # unsettles, resume re-runs it and rewrites the artifact
                for off, raw, r in scan.good:
                    if r.get("path") == path and r.get("status") == "done":
                        bad_raw.append(raw)
                        drop_offsets.add(off)
                f.repaired = True
        picks_dir = os.path.join(outdir, "picks")
        if os.path.isdir(picks_dir):
            for name in sorted(os.listdir(picks_dir)):
                p = os.path.join(picks_dir, name)
                if (name.endswith(".npz") and os.path.isfile(p)
                        and os.path.abspath(p) not in referenced):
                    f = _record_finding(
                        findings, "unreferenced-artifact", p,
                        "picks artifact no manifest record references")
                    if repair:
                        with contextlib.suppress(OSError):
                            os.unlink(p)
                        f.repaired = True

    if repair and (bad_raw or drop_offsets):
        _quarantine(manifest, scan, bad_raw, drop_offsets)


def _check_exports(dirpath: str, findings: List[Finding],
                   repair: bool) -> None:
    for name in EXPORT_NAMES:
        path = os.path.join(dirpath, name)
        if not os.path.isfile(path):
            continue
        try:
            with open(path, "r", encoding="utf-8") as fh:
                json.load(fh)
            continue
        except (OSError, json.JSONDecodeError, UnicodeDecodeError) as exc:
            f = _record_finding(findings, "truncated-export", path,
                                f"not valid JSON: {exc}")
            if repair:
                with contextlib.suppress(OSError):
                    os.replace(path, path + ".corrupt")
                f.repaired = True


def fsck_outdir(outdir: str, repair: bool = False,
                deep: bool = True) -> List[Finding]:
    """Verify (and with ``repair=True`` fix) every artifact under
    ``outdir``. ``deep=True`` additionally opens each settled record's
    ``picks/*.npz`` to prove the manifest↔artifact correspondence
    (skipped by the cheap startup pass). Returns the findings; an empty
    list means the tree is clean."""
    findings: List[Finding] = []

    for p in artifacts.sweep_orphan_tmps(outdir, remove=repair):
        _record_finding(findings, "orphan-tmp", p, repaired=repair)
        if repair:
            _orphans_swept.inc()

    manifest_dirs = []
    for dirpath, _dirs, files in os.walk(outdir):
        if MANIFEST in files:
            manifest_dirs.append(dirpath)
    for dirpath in sorted(manifest_dirs):
        _check_manifest(os.path.join(dirpath, MANIFEST), findings,
                        repair, deep)
    for dirpath in sorted({os.path.normpath(outdir), *manifest_dirs}):
        _check_exports(dirpath, findings, repair)
    return findings


def _autorepair_enabled(flag: Optional[bool]) -> bool:
    if flag is not None:
        return bool(flag)
    return os.environ.get("DAS_FSCK_AUTOREPAIR", "") not in ("", "0",
                                                             "false")


def startup_check(outdir: str, auto_repair: Optional[bool] = None,
                  label: str = "campaign") -> Dict[str, int]:
    """The cheap verify pass every campaign runner executes before trusting a resume manifest (crash-only discipline:
    recovery IS the normal startup path).

    * sweeps orphan tmps (counted in ``das_orphan_tmps_swept_total``),
    * heals a torn manifest tail in place — the expected residue of
      SIGKILL mid-append, safe to truncate because the record never
      completed,
    * REFUSES to resume over deeper corruption (interior corrupt /
      CRC-failed records) unless auto-repair is on (``auto_repair=True``
      or ``DAS_FSCK_AUTOREPAIR=1``), in which case the bad lines are
      quarantined into ``manifest.corrupt.jsonl`` first.

    Cheap by construction: one directory walk plus one manifest scan —
    no ``.npz`` opens (that is ``fsck --repair``'s deep pass).
    """
    summary = {"orphan_tmps": 0, "torn_tail": 0, "corrupt_records": 0}
    if not os.path.isdir(outdir):
        return summary

    orphans = artifacts.sweep_orphan_tmps(outdir, remove=True)
    summary["orphan_tmps"] = len(orphans)
    if orphans:
        _orphans_swept.inc(len(orphans))
        log.warning("%s startup: swept %d orphan tmp file(s) under %s "
                    "(unclean death between write and rename)",
                    label, len(orphans), outdir)

    manifest = os.path.join(outdir, MANIFEST)
    scan = artifacts.scan_ledger(manifest)
    if scan.torn_tail is not None:
        summary["torn_tail"] = 1
        _findings_total.inc(kind="torn-tail")
        _truncate_tail(manifest, scan.torn_tail)
        log.warning("%s startup: truncated torn manifest tail of %s at "
                    "offset %d (SIGKILL mid-append residue; the "
                    "interrupted file will re-run)", label, manifest,
                    scan.torn_tail)
    if scan.bad:
        summary["corrupt_records"] = len(scan.bad)
        for _off, _raw, _verdict in scan.bad:
            _findings_total.inc(kind="corrupt-record")
        if not _autorepair_enabled(auto_repair):
            raise RuntimeError(
                f"{label} startup: {len(scan.bad)} corrupt manifest "
                f"record(s) in {manifest} (not the benign torn tail of "
                f"an unclean death — possible bit rot or tampering). "
                f"Refusing to resume over corrupt state: inspect with "
                f"`das4whales_tpu_torch.fsck.fsck_outdir({outdir!r})`, "
                f"repair with `repair=True`, or set DAS_FSCK_AUTOREPAIR=1 to "
                f"quarantine into {CORRUPT_SIDECAR} automatically.")
        _quarantine(manifest, scan, [raw for _o, raw, _v in scan.bad])
        log.warning("%s startup: quarantined %d corrupt manifest "
                    "record(s) of %s into %s (DAS_FSCK_AUTOREPAIR)",
                    label, len(scan.bad), manifest, CORRUPT_SIDECAR)
    return summary


def render_findings(findings: Sequence[Finding]) -> str:
    """Human-readable fsck report (the CLI's non-``--json`` output)."""
    if not findings:
        return "clean: no findings"
    by_kind: Dict[str, int] = {}
    lines = []
    for f in findings:
        by_kind[f.kind] = by_kind.get(f.kind, 0) + 1
        mark = "repaired" if f.repaired else "FOUND"
        detail = f" ({f.detail})" if f.detail else ""
        lines.append(f"  [{mark}] {f.kind}: {f.path}{detail}")
    head = ", ".join(f"{k}={v}" for k, v in sorted(by_kind.items()))
    return "\n".join([f"{len(findings)} finding(s): {head}", *lines])
