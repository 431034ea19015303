"""The one durable-write layer: crash-only artifact persistence (the
port's copy of ``das4whales_tpu.utils.artifacts``, byte for byte in what
it writes: a manifest line, a JSON export or a picks artifact written by
either package is read by the other).

Every durable artifact this package writes — picks ``.npz``, manifest /
event ledger lines, ``cost_cards.json`` / ``quality.json`` /
``trace.json`` / ``summary.json`` exports, design checkpoints — goes
through this module, so the whole repo has exactly ONE implementation
of each durability idiom:

* :func:`atomic_file` / :func:`atomic_bytes` / :func:`atomic_json` —
  write-then-rename: tmp sibling (``<path>.tmp-<pid>``) + ``fsync`` +
  ``os.replace`` + best-effort directory fsync. A crash at ANY
  instruction leaves either the old artifact or the new one, never a
  torn file; at worst an orphan tmp remains for the startup sweep /
  ``fsck`` (generalizes the picks writer that lived in
  ``workflows.campaign._save_picks``).
* :func:`append_record` — append-only JSON-lines ledger write with an
  optional per-line CRC32 suffix (``DAS_MANIFEST_CRC=1``; OFF by
  default so manifests stay bitwise-identical to the pre-durability
  format) and a bounded fsync policy (``DAS_APPEND_FSYNC=
  bounded|always|never``, default ``bounded``: at most one fsync per
  path per ``DAS_APPEND_FSYNC_S`` seconds — durability without a
  syscall per record). Failed appends truncate back to the record
  boundary, so an in-process write error (ENOSPC mid-line) cannot tear
  the ledger; only SIGKILL can, and only at the tail.
* :func:`parse_record` / :func:`read_records` / :func:`scan_ledger` —
  the torn-tail-tolerant, checksum-verifying reader shared by
  ``_load_settled``, ``summarize_campaign``, the service NDJSON
  long-poll and ``fsck``. Accepts plain and CRC-suffixed lines
  interchangeably; a corrupt interior line or torn tail is skipped (and
  reported), never raised.
* :func:`sweep_orphan_tmps` — find/remove ``*.tmp-<pid>`` residue of a
  kill between write and rename.

Each boundary announces itself to :mod:`..crashpoints` (one tuple
compare when disarmed), which is how a SIGKILL crash-point drill proves the crash-only
claim rather than asserting it.

Stdlib-only (json/os/zlib/threading): importable from the lightest
contexts (``fsck``, a service thread) without touching torch.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from .. import crashpoints

#: Infix of every atomic-write tmp sibling; the orphan sweep and fsck
#: key on it.
TMP_MARKER = ".tmp-"

#: Separator between the JSON body and the CRC32 suffix of a checksummed
#: ledger line. A raw TAB cannot appear inside ``json.dumps`` output
#: (control characters are escaped), so ``rsplit`` on the LAST tab is
#: unambiguous.
CRC_TAG = "\t#crc32:"


def _tmp_path(path: str) -> str:
    return f"{path}{TMP_MARKER}{os.getpid()}"


def _fsync_dir(path: str) -> None:
    """Best-effort fsync of ``path``'s containing directory — the step
    that makes the *rename itself* durable. Best-effort because some
    filesystems (and all of Windows) refuse O_RDONLY directory fds."""
    dirname = os.path.dirname(os.path.abspath(path)) or "."
    try:
        fd = os.open(dirname, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


@contextlib.contextmanager
def atomic_file(path: str, mode: str = "wb") -> Iterator[Any]:
    """Yield a handle onto a tmp sibling of ``path``; on clean exit the
    data is fsynced, renamed over ``path``, and the directory entry is
    fsynced. On ANY failure — an exception from the body, an injected
    write fault, SIGKILL at any instruction — ``path`` is never
    partially written: either the old content survives or the new
    content is complete. The only possible residue is an orphan
    ``*.tmp-<pid>`` (swept at startup; ``fsck`` kind ``orphan-tmp``)."""
    crashpoints.hit("pre-write")
    tmp = _tmp_path(path)
    try:
        with open(tmp, mode) as fh:
            yield fh
            fh.flush()
            os.fsync(fh.fileno())
        crashpoints.hit("post-tmp")
        crashpoints.hit("pre-rename")
        os.replace(tmp, path)
        crashpoints.hit("post-rename")
        crashpoints.hit("pre-dirsync")
        _fsync_dir(path)
    finally:
        if os.path.exists(tmp):
            with contextlib.suppress(OSError):
                os.unlink(tmp)


def atomic_bytes(path: str, data: bytes) -> str:
    """Durably replace ``path`` with ``data`` (see :func:`atomic_file`)."""
    with atomic_file(path, "wb") as fh:
        fh.write(data)
    return path


def atomic_json(path: str, payload: Any, indent: int | None = None) -> str:
    """Durably replace ``path`` with ``json.dumps(payload)`` — the
    byte-exact serialization the direct ``json.dump`` writers produced,
    so migrating an export site onto this layer changes no bytes."""
    return atomic_bytes(
        path, json.dumps(payload, indent=indent).encode("utf-8"))


# ------------------------------------------------------------- appends

def crc_enabled() -> bool:
    """Whether ledger lines get a CRC32 suffix (``DAS_MANIFEST_CRC=1``).
    Off by default: with it off every line is exactly
    ``json.dumps(rec) + "\\n"`` — bitwise-identical to the
    pre-durability manifest format."""
    return os.environ.get("DAS_MANIFEST_CRC", "") not in ("", "0", "false")


def _fsync_policy() -> str:
    pol = os.environ.get("DAS_APPEND_FSYNC", "bounded").strip() or "bounded"
    return pol if pol in ("always", "bounded", "never") else "bounded"


def _fsync_interval_s() -> float:
    try:
        return float(os.environ.get("DAS_APPEND_FSYNC_S", "0.5"))
    except ValueError:
        return 0.5


_append_lock = threading.Lock()
_last_fsync: Dict[str, float] = {}      # abspath -> monotonic stamp
_tail_checked: set = set()              # abspaths verified newline-clean


def _ensure_newline_tail(path: str) -> None:
    """Before this process's FIRST append to ``path``: if a previous
    unclean death left the file without a trailing newline, terminate
    the stranded line so the new record cannot concatenate onto it
    (which would corrupt BOTH records). Crash-only discipline: the torn
    half-line itself stays for the reader to skip / fsck to repair —
    this only guarantees record isolation."""
    apath = os.path.abspath(path)
    with _append_lock:
        if apath in _tail_checked:
            return
        _tail_checked.add(apath)
    try:
        size = os.path.getsize(path)
        if size == 0:
            return
        with open(path, "rb+") as fh:
            fh.seek(-1, os.SEEK_END)
            if fh.read(1) != b"\n":
                fh.write(b"\n")
    except OSError:
        pass


def format_record(record: Dict, crc: bool | None = None) -> str:
    """Serialize one ledger line (without the trailing newline):
    ``json.dumps(record)`` plus, when CRC is on, the
    ``\\t#crc32:<8 hex>`` suffix over the JSON bytes."""
    line = json.dumps(record)
    if crc is None:
        crc = crc_enabled()
    if crc:
        line = f"{line}{CRC_TAG}{zlib.crc32(line.encode('utf-8')):08x}"
    return line


def append_record(path: str, record: Dict, *,
                  crc: bool | None = None) -> None:
    """Append one record to the JSON-lines ledger at ``path``.

    Durability: the write is flushed to the OS every time; fsync
    follows the bounded policy (module docstring). Atomicity: an
    in-process write failure truncates back to the pre-append offset,
    so a raised ENOSPC/EIO cannot leave a torn line mid-file; SIGKILL
    can tear only the final line, which every reader tolerates and the
    startup check / fsck repairs."""
    _ensure_newline_tail(path)
    data = (format_record(record, crc) + "\n").encode("utf-8")
    with open(path, "ab") as fh:
        pos = fh.tell()
        try:
            if crashpoints.pending("append-mid-line"):
                half = max(1, len(data) // 2)
                fh.write(data[:half])
                fh.flush()
                crashpoints.hit("append-mid-line")
                fh.write(data[half:])
            else:
                fh.write(data)
            fh.flush()
            policy = _fsync_policy()
            if policy == "always":
                os.fsync(fh.fileno())
            elif policy == "bounded":
                apath, now = os.path.abspath(path), time.monotonic()
                with _append_lock:
                    due = (now - _last_fsync.get(apath, 0.0)
                           >= _fsync_interval_s())
                    if due:
                        _last_fsync[apath] = now
                if due:
                    os.fsync(fh.fileno())
        except Exception:
            # a failed append must not tear the ledger: rewind to the
            # record boundary (suppressed OSError: nothing more we can
            # do on a dead filesystem — the reader still tolerates it)
            with contextlib.suppress(OSError):
                fh.truncate(pos)
            raise


# -------------------------------------------------------------- readers

def parse_record(line: str) -> Tuple[Optional[Dict], str]:
    """Parse one ledger line into ``(record, verdict)``.

    Verdicts: ``"ok"`` (record is a dict), ``"blank"`` (skip silently),
    ``"crc-mismatch"`` (CRC suffix present but wrong — the body was
    altered), ``"unparseable"`` (torn / foreign / non-object line).
    Plain and CRC-suffixed lines are both accepted — readers never need
    to know whether the writer had ``DAS_MANIFEST_CRC`` on."""
    text = line.rstrip("\r\n")
    if not text.strip():
        return None, "blank"
    if "\t" in text:
        body, _, tag = text.rpartition("\t")
        if tag.startswith("#crc32:"):
            try:
                want = int(tag[len("#crc32:"):], 16)
            except ValueError:
                return None, "crc-mismatch"
            if zlib.crc32(body.encode("utf-8")) != want:
                return None, "crc-mismatch"
            text = body
    try:
        rec = json.loads(text)
    except json.JSONDecodeError:
        return None, "unparseable"
    if not isinstance(rec, dict):
        return None, "unparseable"
    return rec, "ok"


def read_records(path: str,
                 on_bad: Callable[[int, str, str], None] | None = None,
                 ) -> List[Dict]:
    """Read every parseable record from the ledger at ``path``.

    Torn-tail tolerant and checksum-verifying: a line that fails to
    parse (half-written tail of a killed run, CRC mismatch) is skipped
    — resume semantics degrade to "re-run that file", never "refuse to
    start". Each bad line is reported through ``on_bad(lineno, verdict,
    line)`` (1-based) for the caller to warn/count. Missing file: []."""
    records: List[Dict] = []
    try:
        with open(path, "r", encoding="utf-8", errors="replace") as fh:
            for lineno, line in enumerate(fh, 1):
                rec, verdict = parse_record(line)
                if rec is not None:
                    records.append(rec)
                elif verdict != "blank" and on_bad is not None:
                    on_bad(lineno, verdict, line)
    except FileNotFoundError:
        pass
    return records


@dataclass
class LedgerScan:
    """Byte-accurate scan of a ledger file (the fsck view): parsed
    records with their raw line bytes, corrupt interior lines, and the
    offset of a torn (newline-less) tail if one exists."""

    path: str
    size: int = 0
    #: (byte offset, raw line bytes incl. newline, parsed record)
    good: List[Tuple[int, bytes, Dict]] = field(default_factory=list)
    #: (byte offset, raw line bytes, verdict) for complete-but-corrupt
    #: lines (``crc-mismatch`` / ``unparseable``)
    bad: List[Tuple[int, bytes, str]] = field(default_factory=list)
    #: byte offset of an unterminated final segment that does NOT parse
    #: (the SIGKILL-mid-append residue); None when the tail is clean.
    torn_tail: Optional[int] = None

    @property
    def records(self) -> List[Dict]:
        return [rec for _, _, rec in self.good]


def scan_ledger(path: str) -> LedgerScan:
    """Scan ``path`` byte-accurately (see :class:`LedgerScan`). An
    unterminated final segment that still parses is counted as a good
    record (the data is complete; only its newline was lost — the
    append layer restores it before the next write)."""
    scan = LedgerScan(path=path)
    try:
        with open(path, "rb") as fh:
            data = fh.read()
    except FileNotFoundError:
        return scan
    scan.size = len(data)
    offset = 0
    while offset < len(data):
        nl = data.find(b"\n", offset)
        raw = data[offset:] if nl < 0 else data[offset:nl + 1]
        text = raw.decode("utf-8", errors="replace")
        rec, verdict = parse_record(text)
        if rec is not None:
            scan.good.append((offset, raw, rec))
        elif verdict != "blank":
            if nl < 0:
                scan.torn_tail = offset
            else:
                scan.bad.append((offset, raw, verdict))
        offset = len(data) if nl < 0 else nl + 1
    return scan


# ------------------------------------------------------------ tmp sweep

def sweep_orphan_tmps(root: str, remove: bool = True) -> List[str]:
    """Find (and by default unlink) ``*.tmp-<pid>`` residue under
    ``root`` — the footprint of a process killed between tmp write and
    rename. Safe at any time: a LIVE writer's tmp is renamed away
    atomically, and this sweep runs before any writer starts (campaign
    / tenant startup), so nothing racing can lose data."""
    found: List[str] = []
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            stem, sep, pid = name.rpartition(TMP_MARKER)
            if sep and stem and pid.isdigit():
                p = os.path.join(dirpath, name)
                found.append(p)
                if remove:
                    with contextlib.suppress(OSError):
                        os.unlink(p)
    return sorted(found)
