"""daslint baseline for the port — the ledger of accepted findings (the
counterpart of ``das4whales_tpu.analysis.baseline``).

A baseline entry suppresses a *known, reasoned* finding so the gate can be
strict for everything new: the analyzer fails on any finding whose
``(rule, path, symbol)`` key exceeds its baselined count. Entries carry a
``reason`` so the file doubles as the donation/factory audit the rules
reference. Every entry of the port's ``baseline.toml`` carries a reason
specific to its site.

The file is a deliberately tiny TOML subset (``[[finding]]`` tables with
string/int scalar keys) read and written by the stdlib-only code below,
the same subset as the JAX package's, so either package's parser reads
the other's text.
"""

from __future__ import annotations

import collections
import re
from typing import Dict, Iterable, List, Tuple

from .rules import Finding

Key = Tuple[str, str, str]  # (rule, path, symbol)

_TABLE_RE = re.compile(r"^\[\[finding\]\]\s*$")
_KV_RE = re.compile(r'^(\w+)\s*=\s*(?:"((?:[^"\\]|\\.)*)"|(\d+))\s*$')


class BaselineError(ValueError):
    pass


def parse(text: str) -> List[Dict[str, object]]:
    """Parse the baseline TOML subset into a list of entry dicts."""
    entries: List[Dict[str, object]] = []
    current: Dict[str, object] | None = None
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if _TABLE_RE.match(line):
            current = {}
            entries.append(current)
            continue
        m = _KV_RE.match(line)
        if not m:
            raise BaselineError(f"baseline line {lineno}: cannot parse {raw!r}")
        if current is None:
            raise BaselineError(
                f"baseline line {lineno}: key outside a [[finding]] table")
        key = m.group(1)
        if m.group(3) is not None:
            current[key] = int(m.group(3))
        else:
            current[key] = m.group(2).replace('\\"', '"').replace("\\\\", "\\")
    return entries


def load(path) -> Dict[Key, int]:
    """Baseline file -> {(rule, path, symbol): allowed count}."""
    with open(path, "r", encoding="utf-8") as fh:
        entries = parse(fh.read())
    counts: Dict[Key, int] = collections.Counter()
    for e in entries:
        try:
            key = (str(e["rule"]), str(e["path"]), str(e["symbol"]))
        except KeyError as exc:
            raise BaselineError(f"baseline entry missing {exc} field: {e}")
        counts[key] += int(e.get("count", 1))
    return dict(counts)


def _quote(value: str) -> str:
    return '"' + value.replace("\\", "\\\\").replace('"', '\\"') + '"'


def dump(findings: Iterable[Finding], reasons: Dict[Key, str] | None = None) -> str:
    """Findings -> baseline text, one [[finding]] table per distinct key
    with a count. ``reasons`` (by key) are carried into the entries;
    regeneration preserves reasons for keys that persist."""
    reasons = reasons or {}
    grouped: Dict[Key, List[Finding]] = collections.defaultdict(list)
    for f in findings:
        grouped[f.key()].append(f)
    out = [
        "# daslint baseline — accepted findings with reasons.",
        "# Regenerate: python -m das4whales_tpu_torch.analysis --write-baseline",
        "# Gate: any finding above its baselined count fails the run.",
        "",
    ]
    for key in sorted(grouped):
        rule, path, symbol = key
        fs = grouped[key]
        out.append("[[finding]]")
        out.append(f"rule = {_quote(rule)}")
        out.append(f"path = {_quote(path)}")
        out.append(f"symbol = {_quote(symbol)}")
        out.append(f"code = {_quote(fs[0].code)}")
        if len(fs) > 1:
            out.append(f"count = {len(fs)}")
        reason = reasons.get(key)
        if reason:
            out.append(f"reason = {_quote(reason)}")
        out.append("")
    return "\n".join(out)


def entries_as_findings(entries: List[Dict[str, object]]):
    """Expand parsed baseline entries back into synthetic findings (one
    per ``count``) plus their reasons, so :func:`dump` can merge entries
    that a partial re-scan did not cover with freshly-scanned findings."""
    findings: List[Finding] = []
    reasons: Dict[Key, str] = {}
    for e in entries:
        if not {"rule", "path", "symbol"} <= e.keys():
            continue
        key = (str(e["rule"]), str(e["path"]), str(e["symbol"]))
        if "reason" in e:
            reasons[key] = str(e["reason"])
        for _ in range(int(e.get("count", 1))):
            findings.append(Finding(
                rule=key[0], code=str(e.get("code", "")), path=key[1],
                line=0, col=0, symbol=key[2], message=""))
    return findings, reasons


def reasons_of(path) -> Dict[Key, str]:
    """Extract {key: reason} from an existing baseline file (for
    reason-preserving regeneration); empty on a missing file."""
    try:
        with open(path, "r", encoding="utf-8") as fh:
            entries = parse(fh.read())
    except FileNotFoundError:
        return {}
    out: Dict[Key, str] = {}
    for e in entries:
        if "reason" in e and {"rule", "path", "symbol"} <= e.keys():
            out[(str(e["rule"]), str(e["path"]), str(e["symbol"]))] = str(e["reason"])
    return out


def stale_keys(findings: List[Finding], baseline: Dict[Key, int], *,
               scanned_paths: Iterable[str] | None = None,
               rules: Iterable[str] | None = None) -> List[Key]:
    """Baselined keys with NO matching live finding site — entries whose
    hazard was fixed but whose ledger line rotted in place, silently
    able to mask the hazard's return. Scoped to
    what this invocation actually saw: a key outside ``scanned_paths``
    or ``rules`` is unjudgeable in a partial scan (``--changed``, a
    ``--rules`` subset) and never reported. Program-audit keys
    (``path="program:<bucket>"``) are judged only when a program path
    was scanned — i.e. the invocation ran the ``--programs`` audit."""
    live = {f.key() for f in findings}
    scanned = None if scanned_paths is None else set(scanned_paths)
    rule_set = None if rules is None else set(rules)
    out: List[Key] = []
    for key in baseline:
        rule, path, _symbol = key
        if rule_set is not None and rule not in rule_set:
            continue
        if scanned is not None and path not in scanned:
            continue
        if key not in live:
            out.append(key)
    return sorted(out)


def apply(findings: List[Finding], baseline: Dict[Key, int]):
    """Split findings into (new, suppressed) against the baseline.

    For each key, up to ``baseline[key]`` findings are suppressed (lowest
    line numbers first, so the *new* occurrence in a file with a baselined
    sibling is the one reported); the rest are new.
    """
    grouped: Dict[Key, List[Finding]] = collections.defaultdict(list)
    for f in findings:
        grouped[f.key()].append(f)
    new: List[Finding] = []
    suppressed: List[Finding] = []
    for key, fs in grouped.items():
        fs = sorted(fs, key=lambda f: (f.line, f.col))
        allowed = baseline.get(key, 0)
        suppressed.extend(fs[:allowed])
        new.extend(fs[allowed:])
    new.sort(key=lambda f: (f.path, f.line, f.col))
    suppressed.sort(key=lambda f: (f.path, f.line, f.col))
    return new, suppressed
