"""daslint CLI for the port: ``python -m das4whales_tpu_torch.analysis
[paths ...]``.

Exit codes: 0 clean (every finding baselined or none), 1 findings above
the baseline, 2 usage/baseline errors. Findings print as
``path:line:col: RULE[code] message (in symbol)`` — editor/CI clickable.

Examples::

    python -m das4whales_tpu_torch.analysis                    # lint the port
    python -m das4whales_tpu_torch.analysis das4whales_tpu_torch/ops
    python -m das4whales_tpu_torch.analysis --rules R3 scratch.py
    python -m das4whales_tpu_torch.analysis --write-baseline   # regenerate ledger
    python -m das4whales_tpu_torch.analysis --check            # CI/lint entry
    python -m das4whales_tpu_torch.analysis --check --programs --device cpu

``--programs`` records the canonical programs on the card unless the
caller passes ``--device cpu``; without a card and without it, it raises
(it never falls back to the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import DEFAULT_BASELINE, baseline as baseline_mod
from .rules import ALL_RULES, PROGRAM_RULES, analyze_paths


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m das4whales_tpu_torch.analysis",
        description="daslint: hazard analyzer of the PyTorch/CUDA port "
                    f"(rules {', '.join(ALL_RULES)})",
    )
    ap.add_argument("paths", nargs="*",
                    help="files/directories to analyze (default: the "
                         "das4whales_tpu_torch package)")
    ap.add_argument("--rules", default=",".join(ALL_RULES),
                    help="comma-separated rule subset (default: all)")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline file (default: {DEFAULT_BASELINE})")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, ignoring the baseline")
    ap.add_argument("--write-baseline", action="store_true",
                    help="regenerate the baseline from current findings "
                         "(preserves reasons of persisting entries) and exit 0")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")
    ap.add_argument("--check", action="store_true",
                    help="lint-gate mode (the default behavior, spelled "
                         "explicitly for CI entry points); also prints a "
                         "summary line and fails on stale baseline entries")
    ap.add_argument("--programs", action="store_true",
                    help="also run the R11/R13 program-contract audit over "
                         "the canonical program variants (imports torch, one "
                         "recorded probe per variant)")
    ap.add_argument("--write-contracts", action="store_true",
                    help="regenerate analysis/contracts.json (the R13 "
                         "op-count snapshot) from the canonical variants "
                         "and exit 0")
    ap.add_argument("--device", default=None,
                    help="device the programs are recorded on (default: the "
                         "card; 'cpu' runs the plain versions on the CPU)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    rules = tuple(r.strip().upper() for r in args.rules.split(",") if r.strip())
    bad = [r for r in rules if r not in ALL_RULES]
    if bad:
        print(f"unknown rule(s): {', '.join(bad)} (have {', '.join(ALL_RULES)})",
              file=sys.stderr)
        return 2

    if args.write_contracts:
        from . import programs as programs_mod

        import torch  # deferred: the AST paths never pay this import

        artifacts = programs_mod.canonical_artifacts(device=args.device)
        snap = programs_mod.build_contracts(
            artifacts, torch_version=torch.__version__,
            device=artifacts[0].device if artifacts else "")
        with open(programs_mod.DEFAULT_CONTRACTS, "w", encoding="utf-8") as fh:
            fh.write(programs_mod.dump_contracts(snap))
        print(f"wrote {programs_mod.DEFAULT_CONTRACTS} "
              f"({len(snap['programs'])} program contracts)", file=sys.stderr)
        return 0

    paths = args.paths or [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
    findings = analyze_paths(paths, rules)
    syntax_errors = [f for f in findings if f.rule == "E0"]
    findings = [f for f in findings if f.rule != "E0"]

    program_rules = tuple(r for r in rules if r in PROGRAM_RULES)
    if args.programs and program_rules:
        # the torch-importing half: record the canonical variants (one
        # probe each; the audit itself reads the recorded streams)
        from . import programs as programs_mod

        findings += programs_mod.audit_canonical(program_rules, device=args.device)

    baseline_path = args.baseline or DEFAULT_BASELINE
    if args.write_baseline:
        # regeneration only replaces what this invocation actually scanned
        # — entries for unscanned files or unselected rules are carried
        # over, so a partial `--rules`/path run cannot wipe the ledger
        merged = list(findings)
        reasons = {}
        if os.path.exists(baseline_path):
            from .rules import canonical_path, iter_python_files
            scanned = {canonical_path(p) for p in iter_python_files(paths)}
            try:
                with open(baseline_path, "r", encoding="utf-8") as fh:
                    entries = baseline_mod.parse(fh.read())
            except baseline_mod.BaselineError as exc:
                print(f"daslint: {exc}", file=sys.stderr)
                return 2
            kept = [e for e in entries
                    if str(e.get("path")) not in scanned
                    or str(e.get("rule")) not in rules]
            carried, reasons = baseline_mod.entries_as_findings(kept)
            merged += carried
            reasons.update(baseline_mod.reasons_of(baseline_path))
        with open(baseline_path, "w", encoding="utf-8") as fh:
            fh.write(baseline_mod.dump(merged, reasons))
        print(f"wrote {baseline_path} ({len(merged)} findings baselined)",
              file=sys.stderr)
        return 0

    stale = []
    if args.no_baseline or not os.path.exists(baseline_path):
        new, suppressed = findings, []
        new = sorted(new, key=lambda f: (f.path, f.line, f.col))
    else:
        try:
            bl = baseline_mod.load(baseline_path)
        except baseline_mod.BaselineError as exc:
            print(f"daslint: {exc}", file=sys.stderr)
            return 2
        new, suppressed = baseline_mod.apply(findings, bl)
        if args.check:
            # stale-ledger gate: a baselined key with no live finding
            # site is a fixed hazard whose entry can silently mask its
            # return. Scoped to what THIS run scanned — a path or
            # --rules subset judges nothing else.
            from .rules import canonical_path, iter_python_files

            scanned = {canonical_path(p) for p in iter_python_files(paths)}
            if args.programs:
                scanned |= {path for (_r, path, _s) in bl
                            if path.startswith("program:")}
            stale = baseline_mod.stale_keys(
                findings, bl, scanned_paths=scanned, rules=rules)
            for rule, path, symbol in stale:
                print(f"{path}: stale baseline entry (remove me): {rule} "
                      f"for symbol `{symbol}` no longer matches any "
                      "finding site")

    new = syntax_errors + new
    if args.as_json:
        print(json.dumps({
            "findings": [vars(f) for f in new],
            "suppressed": len(suppressed),
            "stale": [list(k) for k in stale],
        }, indent=1))
    else:
        for f in new:
            print(f.format())
    if args.check or not args.as_json:
        print(f"daslint: {len(new)} finding(s), {len(suppressed)} baselined, "
              f"{len(stale)} stale, rules {','.join(rules)}", file=sys.stderr)
    return 1 if new or stale else 0


if __name__ == "__main__":
    sys.exit(main())
