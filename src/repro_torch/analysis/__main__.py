"""pscheck CLI: ``python -m repro_torch.analysis [paths] [options]``.

Exit status: 0 clean, 1 unbaselined findings or stale baseline entries
(shrink-only: a fixed violation whose ledger entry remains is an error
too), 2 usage errors.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch import analysis


def _default_paths():
    here = Path(__file__).resolve()
    return [str(here.parents[1])]       # src/repro_torch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="pscheck: AST invariant analysis for the GraphBLAS "
                    "stack of the PyTorch port")
    ap.add_argument("paths", nargs="*", help="files/dirs (default: the "
                                             "repro_torch package)")
    ap.add_argument("--rules", help="comma-separated rule ids (default: all)")
    ap.add_argument("--baseline", type=Path,
                    help="baseline JSON; findings in it pass, stale "
                         "entries fail (shrink-only)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite --baseline with the current findings")
    ap.add_argument("--fix", action="store_true",
                    help="apply per-rule fixers in place, then re-analyze")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable findings on stdout")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rid, rule in sorted(analysis.registered_rules().items()):
            fx = "  [has fixer]" if rule.fix else ""
            print(f"{rid:24s} {rule.summary}{fx}")
        return 0

    paths = args.paths or _default_paths()
    rules = ([r.strip() for r in args.rules.split(",") if r.strip()]
             if args.rules else None)

    if args.fix:
        changed = analysis.apply_fixes(paths, rules)
        for p in changed:
            print(f"fixed: {p}", file=sys.stderr)

    findings = analysis.run(paths, rules)

    if args.update_baseline:
        if args.baseline is None:
            ap.error("--update-baseline requires --baseline")
        analysis.write_baseline(findings, args.baseline)
        print(f"baseline written: {args.baseline} "
              f"({len(findings)} entries)", file=sys.stderr)
        return 0

    stale = []
    if args.baseline is not None and args.baseline.exists():
        findings, stale = analysis.apply_baseline(
            findings, analysis.load_baseline(args.baseline))

    if args.as_json:
        print(json.dumps({
            "findings": [
                {"rule": f.rule, "path": f.path, "line": f.line,
                 "col": f.col, "message": f.message,
                 "severity": f.severity, "symbol": f.symbol}
                for f in findings],
            "stale_baseline": [list(k) for k in stale]}, indent=2))
    else:
        for f in findings:
            print(f.format())
        for k in stale:
            print(f"stale baseline entry (shrink the ledger): "
                  f"[{k[0]}] {k[1]}: {k[3]}")
        n = len(findings) + len(stale)
        print(f"pscheck: {len(findings)} finding(s), {len(stale)} stale "
              f"baseline entr{'y' if len(stale) == 1 else 'ies'}"
              if n else "pscheck: clean", file=sys.stderr)

    return 1 if (findings or stale) else 0


if __name__ == "__main__":
    sys.exit(main())
