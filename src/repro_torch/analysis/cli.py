"""Command line for the invariant checker.

::

    python -m repro_torch.analysis [--format text|json] [--rules RA1,RA5]

``--trace LOG.jsonl`` (repeatable) switches from static rules to trace
conformance: the RA6/RA7 protocol checker over recorded event logs,
with the same formats, allowlist and exit codes.

Exit status: 0 clean, 1 findings, 2 bad usage.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.analysis import engine


def default_root() -> Path:
    """The repo checkout this package sits in (…/src/repro_torch/analysis/
    cli.py -> repo root), falling back to the current directory when
    the package is installed out of tree."""
    candidate = Path(__file__).resolve().parents[3]
    if (candidate / "src" / "repro_torch").is_dir():
        return candidate
    return Path.cwd()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.analysis",
        description="AST-based invariant checker: wire/event/meter "
                    "conformance, concurrency lints and protocol-spec "
                    "drift (RA1..RA8), plus trace conformance "
                    "(--trace).")
    ap.add_argument("--root", default=None,
                    help="repo root to check (default: autodetected)")
    ap.add_argument("--format", choices=("text", "json"),
                    default="text")
    ap.add_argument("--rules", default=None, metavar="RA1,RA2,…",
                    help="comma-separated rule ids (default: all)")
    ap.add_argument("--allowlist", default=None,
                    help="allowlist file (default: the packaged "
                         "src/repro_torch/analysis/allowlist.txt); "
                         "'none' disables suppression")
    ap.add_argument("--trace", action="append", default=[],
                    metavar="LOG.jsonl",
                    help="conformance-check this recorded event log "
                         "instead of running static rules (repeatable)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rid, title in sorted(engine.rule_titles().items()):
            print(f"{rid}  {title}")
        return 0

    allowlist = (None if args.allowlist == "none"
                 else args.allowlist or engine.DEFAULT_ALLOWLIST)

    if args.trace:
        from repro_torch.analysis import trace
        if args.rules:
            print("error: --rules applies to static analysis, not "
                  "--trace", file=sys.stderr)
            return 2
        findings, n_suppressed = trace.run_trace(
            args.trace, allowlist=allowlist)
        fmt = (engine.format_json if args.format == "json"
               else engine.format_text)
        print(fmt(findings, n_suppressed, list(trace.TRACE_RULES)))
        return 1 if findings else 0

    root = Path(args.root) if args.root else default_root()
    if not (root / "src" / "repro_torch").is_dir():
        print(f"error: {root} does not look like the repo root "
              f"(no src/repro_torch)", file=sys.stderr)
        return 2
    rules = ([r.strip() for r in args.rules.split(",") if r.strip()]
             if args.rules else None)
    try:
        findings, n_suppressed = engine.run_rules(
            root, rules, allowlist=allowlist)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    ran = rules or engine.rule_ids()
    fmt = (engine.format_json if args.format == "json"
           else engine.format_text)
    print(fmt(findings, n_suppressed, ran))
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
