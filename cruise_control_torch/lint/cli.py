"""cclint command line for the port: `python -m cruise_control_torch.lint`.

The JAX package's CLI (its flags, its output formats, its exit codes) with
one flag more, `--device`, the device the trace tier's worker runs the
entry points on: `cuda` by default, as `main.py`'s. Without a card a
`cuda` trace run stops with exit 2 and names the missing card; it does not
fall back to the CPU (the tests pass `--device cpu`).

Exit codes (stable):
  0  clean (no unsuppressed findings)
  1  unsuppressed findings
  2  usage or internal error, or no card for `--device cuda`

`--tier` selects the analysis tier: `token` (pure ast/text — the fast local
loop), `trace` (the registered kernel entry points run under a dispatch
recorder, content-hash cached), or `all` (default). `--json` emits the
machine schema v2 (per-rule family/tier/wall-time plus the trace cache
verdict); the default human format is one `path:line: rule  message` per
finding plus a summary line. `--changed-only` lints the full context
(registry rules need every file) but reports only findings in files that
differ from `--base` (default `main`) or are locally modified/untracked —
stale suppressions for the selected rules are judged on these runs too.
"""

from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
from typing import List, Optional, Sequence

from cruise_control_torch.lint.core import (
    EXIT_CLEAN,
    EXIT_ERROR,
    EXIT_FINDINGS,
    RULES,
    DeviceUnavailable,
    all_rules,
    build_context,
    render_human,
    render_json,
    run_rules,
    tier_rules,
    unsuppressed,
)


def changed_paths(root: pathlib.Path, base: str = "main") -> Optional[List[str]]:
    """Repo-relative posix paths that differ from `base` or the index, plus
    untracked files; None when git is unavailable (callers fall back to a
    full report)."""
    out: List[str] = []
    succeeded = 0
    for args in (
        ["git", "diff", "--name-only", f"{base}...HEAD"],
        ["git", "diff", "--name-only", "HEAD"],
        ["git", "ls-files", "--others", "--exclude-standard"],
    ):
        try:
            proc = subprocess.run(
                args, cwd=root, capture_output=True, text=True, timeout=30
            )
        except (OSError, subprocess.TimeoutExpired):
            return None
        if proc.returncode != 0:
            # the three-dot diff fails when `base` is missing; degrade to
            # the working-tree diffs rather than silently reporting nothing
            continue
        succeeded += 1
        out.extend(line.strip() for line in proc.stdout.splitlines() if line.strip())
    if not succeeded:
        return None  # not a repo / git missing: caller falls back to full report
    return sorted(set(out))


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="cclint",
        description="static analysis of the PyTorch port: CUDA round hygiene, "
                    "concurrency discipline, config/sensor registry consistency, "
                    "and dispatch-level kernel entry-point certification",
    )
    parser.add_argument("paths", nargs="*", type=pathlib.Path,
                        help="files or directories to lint (default: the "
                             "cruise_control_torch package)")
    parser.add_argument("--root", type=pathlib.Path, default=None,
                        help="repo root (default: auto from this file)")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="machine-readable output (schema v2)")
    parser.add_argument("--rule", action="append", default=None, metavar="ID",
                        help="run only this rule (repeatable; overrides --tier)")
    parser.add_argument("--tier", choices=("token", "trace", "all"),
                        default="all",
                        help="analysis tier: token = ast/text rules only, "
                             "trace = dispatch-level entry-point rules only, "
                             "all = both (default)")
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="device the trace tier runs the entry points on "
                             "(default: cuda; without a card the run stops "
                             "with exit 2)")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalog and exit")
    parser.add_argument("--changed-only", action="store_true",
                        help="report only findings in files changed vs --base")
    parser.add_argument("--base", default="main",
                        help="comparison ref for --changed-only (default: main)")
    parser.add_argument("--show-suppressed", action="store_true",
                        help="include suppressed findings in human output")
    args = parser.parse_args(argv)

    rules = all_rules()
    if args.list_rules:
        for r in rules:
            print(f"{r.id:28s} [{r.family}/{r.tier}] {r.rationale}")
        return EXIT_CLEAN

    if args.rule:
        missing = [rid for rid in args.rule if rid not in RULES]
        if missing:
            print(f"cclint: unknown rule id(s): {', '.join(missing)}",
                  file=sys.stderr)
            return EXIT_ERROR
        rules = [RULES[rid] for rid in args.rule]
    else:
        rules = tier_rules(args.tier)

    root = args.root
    if root is None:
        root = pathlib.Path(__file__).resolve().parents[2]
    try:
        ctx = build_context(root, py_paths=args.paths or None, device=args.device)
    except OSError as e:
        print(f"cclint: cannot read sources: {e}", file=sys.stderr)
        return EXIT_ERROR

    timings: dict = {}
    try:
        findings = run_rules(ctx, rules=rules, timings=timings)
    except DeviceUnavailable as e:
        print(f"cclint: {e}", file=sys.stderr)
        return EXIT_ERROR

    if args.changed_only:
        changed = changed_paths(root, base=args.base)
        if changed is None:
            print("cclint: git unavailable; reporting all findings",
                  file=sys.stderr)
        else:
            changed_set = set(changed)
            findings = [f for f in findings if f.path in changed_set]

    if args.as_json:
        print(render_json(findings, len(ctx.files), rules, timings=timings,
                          trace_stats=ctx.cache.get("trace-stats")))
    else:
        print(render_human(findings, len(ctx.files), len(rules),
                           show_suppressed=args.show_suppressed))
    return EXIT_FINDINGS if unsuppressed(findings) else EXIT_CLEAN


if __name__ == "__main__":
    raise SystemExit(main())
