"""``python -m repro_torch.analysis src/repro_torch`` — the lint driver.

Exit codes: 0 clean (every finding baselined), 1 new findings, 2 usage
or unparseable-source errors.  Stale baseline entries (code deleted or
fixed without pruning) are reported as warnings and never fail the run;
``--write-baseline`` rewrites the baseline to the current findings.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import List, Optional

from repro_torch.analysis import baseline as baseline_mod
from repro_torch.analysis.core import Project, all_rules, run_rules

DEFAULT_BASELINE = "analysis-baseline-torch.json"
DEFAULT_PATHS = ["src/repro_torch"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="NEUKONFIG static analysis of the PyTorch port: "
                    "lock/clock/host-sync/registry "
                    "discipline over a Python source tree.")
    p.add_argument("paths", nargs="*", default=DEFAULT_PATHS,
                   help="files or directories to analyze (default: "
                        "src/repro_torch)")
    p.add_argument("--baseline", default=DEFAULT_BASELINE,
                   help=f"accepted-findings file (default: "
                        f"{DEFAULT_BASELINE}; missing file = empty)")
    p.add_argument("--no-baseline", action="store_true",
                   help="report every finding, ignoring the baseline")
    p.add_argument("--write-baseline", action="store_true",
                   help="accept the current findings: rewrite the baseline "
                        "and exit 0")
    p.add_argument("--rules", default=None,
                   help="comma-separated rule ids to run (default: all)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule set and exit")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    rules = all_rules()
    if args.list_rules:
        for r in rules:
            print(f"{r.id}  [{r.severity:7s}] {r.title}")
        return 0
    if args.rules:
        wanted = {r.strip().upper() for r in args.rules.split(",")}
        unknown = wanted - {r.id for r in rules}
        if unknown:
            print(f"unknown rule ids: {sorted(unknown)}", file=sys.stderr)
            return 2
        rules = [r for r in rules if r.id in wanted]

    paths = args.paths or DEFAULT_PATHS
    try:
        project = Project.from_paths(paths)
    except SyntaxError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except OSError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    findings = run_rules(project, rules)

    bl_path = Path(args.baseline)
    if args.write_baseline:
        baseline_mod.save(bl_path, findings)
        print(f"wrote {len(findings)} accepted finding(s) to {bl_path}")
        return 0

    accepted = {} if args.no_baseline else baseline_mod.load(bl_path)
    new, matched, stale = baseline_mod.diff(findings, accepted)

    for f in new:
        print(f.render())
    for entry in stale:
        print(f"stale baseline entry (fixed or deleted?): "
              f"{entry['path']}: {entry['rule']} {entry['context']!r}",
              file=sys.stderr)

    n_mod = len(project.modules)
    if new:
        print(f"\n{len(new)} new finding(s) ({len(matched)} baselined, "
              f"{n_mod} modules); fix, '# nk: allow[...]'-annotate, or "
              f"accept via --write-baseline", file=sys.stderr)
        return 1
    print(f"clean: {n_mod} modules, {len(matched)} baselined finding(s), "
          f"{len(stale)} stale baseline entr(y/ies)")
    return 0
