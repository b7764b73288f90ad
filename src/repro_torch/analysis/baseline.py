"""Accepted-findings baseline.

A committed JSON file of findings the project has decided to live with
(legacy wall-clock sites in training/launch code, for instance).  The
analyzer fails only on findings *not* in the baseline, so the tree stays
lint-clean at the margin: new code can't add violations, old accepted
ones don't block CI, and deleting the offending code makes its baseline
entry go stale (reported as a warning, pruned with ``--write-baseline``).

Entries are keyed by ``(path, rule, context)`` where ``context`` is the
stripped source line — stable across unrelated edits that shift line
numbers, invalidated exactly when the offending line itself changes.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

from repro_torch.analysis.core import Finding

Key = Tuple[str, str, str]


def load(path: Path) -> Dict[Key, dict]:
    """Baseline key -> raw entry.  A missing file is an empty baseline."""
    if not path.exists():
        return {}
    data = json.loads(path.read_text())
    out: Dict[Key, dict] = {}
    for entry in data.get("findings", []):
        out[(entry["path"], entry["rule"], entry["context"])] = entry
    return out


def save(path: Path, findings: Iterable[Finding]) -> None:
    entries = [
        {"path": f.path, "rule": f.rule, "context": f.context,
         "line": f.line, "message": f.message}
        for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule))
    ]
    payload = {
        "comment": ("Accepted repro_torch.analysis findings. Regenerate "
                    "with `python -m repro_torch.analysis src/repro_torch "
                    "--write-baseline` after "
                    "deliberately accepting a finding; prefer fixing or "
                    "`# nk: allow[...]`-annotating instead."),
        "findings": entries,
    }
    path.write_text(json.dumps(payload, indent=2) + "\n")


def diff(findings: List[Finding],
         baseline: Dict[Key, dict]) -> Tuple[List[Finding], List[Finding],
                                             List[dict]]:
    """(new, matched, stale): findings vs. the accepted set."""
    new: List[Finding] = []
    matched: List[Finding] = []
    hit = set()
    for f in findings:
        if f.key() in baseline:
            matched.append(f)
            hit.add(f.key())
        else:
            new.append(f)
    stale = [e for k, e in baseline.items() if k not in hit]
    return new, matched, stale
