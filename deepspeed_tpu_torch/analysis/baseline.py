"""Audited-exception baseline for the concurrency lint.

Counterpart of ``deepspeed_tpu/analysis/baseline.py``; the port's own
baseline is ``deepspeed_tpu_torch/analysis/baseline.toml``.

``analysis/baseline.toml`` records findings a human audited and accepted
— each entry needs the finding's stable ``id`` (no line numbers, so it
survives unrelated edits) and a non-empty ``justification``. The
contract is anti-rot in both directions:

- a finding whose id is baselined is suppressed (but still reported as
  suppressed, for visibility);
- a baseline entry matching NO current finding is itself an error
  (``stale-baseline``) — fixed code must shed its exception;
- an entry with an empty justification is an error
  (``baseline-unjustified``) — the audit trail is the point.

The file is a TOML subset parsed here without third-party deps (the
container has no tomllib/tomli): comments, ``[[finding]]`` tables, and
``key = "string"`` pairs."""

from __future__ import annotations

import dataclasses
import os
import re
from typing import List, Sequence, Tuple

from .concurrency import Finding

DEFAULT_BASELINE = "deepspeed_tpu_torch/analysis/baseline.toml"

_KV = re.compile(r'^(\w+)\s*=\s*"(.*)"\s*$')


@dataclasses.dataclass
class BaselineEntry:
    id: str
    justification: str
    line: int


def parse_baseline(text: str, path: str = DEFAULT_BASELINE
                   ) -> Tuple[List[BaselineEntry], List[Finding]]:
    """(entries, parse problems). Problems are findings so the CLI and
    tests treat a malformed baseline like any other lint failure."""
    entries: List[BaselineEntry] = []
    problems: List[Finding] = []
    current = None
    for i, raw in enumerate(text.splitlines(), start=1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line == "[[finding]]":
            current = BaselineEntry("", "", i)
            entries.append(current)
            continue
        m = _KV.match(line)
        if m and current is not None:
            if m.group(1) == "id":
                current.id = m.group(2)
            elif m.group(1) == "justification":
                current.justification = m.group(2)
            continue
        problems.append(Finding(
            "baseline-parse", path, i, "<baseline>", f"line-{i}",
            f"unparseable baseline line: {raw!r}"))
    for e in entries:
        if not e.id:
            problems.append(Finding(
                "baseline-parse", path, e.line, "<baseline>",
                f"line-{e.line}", "baseline entry without an id"))
        elif not e.justification.strip():
            problems.append(Finding(
                "baseline-unjustified", path, e.line, "<baseline>", e.id,
                f"baseline entry {e.id!r} has no justification — every "
                "audited exception must say why it is safe"))
    return entries, problems


def load_baseline(root: str, path: str = DEFAULT_BASELINE
                  ) -> Tuple[List[BaselineEntry], List[Finding]]:
    full = os.path.join(root, path)
    if not os.path.exists(full):
        return [], []
    with open(full) as fh:
        return parse_baseline(fh.read(), path)


def apply_baseline(findings: Sequence[Finding],
                   entries: Sequence[BaselineEntry],
                   path: str = DEFAULT_BASELINE,
                   report_stale: bool = True
                   ) -> Tuple[List[Finding], List[Finding]]:
    """(active findings, suppressed findings). Stale entries — audited
    ids no current finding carries — are appended to the ACTIVE list:
    the baseline may only shrink when the code actually healed.
    ``report_stale=False`` is for path-SCOPED runs: an entry covering a
    file outside the analyzed paths is out of scope, not healed, and
    must not be reported for deletion."""
    ids = {e.id for e in entries if e.id}
    active = [f for f in findings if f.baseline_id not in ids]
    suppressed = [f for f in findings if f.baseline_id in ids]
    if report_stale:
        matched = {f.baseline_id for f in suppressed}
        for e in entries:
            if e.id and e.id not in matched:
                active.append(Finding(
                    "stale-baseline", path, e.line, "<baseline>", e.id,
                    f"baseline entry {e.id!r} matches no current "
                    "finding — the exception healed; delete the entry"))
    return active, suppressed


def render_baseline(findings: Sequence[Finding],
                    entries: Sequence[BaselineEntry]) -> str:
    """A fresh baseline covering ``findings``: existing justifications
    are preserved; new entries get an UNAUDITED placeholder that an audit
    must replace (mechanically valid, visibly unaudited)."""
    just = {e.id: e.justification for e in entries if e.justification}
    lines = [
        "# Concurrency-lint baseline — audited exceptions "
        "(docs/CONCURRENCY.md).",
        "# Every entry needs a justification; stale entries are errors.",
        "",
    ]
    for f in sorted({f.baseline_id: f for f in findings}.values(),
                    key=lambda f: f.baseline_id):
        lines.append("[[finding]]")
        lines.append(f'id = "{f.baseline_id}"')
        j = just.get(f.baseline_id,
                     f"UNAUDITED: {f.detail.splitlines()[0]}")
        lines.append(f'justification = "{j}"')
        lines.append("")
    return "\n".join(lines)
