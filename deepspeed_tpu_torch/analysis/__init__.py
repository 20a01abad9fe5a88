"""Static analysis for the threaded serving/telemetry stack.

Counterpart of ``deepspeed_tpu/analysis`` (pure stdlib AST code; the port
keeps its own copy). ``python -m deepspeed_tpu_torch.analysis`` is its CLI.
The analyzed package is a parameter: ``deepspeed_tpu_torch`` by default,
over the port's threaded modules and against its own ``baseline.toml``.

``run_repo()`` is the one-call entry point the CLI and the tests share: the
three
concurrency checks (guarded fields, lock order, blocking-while-locked —
:mod:`.concurrency`), the declared-name audits (metric names, journal
kinds — :mod:`.declared`), and the audited-exception baseline with
stale-entry detection (:mod:`.baseline`). See docs/CONCURRENCY.md."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from .baseline import (DEFAULT_BASELINE, BaselineEntry, apply_baseline,
                       load_baseline, parse_baseline, render_baseline)
from .concurrency import (DEFAULT_PACKAGE, DEFAULT_PATHS, Finding, analyze,
                          analyze_source, build_model, parse_lock_ranks)
from .declared import (check_declared_names, declared_journal_kinds,
                       declared_metrics)

__all__ = [
    "DEFAULT_BASELINE", "DEFAULT_PACKAGE", "DEFAULT_PATHS", "BaselineEntry",
    "Finding",
    "analyze", "analyze_source", "apply_baseline", "build_model",
    "check_declared_names", "declared_journal_kinds", "declared_metrics",
    "load_baseline", "parse_baseline", "parse_lock_ranks",
    "render_baseline", "run_repo",
]


def run_repo(root: str, paths: Optional[Sequence[str]] = None,
             baseline_path: str = DEFAULT_BASELINE,
             use_baseline: bool = True, package: str = DEFAULT_PACKAGE
             ) -> Tuple[List[Finding], List[Finding]]:
    """(active findings, suppressed findings) for the whole repo —
    concurrency checks over the threaded modules plus ``package``'s
    declared-name audits, filtered through the baseline. Stale-entry
    detection only runs on full-scope (default-paths) invocations — a
    path-scoped run cannot tell "healed" from "out of scope"."""
    findings = analyze(root, tuple(paths) if paths else DEFAULT_PATHS,
                       package)
    findings += check_declared_names(root, package)
    if not use_baseline:
        return findings, []
    entries, problems = load_baseline(root, baseline_path)
    active, suppressed = apply_baseline(findings, entries, baseline_path,
                                        report_stale=paths is None)
    return active + problems, suppressed
