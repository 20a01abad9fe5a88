"""Concurrency lint CLI of the port (counterpart of
``scripts/lint_concurrency.py``).

Runs the static analyzer over the port's threaded modules: guarded-field
discipline, lock-order graph + rank inversions, blocking-while-locked, and
the declared-name audits (metric names, journal kinds), filtered through
``deepspeed_tpu_torch/analysis/baseline.toml``. Exit 0 = clean (baselined
exceptions excluded); non-zero = findings, printed one per line prefixed
LINT.

    python -m deepspeed_tpu_torch.analysis                    # the gate
    python -m deepspeed_tpu_torch.analysis --no-baseline      # raw findings
    python -m deepspeed_tpu_torch.analysis --update-baseline  # rewrite the
        # baseline; existing justifications survive, new entries get an
        # UNAUDITED placeholder that an audit must replace
"""

import argparse
import os
import sys

from . import (DEFAULT_BASELINE, DEFAULT_PATHS, analyze, check_declared_names,
               load_baseline, render_baseline, run_repo)

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deepspeed_tpu_torch.analysis",
        description=__doc__.splitlines()[0])
    ap.add_argument("paths", nargs="*",
                    help="analysis roots (default: the threaded modules)")
    ap.add_argument("--root", default=_REPO)
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline path, repo-relative")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report raw findings, ignore the baseline")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline to cover current findings "
                         "(preserving existing justifications)")
    ap.add_argument("--quiet", action="store_true",
                    help="summary line only")
    args = ap.parse_args(argv)

    if args.update_baseline:
        if args.paths:
            # a scoped regeneration would silently drop every audited
            # entry covering files outside the given paths
            print("analysis: --update-baseline only works full-scope "
                  "(no path arguments)", file=sys.stderr)
            return 2
        findings = analyze(args.root, DEFAULT_PATHS)
        findings += check_declared_names(args.root)
        entries, _ = load_baseline(args.root, args.baseline)
        text = render_baseline(findings, entries)
        with open(os.path.join(args.root, args.baseline), "w") as fh:
            fh.write(text)
        print(f"analysis: wrote {len(findings)} entries to "
              f"{args.baseline} — audit every UNAUDITED justification")
        return 0

    active, suppressed = run_repo(
        args.root, paths=args.paths or None,
        baseline_path=args.baseline,
        use_baseline=not args.no_baseline)
    if not args.quiet:
        for f in sorted(active, key=lambda f: (f.path, f.line)):
            print(f.render())
    print(f"analysis: {len(active)} finding(s), "
          f"{len(suppressed)} baselined exception(s)")
    return 1 if active else 0


if __name__ == "__main__":
    sys.exit(main())
