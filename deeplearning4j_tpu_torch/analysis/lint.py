"""graftlint CLI (counterpart of ``deeplearning4j_tpu/analysis/lint.py``).

Usage::

    python -m deeplearning4j_tpu_torch.analysis.lint deeplearning4j_tpu_torch
    python -m deeplearning4j_tpu_torch.analysis.lint PKG --fix-baseline
    python -m deeplearning4j_tpu_torch.analysis.lint PKG --no-baseline --json
    python -m deeplearning4j_tpu_torch.analysis.lint PKG --rules host-sync,jit-purity
    python -m deeplearning4j_tpu_torch.analysis.lint PKG --changed
    python -m deeplearning4j_tpu_torch.analysis.lint PKG --sarif out.sarif
    python -m deeplearning4j_tpu_torch.analysis.lint PKG --dialect jax

``--dialect`` picks the call tables (``engine.Dialect``): ``torch``
(default) for the port, ``jax`` for the JAX package's own code. The lint
imports only the standard library.

Baseline workflow: ``baseline.json`` (next to this module by default) maps
line-number-free fingerprints (``path::rule::func::normalized-line-text``)
to allowed occurrence counts. Findings beyond the baseline fail the run
(exit 1); fingerprints in the baseline that no longer occur are reported as
stale (informational). ``--fix-baseline`` rewrites the file to match the
current findings exactly — review the diff like any other code change.

``--changed`` scopes the verdict to files git reports as modified or
untracked (the fast pre-commit path: the whole index is still built — the
interprocedural rules need it — but only findings in changed files can fail
the run, and stale-fingerprint noise from unchanged files is suppressed).
``--sarif FILE`` additionally writes a SARIF 2.1.0 log (``-`` = stdout):
new findings as ``error``/``baselineState: new``, grandfathered ones as
``note``/``unchanged``.

Exit codes (the reference's): 0 clean (vs baseline), 1 new findings,
2 usage/parse/git error.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from collections import Counter
from typing import Dict, List, Optional, Sequence, Set

from deeplearning4j_tpu_torch.analysis import rules as rules_mod
from deeplearning4j_tpu_torch.analysis.engine import DIALECTS, Finding, Index

DEFAULT_BASELINE = os.path.join(os.path.dirname(__file__), "baseline.json")
BASELINE_VERSION = 1


def load_baseline(path: str) -> Dict[str, int]:
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    allowed = data.get("allowed", {})
    return {str(k): int(v) for k, v in allowed.items()}


def save_baseline(path: str, findings: Sequence[Finding]) -> None:
    counts = Counter(f.fingerprint for f in findings)
    data = {
        "version": BASELINE_VERSION,
        "comment": "graftlint frozen findings; regenerate with --fix-baseline "
                   "and review the diff",
        "allowed": {k: counts[k] for k in sorted(counts)},
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(data, f, indent=2, sort_keys=False)
        f.write("\n")


def changed_paths(root: str) -> Optional[Set[str]]:
    """Paths (relative to the lint root's parent, i.e. the same convention
    as ``Finding.path``) git reports as modified vs HEAD or untracked.
    None when git is unavailable / not a repository."""
    parent = os.path.dirname(os.path.abspath(root))
    out: Set[str] = set()
    # --relative / ls-files both yield paths relative to the -C directory,
    # matching the Finding.path convention
    for args in (["diff", "--name-only", "--relative", "HEAD", "--"],
                 ["ls-files", "--others", "--exclude-standard"]):
        try:
            proc = subprocess.run(
                ["git", "-C", parent] + args,
                capture_output=True, text=True, timeout=30, check=True)
        except (OSError, subprocess.SubprocessError):
            return None
        out.update(line.strip() for line in proc.stdout.splitlines()
                   if line.strip())
    return out


def diff_baseline(findings: Sequence[Finding], allowed: Dict[str, int]):
    """Split findings into (new, grandfathered) and report stale fingerprints."""
    budget = dict(allowed)
    new: List[Finding] = []
    old: List[Finding] = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        if budget.get(f.fingerprint, 0) > 0:
            budget[f.fingerprint] -= 1
            old.append(f)
        else:
            new.append(f)
    stale = sorted(k for k, v in budget.items() if v > 0)
    return new, old, stale


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.analysis.lint",
        description="graftlint: trace-safety and host-sync static analysis")
    ap.add_argument("target", help="package directory (or single .py file) to lint")
    ap.add_argument("--baseline", default=None,
                    help=f"baseline json path (default: {DEFAULT_BASELINE})")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline: report every finding and fail "
                         "if there are any")
    ap.add_argument("--fix-baseline", action="store_true",
                    help="rewrite the baseline to match current findings")
    ap.add_argument("--rules", default=None,
                    help="comma-separated subset of rules to run "
                         f"(default: all of {','.join(rules_mod.ALL_RULES)})")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit findings as a json array instead of text")
    ap.add_argument("--changed", action="store_true",
                    help="only findings in files git reports as changed "
                         "(vs HEAD) or untracked can fail the run — the "
                         "fast pre-commit path")
    ap.add_argument("--sarif", default=None, metavar="FILE",
                    help="also write a SARIF 2.1.0 log to FILE ('-' for "
                         "stdout)")
    ap.add_argument("--dialect", default="torch", choices=sorted(DIALECTS),
                    help="call tables to read the target with (default "
                         "torch; jax for the JAX package)")
    args = ap.parse_args(argv)

    if not os.path.exists(args.target):
        print(f"graftlint: no such target: {args.target}", file=sys.stderr)
        return 2

    selected = None
    if args.rules:
        selected = [r.strip() for r in args.rules.split(",") if r.strip()]
        unknown = [r for r in selected if r not in rules_mod.ALL_RULES]
        if unknown:
            print(f"graftlint: unknown rule(s): {', '.join(unknown)} "
                  f"(known: {', '.join(rules_mod.ALL_RULES)})", file=sys.stderr)
            return 2

    index = Index(args.target, dialect=args.dialect)
    if index.errors:
        for f in index.errors:
            print(f.render(), file=sys.stderr)
        return 2

    findings = rules_mod.run(index, selected)

    scope: Optional[Set[str]] = None
    if args.changed:
        scope = changed_paths(args.target)
        if scope is None:
            print("graftlint: --changed requires git and a repository "
                  "above the target", file=sys.stderr)
            return 2
        findings = [f for f in findings if f.path in scope]

    if args.fix_baseline:
        if args.changed:
            print("graftlint: --fix-baseline cannot be combined with "
                  "--changed (it would drop every unchanged file's "
                  "baseline entry)", file=sys.stderr)
            return 2
        path = args.baseline or DEFAULT_BASELINE
        save_baseline(path, findings)
        print(f"graftlint: wrote {len(findings)} finding(s) "
              f"({len({f.fingerprint for f in findings})} fingerprints) "
              f"to {path}")
        return 0

    if args.no_baseline:
        allowed: Dict[str, int] = {}
    else:
        path = args.baseline or DEFAULT_BASELINE
        try:
            allowed = load_baseline(path)
        except FileNotFoundError:
            allowed = {}
        except (json.JSONDecodeError, ValueError, TypeError) as e:
            print(f"graftlint: bad baseline {path}: {e}", file=sys.stderr)
            return 2

    new, old, stale = diff_baseline(findings, allowed)
    if args.changed:
        # scoped runs see only a slice of the findings, so absent
        # fingerprints are expected, not actionable
        stale = []

    if args.sarif:
        from deeplearning4j_tpu_torch.analysis.sarif import to_sarif
        doc = json.dumps(to_sarif(findings, new), indent=2)
        if args.sarif == "-":
            print(doc)
        else:
            with open(args.sarif, "w", encoding="utf-8") as fh:
                fh.write(doc + "\n")

    if args.as_json:
        print(json.dumps([
            {"rule": f.rule, "path": f.path, "line": f.line, "func": f.func,
             "message": f.message, "new": f in set(new)}
            for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule))
        ], indent=2))
    else:
        for f in new:
            print(f.render())
        if stale:
            print(f"graftlint: note: {len(stale)} stale baseline "
                  "fingerprint(s) no longer occur; run --fix-baseline to prune:")
            for k in stale:
                print(f"  {k}")

    if new:
        print(f"graftlint: {len(new)} new finding(s) "
              f"({len(old)} grandfathered by baseline)", file=sys.stderr)
        return 1
    print(f"graftlint: clean ({len(old)} grandfathered, "
          f"{len(stale)} stale baseline entries)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
