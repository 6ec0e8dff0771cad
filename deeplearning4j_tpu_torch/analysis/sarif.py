"""SARIF 2.1.0 emission for graftlint findings (counterpart of
``deeplearning4j_tpu/analysis/sarif.py``).

One run, one ``tool.driver`` (graftlint), one rule descriptor per rule that
produced a finding. New findings (beyond the baseline) are ``error`` with
``baselineState: "new"``; grandfathered ones are ``note`` /
``"unchanged"`` so CI annotates only what the current change introduced.
The line-number-free graftlint fingerprint rides in ``partialFingerprints``
under ``graftlint/v1`` — SARIF consumers use it for cross-run matching the
same way ``baseline.json`` does.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Set

from deeplearning4j_tpu_torch.analysis.engine import Finding

__all__ = ["SARIF_VERSION", "SARIF_SCHEMA_URI", "to_sarif"]

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA_URI = ("https://raw.githubusercontent.com/oasis-tcs/"
                    "sarif-spec/master/Schemata/sarif-schema-2.1.0.json")

# one-line rule descriptions for tool.driver.rules
_RULE_DESCRIPTIONS: Dict[str, str] = {
    "host-sync": "device-to-host pull on the dispatch path",
    "retrace-hazard": "per-call retraces / new signatures per call",
    "jit-purity": "impure value in a traced (rerun) body",
    "numpy-on-tracer": "numpy call on a traced value",
    "lock-discipline": "unguarded shared mutable state",
    "monotonic-clock": "wall clock in duration arithmetic",
    "cost-analysis-off-hot-path": "cost walk or counting pass per batch",
    "tuner-off-hot-path": "tuner search on the hot path",
    "step-wiring": "step update wired outside the step's modules",
    "use-after-donate": "read of a buffer a step donated or rewrote",
    "collective-consistency":
        "rank-divergent or axis-mismatched collective in a mesh step body",
    "durable-store-protocol":
        "non-atomic write on a durable store/checkpoint path",
    "parse-error": "module failed to parse",
}


def _rule_descriptor(rule: str) -> dict:
    desc = _RULE_DESCRIPTIONS.get(rule, rule)
    return {
        "id": rule,
        "shortDescription": {"text": desc},
    }


def _result(f: Finding, is_new: bool) -> dict:
    return {
        "ruleId": f.rule,
        "level": "error" if is_new else "note",
        "message": {"text": f.message},
        "locations": [{
            "physicalLocation": {
                "artifactLocation": {"uri": f.path},
                "region": {"startLine": max(f.line, 1)},
            },
        }],
        "partialFingerprints": {"graftlint/v1": f.fingerprint},
        "baselineState": "new" if is_new else "unchanged",
    }


def to_sarif(findings: Sequence[Finding], new: Iterable[Finding]) -> dict:
    """The full SARIF log dict for one lint run.

    ``findings`` is every finding of the run; ``new`` the subset the
    baseline does not cover (exit-1 drivers)."""
    new_set: Set[Finding] = set(new)
    ordered = sorted(findings, key=lambda f: (f.path, f.line, f.rule))
    rules_seen: List[str] = []
    for f in ordered:
        if f.rule not in rules_seen:
            rules_seen.append(f.rule)
    return {
        "$schema": SARIF_SCHEMA_URI,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {
                "driver": {
                    "name": "graftlint",
                    "informationUri":
                        "https://github.com/deeplearning4j/deeplearning4j",
                    "rules": [_rule_descriptor(r) for r in rules_seen],
                },
            },
            "results": [_result(f, f in new_set) for f in ordered],
        }],
    }
