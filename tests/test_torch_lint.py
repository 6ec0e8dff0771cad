"""The port's graftlint (``deeplearning4j_tpu_torch/analysis/``) on the CPU.

- **The JAX dialect against the reference**, on the reference's inputs:
  the port's engine and rules give the JAX package's findings, as equal
  multisets of ``(rule, path, func, fingerprint)``, on
  ``tests/fixtures/graftlint/`` and on two real subpackages of the JAX
  package; the CLI gives the reference's verdicts there (exit codes,
  ``--fix-baseline``, stale entries, ``--rules``, ``--changed`` in a
  temporary git repository, SARIF 2.1.0 with new = error and grandfathered
  = note).
- **The torch dialect** on ``tests/fixtures/graftlint_torch/``: each of the
  twelve rules fires on its true positive, each clean shape stays clean,
  and inline suppressions are honoured.
- **The port lints clean** against its checked-in baseline, and the lint
  imports nothing but the standard library.
"""

import collections
import json
import os
import shutil
import subprocess
import sys

import pytest

from deeplearning4j_tpu.analysis import lint as jlint
from deeplearning4j_tpu.analysis import rules as jrules
from deeplearning4j_tpu.analysis.engine import Index as JIndex
from deeplearning4j_tpu_torch.analysis import lint
from deeplearning4j_tpu_torch.analysis import rules
from deeplearning4j_tpu_torch.analysis.engine import Index

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
FIXTURES = os.path.join(HERE, "fixtures", "graftlint")
TORCH_FIXTURES = os.path.join(HERE, "fixtures", "graftlint_torch")
PORT = os.path.join(REPO, "deeplearning4j_tpu_torch")
ROOTS = {"fixtures": FIXTURES,
         "serve": os.path.join(REPO, "deeplearning4j_tpu", "serve"),
         "train": os.path.join(REPO, "deeplearning4j_tpu", "train")}


def _multiset(findings):
    return collections.Counter((f.rule, f.path, f.func, f.fingerprint) for f in findings)


@pytest.fixture(scope="module")
def jax_dialect_runs():
    """Each root linted once by both packages (one index each)."""
    return {name: (_multiset(jrules.run(JIndex(root))),
                   _multiset(rules.run(Index(root, dialect="jax"))))
            for name, root in ROOTS.items()}


@pytest.fixture(scope="module")
def torch_findings():
    return rules.run(Index(TORCH_FIXTURES))


# -- the JAX dialect against the reference ----------------------------------------

@pytest.mark.parametrize("root", sorted(ROOTS))
def test_jax_dialect_gives_the_references_findings(jax_dialect_runs, root):
    want, got = jax_dialect_runs[root]
    assert got == want
    if root == "fixtures":
        assert {k[0] for k in want} == set(rules.ALL_RULES) == set(jrules.ALL_RULES)


def _both(args, capsys):
    """(exit code, stdout, stderr) of the reference CLI and the port's."""
    out = []
    for main, extra in ((jlint.main, []), (lint.main, ["--dialect", "jax"])):
        rc = main(list(args) + extra)
        cap = capsys.readouterr()
        out.append((rc, cap.out, cap.err))
    return out


def test_cli_fails_on_the_fixtures_without_a_baseline(capsys):
    (jrc, jout, jerr), (rc, out, err) = _both([FIXTURES, "--no-baseline"], capsys)
    assert jrc == rc == 1
    assert "[host-sync]" in out and "new finding(s)" in err
    assert out.count("\n") == jout.count("\n")


def test_cli_fix_baseline_then_clean(tmp_path, capsys):
    jbl, bl = str(tmp_path / "j.json"), str(tmp_path / "p.json")
    assert jlint.main([FIXTURES, "--baseline", jbl, "--fix-baseline"]) == 0
    assert lint.main([FIXTURES, "--baseline", bl, "--fix-baseline", "--dialect", "jax"]) == 0
    with open(jbl) as a, open(bl) as b:
        assert json.load(a)["allowed"] == json.load(b)["allowed"]
    capsys.readouterr()
    assert lint.main([FIXTURES, "--baseline", bl, "--dialect", "jax"]) == 0
    assert "clean" in capsys.readouterr().out


def test_cli_reports_stale_baseline_entries_without_failing(tmp_path, capsys):
    bl = tmp_path / "bl.json"
    lint.main([FIXTURES, "--baseline", str(bl), "--fix-baseline", "--dialect", "jax"])
    data = json.loads(bl.read_text())
    data["allowed"]["gone.py::host-sync::f::x = y"] = 1
    bl.write_text(json.dumps(data))
    capsys.readouterr()
    (jrc, jout, _), (rc, out, _) = _both([FIXTURES, "--baseline", str(bl)], capsys)
    assert jrc == rc == 0
    assert "stale" in out and "stale" in jout


def test_cli_rule_subset_unknown_rule_and_missing_target(capsys):
    (jrc, _, _), (rc, out, _) = _both([FIXTURES, "--no-baseline", "--rules",
                                       "lock-discipline"], capsys)
    assert jrc == rc == 1
    assert "[lock-discipline]" in out and "[host-sync]" not in out
    (jrc, _, _), (rc, _, _) = _both([FIXTURES, "--rules", "no-such-rule"], capsys)
    assert jrc == rc == 2
    (jrc, _, _), (rc, _, _) = _both(["/no/such/path"], capsys)
    assert jrc == rc == 2
    with pytest.raises(SystemExit) as e:
        lint.main([FIXTURES, "--dialect", "no-such-dialect"])
    assert e.value.code == 2


_VIOLATION_SRC = "import time\n\n\ndef age(t0):\n    return time.time() - t0\n"


def test_cli_changed_scope_matches_the_reference(tmp_path, capsys):
    if shutil.which("git") is None:
        pytest.skip("git unavailable")
    env = dict(os.environ, GIT_AUTHOR_NAME="t", GIT_AUTHOR_EMAIL="t@t",
               GIT_COMMITTER_NAME="t", GIT_COMMITTER_EMAIL="t@t")

    def git(*args):
        subprocess.run(["git", "-C", str(tmp_path)] + list(args), check=True,
                       capture_output=True, env=env)

    pkg = tmp_path / "pkg"
    pkg.mkdir()
    (pkg / "old.py").write_text(_VIOLATION_SRC)
    git("init", "-q")
    git("add", "-A")
    git("commit", "-q", "-m", "seed")
    args = [str(pkg), "--no-baseline", "--changed"]
    verdicts = []
    verdicts.append([r[0] for r in _both(args, capsys)])
    (pkg / "new.py").write_text(_VIOLATION_SRC.replace("age", "lag"))
    both = _both(args, capsys)
    verdicts.append([r[0] for r in both])
    assert "new.py" in both[1][1] and "old.py" not in both[1][1]
    git("add", "-A")
    git("commit", "-q", "-m", "more")
    verdicts.append([r[0] for r in _both(args, capsys)])
    verdicts.append([r[0] for r in _both([str(pkg), "--changed", "--fix-baseline"], capsys)])
    assert verdicts == [[0, 0], [1, 1], [0, 0], [2, 2]]
    norepo = tmp_path.parent / f"{tmp_path.name}_norepo"
    norepo.mkdir()
    (norepo / "m.py").write_text("x = 1\n")
    assert [r[0] for r in _both([str(norepo), "--changed"], capsys)] == [2, 2]


def _sarif_results(doc):
    return sorted((r["ruleId"], r["level"], r["baselineState"],
                   r["partialFingerprints"]["graftlint/v1"])
                  for r in doc["runs"][0]["results"])


@pytest.mark.parametrize("grandfathered", [False, True])
def test_cli_sarif_matches_the_reference(tmp_path, capsys, grandfathered):
    bl = str(tmp_path / "bl.json")
    if grandfathered:
        assert jlint.main([FIXTURES, "--baseline", bl, "--fix-baseline"]) == 0
    base = [FIXTURES] + (["--baseline", bl] if grandfathered else ["--no-baseline"])
    docs = []
    for main, extra, name in ((jlint.main, [], "j.sarif"),
                              (lint.main, ["--dialect", "jax"], "p.sarif")):
        assert main(base + ["--sarif", str(tmp_path / name)] + extra) == (
            0 if grandfathered else 1)
        docs.append(json.loads((tmp_path / name).read_text()))
    jdoc, doc = docs
    assert doc["version"] == jdoc["version"] == "2.1.0"
    assert doc["runs"][0]["tool"]["driver"]["name"] == "graftlint"
    got = _sarif_results(doc)
    assert got and got == _sarif_results(jdoc)
    level, state = ("note", "unchanged") if grandfathered else ("error", "new")
    assert all(r[1] == level and r[2] == state for r in got)
    rule_ids = {r["id"] for r in doc["runs"][0]["tool"]["driver"]["rules"]}
    assert {r[0] for r in got} <= rule_ids
    capsys.readouterr()


# -- the torch dialect ----------------------------------------------------------

# each rule's true positives: (fixture file, enclosing function)
FIRES = {
    "host-sync": [("host_sync_bad.py", f"Server.serve_{k}") for k in (
        "item", "tolist", "cpu", "to_cpu", "asarray", "float", "synchronize",
        "mask", "nonzero")] + [("host_sync_bad.py", "launch")],
    "retrace-hazard": [("retrace_bad.py", "per_batch_wrappers"),
                       ("retrace_bad.py", "built_and_called"),
                       ("retrace_bad.py", "raw_library"),
                       ("retrace_bad.py", "Scaled.forward")],
    "jit-purity": [("purity_bad.py", "Noisy.forward"), ("purity_bad.py", "Noisy.backward"),
                   ("purity_bad.py", "remat_body")],
    "numpy-on-tracer": [("tracer_np_bad.py", "body")],
    "lock-discipline": [("locks_bad.py", "register"), ("locks_bad.py", "Worker.step")],
    "monotonic-clock": [("clock_bad.py", "age")],
    "cost-analysis-off-hot-path": [("cost_analysis_bad.py", "serve_priced"),
                                   ("cost_analysis_bad.py", "serve_flops")],
    "tuner-off-hot-path": [("tuner_bad.py", "fit_and_tune")],
    "step-wiring": [("nn/step_wiring_bad.py", "hand_rolled_update")],
    "use-after-donate": [("donate_bad.py", "read_after_step"),
                         ("donate_bad.py", "alias_of_state"),
                         ("donate_bad.py", "through_a_helper")],
    "collective-consistency": [("collective_bad.py", "rank_zero_reduce"),
                               ("collective_bad.py", "context_rank_reduce"),
                               ("collective_bad.py", "own_group")],
    "durable-store-protocol": [("store_bad.py", "save_checkpoint"),
                               ("store_bad.py", "save_bundle"),
                               ("store_bad.py", "write_manifest")],
}

# each rule's clean shapes, and the suppressed lines (which must stay quiet)
CLEAN = {
    "host-sync": [("host_sync_bad.py", "Server.serve_clean"),
                  ("host_sync_bad.py", "Server.serve_suppressed"),
                  ("host_sync_bad.py", "not_hot")],
    "retrace-hazard": [("retrace_bad.py", "site_lookups"), ("retrace_bad.py", "cached_library"),
                       ("retrace_bad.py", "Scaled.backward"), ("ops/_build.py", "load")],
    "jit-purity": [("purity_bad.py", "Seeded.forward"), ("purity_bad.py", "suppressed_body")],
    "numpy-on-tracer": [("tracer_np_bad.py", "body_ok")],
    "lock-discipline": [("locks_bad.py", "register_locked"), ("locks_bad.py", "Worker.step_released")],
    "monotonic-clock": [("clock_bad.py", "elapsed"), ("clock_bad.py", "stamp")],
    "cost-analysis-off-hot-path": [("cost_analysis_bad.py", "report")],
    "tuner-off-hot-path": [("tuner_bad.py", "offline")],
    "step-wiring": [("nn/step_wiring_bad.py", "copy_back"),
                    ("nn/step_wiring_bad.py", "not_an_update"), ("nn/model.py", "update")],
    "use-after-donate": [("donate_bad.py", "cloned_first"), ("donate_bad.py", "rebound_after"),
                         ("donate_bad.py", "suppressed")],
    "collective-consistency": [("collective_bad.py", "uniform_reduce"),
                               ("parallel/mesh.py", "make_groups")],
    "durable-store-protocol": [("store_bad.py", "save_checkpoint_atomic"),
                               ("store_bad.py", "save_scratch")],
}


def _hits(findings, rule, filename, func):
    return [f for f in findings if f.rule == rule
            and f.path.endswith("graftlint_torch/" + filename) and f.func == func]


def test_every_rule_has_a_torch_fixture():
    assert set(FIRES) == set(CLEAN) == set(rules.ALL_RULES)


@pytest.mark.parametrize("rule", sorted(FIRES))
def test_each_torch_rule_fires_on_its_fixture(torch_findings, rule):
    for filename, func in FIRES[rule]:
        assert _hits(torch_findings, rule, filename, func), (rule, filename, func)


@pytest.mark.parametrize("rule", sorted(CLEAN))
def test_each_torch_rule_leaves_its_clean_shapes_alone(torch_findings, rule):
    for filename, func in CLEAN[rule]:
        assert not _hits(torch_findings, rule, filename, func), (rule, filename, func)


def test_torch_fixtures_have_no_finding_beyond_the_marked_ones(torch_findings):
    marked = {(f, fn) for hits in FIRES.values() for f, fn in hits}
    stray = [f.render() for f in torch_findings
             if (f.path.split("graftlint_torch/", 1)[1], f.func) not in marked]
    assert stray == []


# -- the port itself ----------------------------------------------------------------

def test_port_lints_clean_against_checked_in_baseline(capsys):
    assert lint.main([PORT]) == 0
    assert "clean" in capsys.readouterr().out


def test_baseline_holds_only_reviewed_rules():
    with open(lint.DEFAULT_BASELINE) as f:
        allowed = json.load(f)["allowed"]
    assert allowed and all(k.startswith("deeplearning4j_tpu_torch/") for k in allowed)
    assert {k.split("::")[1] for k in allowed} <= {"host-sync", "lock-discipline"}


def test_lint_imports_only_the_standard_library():
    code = ("import sys, deeplearning4j_tpu_torch.analysis.lint, "
            "deeplearning4j_tpu_torch.analysis.rules, deeplearning4j_tpu_torch.analysis.sarif; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'numpy', 'jax', 'deeplearning4j_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
