"""Successive-halving search over the knob space (PyTorch port).

Candidates are the cross product of each searched knob's declared domain,
enumerated DETERMINISTICALLY (knobs sorted by name, domain values in
declaration order) so two runs of the same search measure the same trials
in the same order. Each round runs every surviving candidate for a short
measured trial in a FRESH subprocess (``tune.trial``), ranks by measured
steps/sec, keeps the top ``1/eta``, and doubles the per-trial step budget
— μ-cuDNN's measure-don't-assume loop applied to the framework's own
knobs. The default configuration is always in the candidate set, so the
returned winner is ≥ default by construction (ties break toward default).
"""

from __future__ import annotations

import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.tune import knobs as _knobs

__all__ = ["TrialResult", "enumerate_configs", "run_subprocess_trial",
           "successive_halving", "tune_model"]

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_trials_run = obs.counter("dl4j_tune_trials_total",
                          "tuner trials executed (fresh subprocesses)")


@dataclass
class TrialResult:
    config: Dict[str, Any]
    objective: float = 0.0           # measured steps/sec (higher is better)
    ok: bool = False
    seconds: float = 0.0
    flops_total: float = 0.0
    bytes_total: float = 0.0
    error: Optional[str] = None
    raw: Dict[str, Any] = field(default_factory=dict)


def enumerate_configs(
        names: Sequence[str],
        overrides: Optional[Dict[str, Sequence[Any]]] = None,
) -> List[Dict[str, Any]]:
    """Cross product of the named knobs' domains, deterministic order.
    ``overrides`` narrows a knob's searched values (still domain-checked).
    The all-defaults assignment is guaranteed to be element 0."""
    names = sorted(set(names))
    axes: List[Tuple[str, Tuple[Any, ...]]] = []
    for name in names:
        knob = _knobs.get(name)
        if knob is None:
            raise KeyError(f"unknown knob {name!r}")
        values = tuple((overrides or {}).get(name, knob.domain))
        values = tuple(knob.validate(v) for v in values)
        # default first so config 0 is the un-tuned baseline
        ordered = ((knob.default,) if knob.default in values else ()) + tuple(
            v for v in values if v != knob.default)
        axes.append((name, ordered))
    configs = [dict(zip([n for n, _ in axes], combo))
               for combo in itertools.product(*[vs for _, vs in axes])]
    return configs


def run_subprocess_trial(spec: Dict[str, Any], config: Dict[str, Any],
                         timeout_s: float = 600.0) -> TrialResult:
    """One candidate, one fresh interpreter. Knobs travel inside the spec
    (not the inherited env) so the child's assignment is explicit and the
    parent's env — including any user-set knob values — is never mutated.
    Never call from a fit or serve path."""
    child_spec = dict(spec)
    child_spec["knobs"] = dict(config)
    fd, path = tempfile.mkstemp(suffix=".json", prefix="dl4j_tune_trial_")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(child_spec, f)
        env = dict(os.environ)
        # trials measure the fit path itself and write no bundle
        env.setdefault("DL4J_TPU_AOT_BUNDLE", "0")
        env["PYTHONPATH"] = _REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
        proc = subprocess.run(
            [sys.executable, "-m", "deeplearning4j_tpu_torch.tune.trial", path],
            capture_output=True, text=True, timeout=timeout_s, env=env)
        _trials_run.inc()
        line = ""
        for candidate in reversed((proc.stdout or "").strip().splitlines()):
            candidate = candidate.strip()
            if candidate.startswith("{"):
                line = candidate
                break
        if not line:
            return TrialResult(config=dict(config), error=(
                f"no JSON from trial (rc={proc.returncode}): "
                f"{(proc.stderr or '')[-300:]}"))
        raw = json.loads(line)
        return TrialResult(
            config=dict(config),
            objective=float(raw.get("steps_per_sec", 0.0)),
            ok=bool(raw.get("ok")),
            seconds=float(raw.get("seconds", 0.0)),
            flops_total=float(raw.get("flops_total", 0.0)),
            bytes_total=float(raw.get("bytes_total", 0.0)),
            error=raw.get("error"),
            raw=raw,
        )
    except subprocess.TimeoutExpired:
        _trials_run.inc()
        return TrialResult(config=dict(config),
                           error=f"trial timeout after {timeout_s}s")
    except Exception as e:
        return TrialResult(config=dict(config), error=repr(e)[:300])
    finally:
        try:
            os.unlink(path)
        except OSError:
            pass


def successive_halving(spec: Dict[str, Any], configs: List[Dict[str, Any]],
                       eta: int = 2, base_steps: int = 8,
                       timeout_s: float = 600.0,
                       runner=run_subprocess_trial,
                       ) -> Tuple[TrialResult, List[TrialResult]]:
    """Rank ``configs`` by measured steps/sec over halving rounds. Returns
    (winner, full history). Sorting is stable and index-tie-broken, so
    equal objectives keep enumeration order — the default (index 0) wins
    ties against any challenger."""
    if not configs:
        raise ValueError("no configs to search")
    survivors = list(enumerate(configs))
    steps = max(int(base_steps), 1)
    history: List[TrialResult] = []
    rounds = 0
    while True:
        rounds += 1
        results: List[Tuple[int, TrialResult]] = []
        for idx, config in survivors:
            round_spec = dict(spec)
            round_spec["steps"] = steps
            r = runner(round_spec, config, timeout_s=timeout_s)
            history.append(r)
            results.append((idx, r))
            obs.event("tune_trial", round=rounds, index=idx,
                      ok=r.ok, steps=steps, steps_per_sec=r.objective,
                      knobs=json.dumps(config, sort_keys=True),
                      error=(r.error or "")[:120])
        if len(results) == 1:
            return results[0][1], history
        # higher steps/sec first; failed trials (objective 0, ok False)
        # sink; ties resolve to the earlier enumeration index (default-first)
        ranked = sorted(results, key=lambda ir: (-ir[1].objective, ir[0]))
        keep = max(1, math.ceil(len(ranked) / max(eta, 2)))
        survivors = [(idx, r.config) for idx, r in ranked[:keep]]
        steps *= max(eta, 2)
        if len(survivors) == 1:
            return ranked[0][1], history


def tune_model(model, features, labels,
               knob_names: Optional[Sequence[str]] = None,
               overrides: Optional[Dict[str, Sequence[Any]]] = None,
               db=None, base_steps: int = 8, warmup_steps: int = 2,
               eta: int = 2, timeout_s: float = 600.0, scope: str = "fit",
               runner=run_subprocess_trial) -> Dict[str, Any]:
    """Search, then persist the winner for (model signature, backend,
    toolchain) so ``DL4J_TPU_TUNE=auto`` startups can apply it. Returns the
    recorded DB entry (with the search history under ``"history"``, which
    is NOT persisted). Offline-only: call this from a tuning script, never
    from inside fit()/serve. The trials run on the model's device. Knobs
    the port has no counterpart for (``knobs.INERT``) are refused."""
    from deeplearning4j_tpu_torch.nn import aot
    from deeplearning4j_tpu_torch.tune import db as _db
    from deeplearning4j_tpu_torch.tune import trial as _trial

    if knob_names is None:
        # the default online search is intentionally small: the two axes
        # that reshape the step itself (micro-batching, chained dispatch)
        knob_names = ("grad_accum", "chain_steps")
    for name in knob_names:
        if name in _knobs.INERT:
            raise ValueError(f"knob {name!r} cannot be tuned in the PyTorch port: "
                             f"{_knobs.INERT[name]}")
    spec = _trial.build_spec(model, features, labels,
                             steps=base_steps, warmup_steps=warmup_steps)
    configs = enumerate_configs(knob_names, overrides)
    winner, history = successive_halving(
        spec, configs, eta=eta, base_steps=base_steps,
        timeout_s=timeout_s, runner=runner)
    database = db if db is not None else _db.TuningDB()
    entry = database.record(
        aot.model_signature(model), winner.config,
        toolchain=aot.toolchain_fingerprint(aot._backend(model)),
        objective={
            "steps_per_sec": winner.objective,
            "flops_total": winner.flops_total,
            "bytes_total": winner.bytes_total,
        },
        trials=len(history), scope=scope)
    entry = dict(entry)
    entry["history"] = [
        {"knobs": r.config, "steps_per_sec": r.objective, "ok": r.ok,
         "error": r.error} for r in history]
    return entry
