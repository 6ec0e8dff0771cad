"""Obs-driven auto-tuner for the framework's performance knobs (PyTorch port).

Counterpart of ``deeplearning4j_tpu/tune``: the same knob registry, DB
format and search, so either package reads the other's tuning DB. Three
pieces:

- :mod:`~deeplearning4j_tpu_torch.tune.knobs` — the typed knob registry;
- :mod:`~deeplearning4j_tpu_torch.tune.search` / :mod:`~.trial` — offline
  successive-halving search, each trial measured in a fresh subprocess;
- :mod:`~deeplearning4j_tpu_torch.tune.db` — the CRC'd, toolchain-fingerprinted
  tuning DB the online paths consult.

The only online hook is :func:`maybe_apply`: when ``DL4J_TPU_TUNE=auto``,
``fit()`` / ``ParallelInference`` / the serve registry call it at startup
(before anything compiles) to apply the persisted winner for the current
(model signature, backend, toolchain). It costs one env-var check when
tuning is off, never overrides a knob the user set explicitly, and never
measures anything itself — search stays offline
(``tune.search.tune_model``). ``MeshTrainer`` calls it too.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

from deeplearning4j_tpu_torch.tune.db import TuningDB, default_db_path
from deeplearning4j_tpu_torch.tune.knobs import KNOBS, Knob, all_knobs, get
from deeplearning4j_tpu_torch.tune.search import (TrialResult, enumerate_configs,
                                            successive_halving, tune_model)

__all__ = [
    "KNOBS", "Knob", "TrialResult", "TuningDB", "all_knobs",
    "default_db_path", "enumerate_configs", "get", "maybe_apply", "mode",
    "successive_halving", "tune_model",
]


def mode() -> str:
    """``DL4J_TPU_TUNE``: ``auto`` applies persisted winners at startup;
    anything else (or unset) leaves every knob alone."""
    raw = os.environ.get("DL4J_TPU_TUNE", "").strip().lower()
    return "auto" if raw == "auto" else "off"


def maybe_apply(model, scope: str = "fit") -> Optional[Dict[str, str]]:
    """Apply the tuning-DB winner for ``model`` on this backend/toolchain,
    if one exists. Returns the env delta written, or None.

    Rules: a knob env the USER already set is never overwritten (explicit
    beats tuned); only knobs whose registry scope matches ``scope`` apply;
    a second call is a no-op (the envs are then already set). Lookup
    re-validates the recorded toolchain fingerprint, so a stale entry is
    ignored rather than trusted."""
    if mode() != "auto":
        return None
    from deeplearning4j_tpu_torch import obs
    from deeplearning4j_tpu_torch.nn import aot

    try:
        sig = aot.model_signature(model)
    except Exception:
        return None
    entry = TuningDB().lookup(sig, toolchain=aot.toolchain_fingerprint(aot._backend(model)))
    if entry is None:
        return None
    applied: Dict[str, str] = {}
    for name, value in sorted((entry.get("knobs") or {}).items()):
        knob = get(name)
        if knob is None or not knob.applies_to(scope):
            continue
        if knob.env in os.environ:
            continue  # explicit user setting (or an earlier apply) wins
        os.environ[knob.env] = knob.format(value)
        applied[knob.env] = os.environ[knob.env]
    if applied:
        obs.event("tune_applied", signature=sig[:12], scope=scope,
                  **applied)
    return applied or None
