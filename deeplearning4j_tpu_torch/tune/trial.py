"""One measured trial, run in a FRESH subprocess (PyTorch port).

``python -m deeplearning4j_tpu_torch.tune.trial <spec.json>`` builds the
model described by the spec on the spec's device (``"device": null`` is the
GPU), applies a knob assignment (registry-validated, via the same
environment variables the framework reads when it builds a step), prices
the step once by a counting pass (``nn/aot.py`` ``warm_fit``), runs a
warmup round so every first-dispatch cost lands outside the timed window,
then times a fit round and prints exactly one JSON result line to stdout
(last line wins). On a card the clock starts and stops after
``torch.cuda.synchronize()``: without it steps/s would measure the launch
rate.

Fresh subprocesses are the point: a trial must not leave tuned env values
or warm sites behind, and a crashed trial must cost the search one
candidate, not the process.

Spec schema (JSON)::

    {
      "model_class": "MultiLayerNetwork" | "ComputationGraph",
      "conf_json": "<conf.to_json()>",
      "features_shape": [B, ...] | [[B, ...], ...],   # CG: list of inputs
      "labels_shape":   [B, ...] | [[B, ...], ...],
      "knobs": {"grad_accum": 4, ...},                # names, not envs
      "steps": 16, "warmup_steps": 2, "seed": 0, "device": null | "cpu"
    }

The objective reported is measured steps/sec plus the cost-ledger totals
(``obs.cost_report()`` flops / bytes accessed) of the same run.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, List, Tuple

__all__ = ["apply_knobs", "build_spec", "run_trial", "main"]


def apply_knobs(assignment: Dict[str, Any], env: Dict[str, str]) -> Dict[str, str]:
    """Translate a name→value assignment into env-var writes on ``env``
    (registry-validated). Returns the env delta actually written."""
    from deeplearning4j_tpu_torch.tune import knobs as _knobs

    delta: Dict[str, str] = {}
    for name in sorted(assignment):
        knob = _knobs.get(name)
        if knob is None:
            raise KeyError(f"unknown knob {name!r}")
        value = knob.validate(assignment[name])
        env[knob.env] = delta[knob.env] = knob.format(value)
    return delta


def build_spec(model, features, labels, steps: int = 16,
               warmup_steps: int = 2, seed: int = 0) -> Dict[str, Any]:
    """Spec for tuning ``model`` on batches shaped like (features, labels).
    Only shapes travel — the trial subprocess synthesizes data, so a spec
    is a few KB regardless of dataset size."""
    import numpy as np

    def shapes(x):
        if isinstance(x, (list, tuple)):
            return [list(np.shape(a)) for a in x]
        return list(np.shape(x))

    dev = getattr(model, "device", None)
    return {
        "model_class": type(model).__name__,
        "conf_json": model.conf.to_json(),
        "device": None if dev is None or str(dev).startswith("cuda") else str(dev),
        "features_shape": shapes(features),
        "labels_shape": shapes(labels),
        "knobs": {},
        "steps": int(steps),
        "warmup_steps": int(warmup_steps),
        "seed": int(seed),
    }


def _synth(shape, rng, one_hot: bool):
    import numpy as np

    if one_hot and len(shape) == 2:
        # classification targets: one-hot rows keep every loss well-posed
        idx = rng.randint(0, shape[1], size=shape[0])
        return np.eye(shape[1], dtype=np.float32)[idx]
    return rng.rand(*shape).astype(np.float32)


def _synth_batch(spec) -> Tuple[Any, Any]:
    import numpy as np

    rng = np.random.RandomState(spec.get("seed", 0))
    fs, ls = spec["features_shape"], spec["labels_shape"]

    def many(shapes, one_hot):
        if shapes and isinstance(shapes[0], list):
            return [_synth(tuple(s), rng, one_hot) for s in shapes]
        return _synth(tuple(shapes), rng, one_hot)

    return many(fs, one_hot=False), many(ls, one_hot=True)


def _build_model(spec):
    cls = spec["model_class"]
    device = spec.get("device")
    if cls == "MultiLayerNetwork":
        from deeplearning4j_tpu_torch.nn.model import (MultiLayerConfiguration,
                                                       MultiLayerNetwork)

        m = MultiLayerNetwork(MultiLayerConfiguration.from_json(spec["conf_json"]),
                              device=device)
    elif cls == "ComputationGraph":
        from deeplearning4j_tpu_torch.nn.graph import (ComputationGraph,
                                                       ComputationGraphConfiguration)

        m = ComputationGraph(ComputationGraphConfiguration.from_json(spec["conf_json"]),
                             device=device)
    else:
        raise ValueError(f"unknown model_class {cls!r}")
    m.init()
    return m


def _cost_totals() -> Dict[str, float]:
    """Sum the cost ledger across every (site, key) this process priced —
    in a fresh trial subprocess that is exactly the trial's own step."""
    from deeplearning4j_tpu_torch import obs

    flops = 0.0
    bytes_ = 0.0
    try:
        report = obs.cost_report()
        for entries in report.get("sites", {}).values():
            for entry in entries.values():
                flops += float(entry.get("flops", 0) or 0)
                bytes_ += float(entry.get("bytes_accessed", 0) or 0)
    except Exception:
        pass
    return {"flops_total": flops, "bytes_total": bytes_}


def run_trial(spec: Dict[str, Any]) -> Dict[str, Any]:
    """Measure one knob assignment. Never call this from a fit or serve
    path: it prices, synchronizes and times."""
    import torch

    from deeplearning4j_tpu_torch.nn import aot

    applied = apply_knobs(spec.get("knobs") or {}, os.environ)

    model = _build_model(spec)
    x, y = _synth_batch(spec)
    steps = max(int(spec.get("steps", 16)), 1)
    warmup = max(int(spec.get("warmup_steps", 2)), 1)
    batch = (x, y)
    cuda = torch.device(model.device).type == "cuda"
    sync = (lambda: torch.cuda.synchronize(model.device)) if cuda else (lambda: None)
    aot.warm_fit(model, batch)   # the step's counted costs (on a snapshot)
    # warmup mirrors the measured round exactly (same batch list length, so
    # the same chain grouping): the timed round meets no first dispatch
    model.fit([batch] * warmup, epochs=1)
    sync()
    t0 = time.perf_counter()
    model.fit([batch] * steps, epochs=1)
    sync()
    dt = time.perf_counter() - t0
    result = {
        "ok": True,
        "steps": steps,
        "seconds": dt,
        "steps_per_sec": steps / dt if dt > 0 else 0.0,
        "knobs": spec.get("knobs") or {},
        "env": applied,
        "device": str(model.device),
        "error": None,
    }
    result.update(_cost_totals())
    return result


def main(argv: List[str]) -> int:
    if len(argv) != 1:
        print(json.dumps({"ok": False,
                          "error": "usage: trial <spec.json>"}))
        return 2
    # the cost objective needs the ledger on, whatever the parent had
    os.environ.setdefault("DL4J_TPU_OBS", "1")
    try:
        with open(argv[0], "r", encoding="utf-8") as f:
            spec = json.load(f)
        result = run_trial(spec)
    except Exception as e:  # a failed candidate is a ranked-last candidate
        result = {"ok": False, "steps_per_sec": 0.0, "error": repr(e)[:500]}
    print(json.dumps(result, sort_keys=True))
    return 0 if result.get("ok") else 1


if __name__ == "__main__":  # pragma: no cover - subprocess entry
    sys.exit(main(sys.argv[1:]))
