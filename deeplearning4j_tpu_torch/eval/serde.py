"""JSON serde for the evaluation family (a copy of the numpy-only
``deeplearning4j_tpu/eval/serde.py``).

Capability parity with the reference's eval/serde/ package (Jackson-based
``Evaluation.toJson()``/``fromJson()`` on every IEvaluation — used to ship
merged evaluations between Spark workers and persist them with models).

One recursive encoder covers the whole family: numpy arrays are tagged with
their dtype so a round-trip restores the exact accumulator types (int64
count matrices must stay int64 for ``+=`` merges), and nested evaluation
objects (ConfusionMatrix inside Evaluation, per-class ROC lists inside
ROCMultiClass) nest naturally. ``attach()`` registers ``to_json`` /
``from_json`` onto each class so the reference's per-class surface exists.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Type

import numpy as np

from deeplearning4j_tpu_torch.eval.binary import EvaluationBinary
from deeplearning4j_tpu_torch.eval.calibration import EvaluationCalibration
from deeplearning4j_tpu_torch.eval.evaluation import ConfusionMatrix, Evaluation
from deeplearning4j_tpu_torch.eval.regression import RegressionEvaluation
from deeplearning4j_tpu_torch.eval.roc import ROC, ROCBinary, ROCMultiClass

_CLASSES: Dict[str, Type] = {
    c.__name__: c
    for c in (Evaluation, ConfusionMatrix, RegressionEvaluation, ROC,
              ROCBinary, ROCMultiClass, EvaluationBinary,
              EvaluationCalibration)
}


def _encode(v: Any) -> Any:
    if isinstance(v, np.ndarray):
        return {"__nd__": v.tolist(), "dtype": str(v.dtype)}
    if isinstance(v, np.generic):
        return v.item()
    if type(v).__name__ in _CLASSES:
        return {"__eval__": type(v).__name__,
                "state": {k: _encode(x) for k, x in v.__dict__.items()}}
    if isinstance(v, (list, tuple)):
        return [_encode(x) for x in v]
    if isinstance(v, dict):
        return {k: _encode(x) for k, x in v.items()}
    return v


def _decode(o: Any) -> Any:
    if isinstance(o, dict):
        if "__nd__" in o:
            return np.asarray(o["__nd__"], dtype=o["dtype"])
        if "__eval__" in o:
            cls = _CLASSES[o["__eval__"]]
            inst = cls.__new__(cls)
            inst.__dict__.update(
                {k: _decode(x) for k, x in o["state"].items()})
            return inst
        return {k: _decode(x) for k, x in o.items()}
    if isinstance(o, list):
        return [_decode(x) for x in o]
    return o


def to_json(evaluation: Any) -> str:
    """Serialize any evaluation-family object to a JSON string."""
    if type(evaluation).__name__ not in _CLASSES:
        raise TypeError(f"not an evaluation class: {type(evaluation).__name__}")
    return json.dumps(_encode(evaluation))


def from_json(s: str) -> Any:
    """Restore an evaluation-family object serialized by :func:`to_json`."""
    obj = _decode(json.loads(s))
    if type(obj).__name__ not in _CLASSES:
        raise ValueError("JSON does not contain a serialized evaluation")
    return obj


def _self_to_json(self) -> str:
    return to_json(self)


@classmethod
def _cls_from_json(cls, s: str):
    obj = from_json(s)
    if not isinstance(obj, cls):
        raise ValueError(
            f"JSON holds a {type(obj).__name__}, not a {cls.__name__}")
    return obj


def attach() -> None:
    """Give every evaluation class the reference's toJson/fromJson surface."""
    for cls in _CLASSES.values():
        cls.to_json = _self_to_json
        cls.from_json = _cls_from_json


attach()
