"""Evaluation (PyTorch port of ``deeplearning4j_tpu/eval``, whose modules
are numpy-only and are copied here).

Accumulation happens on the host in numpy; the forward pass that produces
the predictions runs on the model's device. Classification
(``Evaluation``, ``ConfusionMatrix``), regression, ROC (binary, per column,
one-vs-all), multi-label binary and calibration evaluation, and their JSON
serde (``to_json`` / ``from_json``; importing ``serde`` attaches both to
every class).
"""

from deeplearning4j_tpu_torch.eval.evaluation import ConfusionMatrix, Evaluation
from deeplearning4j_tpu_torch.eval.regression import RegressionEvaluation
from deeplearning4j_tpu_torch.eval.roc import ROC, ROCBinary, ROCMultiClass
from deeplearning4j_tpu_torch.eval.binary import EvaluationBinary
from deeplearning4j_tpu_torch.eval.calibration import EvaluationCalibration
from deeplearning4j_tpu_torch.eval.serde import from_json, to_json  # import runs attach()

__all__ = [
    "Evaluation",
    "ConfusionMatrix",
    "RegressionEvaluation",
    "ROC",
    "ROCBinary",
    "ROCMultiClass",
    "EvaluationBinary",
    "EvaluationCalibration",
    "to_json",
    "from_json",
]
