"""Evaluation (PyTorch port of ``deeplearning4j_tpu/eval``).

Accumulation happens on the host in numpy; the forward pass that produces
the predictions runs on the model's device. Ported so far: classification
(``Evaluation``, ``ConfusionMatrix``). Regression, ROC, binary and
calibration evaluation arrive with their slice.
"""

from deeplearning4j_tpu_torch.eval.evaluation import ConfusionMatrix, Evaluation

__all__ = ["ConfusionMatrix", "Evaluation"]
