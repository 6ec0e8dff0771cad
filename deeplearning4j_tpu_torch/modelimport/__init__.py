"""Model import (PyTorch port of ``deeplearning4j_tpu/modelimport``):
Keras HDF5 and the reference's DL4J zip, both onto the port's models.

Reference: deeplearning4j-modelimport/src/main/java/org/deeplearning4j/nn/
modelimport/keras/KerasModelImport.java:50-121 (importKerasSequentialModel*
-> MultiLayerNetwork, importKerasModel* -> ComputationGraph), Hdf5Archive.java:46,
per-layer converters under layers/**; util/ModelSerializer.java for the
DL4J zip. Every entry point puts the model on ``device`` (the GPU unless
named; it raises without one).
"""

from deeplearning4j_tpu_torch.modelimport.keras import (
    InvalidKerasConfigurationError,
    KerasModelImport,
    UnsupportedKerasConfigurationError,
    model_from_config,
)
from deeplearning4j_tpu_torch.modelimport.dl4j import export_dl4j_zip, import_dl4j_zip

__all__ = [
    "KerasModelImport",
    "InvalidKerasConfigurationError",
    "UnsupportedKerasConfigurationError",
    "import_dl4j_zip",
    "export_dl4j_zip",
    "import_model",
    "model_from_config",
]


def import_model(path: str, device=None):
    """Format-detecting loader: Keras HDF5 (``.h5``/``.hdf5``/``.keras``)
    via :class:`KerasModelImport` (Sequential vs functional auto-detected)
    or DL4J zip via :func:`import_dl4j_zip`, onto ``device``. The serving
    tier's model registry loads everything through here so one path string
    is all a deployment manifest needs."""
    lower = str(path).lower()
    if lower.endswith((".h5", ".hdf5", ".keras")):
        return KerasModelImport.import_keras_model(path, device=device)
    if lower.endswith(".zip"):
        return import_dl4j_zip(path, device=device)
    raise ValueError(
        f"unrecognized model format: {path!r} (expected .h5/.hdf5/.keras "
        "for Keras or .zip for DL4J)")
