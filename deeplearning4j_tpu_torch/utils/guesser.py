"""ModelGuesser: "load whatever file this is" (PyTorch port of
``utils/guesser.py``).

Reference parity: deeplearning4j-core util/ModelGuesser.java (loadModelGuess
tries MultiLayerNetwork restore, ComputationGraph restore, Keras import, then
the bare config JSONs), extended as the JAX package extends it with the DL4J
zip dialect, since this framework's native zip and the reference's zip share
neither layout nor binary format.

Order of attempts (the JAX package's):
  1. native zip (utils/serialization.restore_network — MLN and CG);
  2. reference DL4J zip (modelimport/dl4j.import_dl4j_zip);
  3. Keras HDF5 (modelimport/keras.KerasModelImport);
  4. config JSON (MultiLayerConfiguration or ComputationGraphConfiguration
     — returns the CONFIG, uninitialized, like
     ModelGuesser.loadConfigGuess).

A model goes to ``device`` (the GPU unless named; it raises without one).
"""

from __future__ import annotations

import json
import zipfile

__all__ = ["load_any"]


def load_any(path: str, device=None):
    """Load a model (onto ``device``, the GPU unless named) or a bare
    configuration from a supported file. Raises ValueError listing every
    attempt if nothing matches."""
    errors = []

    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as zf:
            names = set(zf.namelist())
        if "meta.json" in names or any(n.endswith(".npz") for n in names):
            try:
                from deeplearning4j_tpu_torch.utils.serialization import restore_network

                return restore_network(path, device=device)
            except Exception as e:  # fall through to the DL4J dialect
                errors.append(f"native zip: {type(e).__name__}: {e}")
        if "configuration.json" in names:
            try:
                from deeplearning4j_tpu_torch.modelimport.dl4j import import_dl4j_zip

                return import_dl4j_zip(path, device=device)
            except Exception as e:
                errors.append(f"DL4J zip: {type(e).__name__}: {e}")
    else:
        errors.append("not a zip")

    try:
        from deeplearning4j_tpu_torch.modelimport.keras import KerasModelImport

        return KerasModelImport.import_keras_model(path, device=device)
    except Exception as e:
        errors.append(f"keras h5: {type(e).__name__}: {e}")

    try:
        with open(path, "r", encoding="utf-8") as f:
            d = json.load(f)
        fmt = str(d.get("format", ""))
        if fmt.endswith("ComputationGraphConfiguration"):
            from deeplearning4j_tpu_torch.nn.graph import ComputationGraphConfiguration

            return ComputationGraphConfiguration.from_dict(d)
        if fmt.endswith("MultiLayerConfiguration"):
            from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration

            return MultiLayerConfiguration.from_dict(d)
        errors.append(f"json: unknown format tag {fmt!r}")
    except Exception as e:
        errors.append(f"config json: {type(e).__name__}: {e}")

    raise ValueError(f"load_any({path!r}): no loader succeeded — " + "; ".join(errors))
