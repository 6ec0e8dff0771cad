"""ModelGuesser: "load whatever file this is" (PyTorch port of
``utils/guesser.py``).

Order of attempts:
  1. native zip (utils/serialization.restore_network);
  2. config JSON (MultiLayerConfiguration or ComputationGraphConfiguration
     — returns the CONFIG, uninitialized, like
     ModelGuesser.loadConfigGuess).

The JAX package also tries the reference DL4J zip dialect and Keras HDF5;
those importers are not ported yet.
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
            from deeplearning4j_tpu_torch.utils.serialization import restore_network

            return restore_network(path, device=device)
        errors.append("zip without a native checkpoint's entries (the DL4J zip "
                      "importer is not ported yet)")
    else:
        errors.append("not a zip")

    try:
        with open(path, "r", encoding="utf-8") as f:
            d = json.load(f)
    except (OSError, UnicodeDecodeError, json.JSONDecodeError) as e:
        errors.append(f"config json: {type(e).__name__}: {e}")
    else:
        fmt = str(d.get("format", "")) if isinstance(d, dict) else ""
        if fmt.endswith("MultiLayerConfiguration"):
            from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration

            return MultiLayerConfiguration.from_dict(d)
        if fmt.endswith("ComputationGraphConfiguration"):
            from deeplearning4j_tpu_torch.nn.graph import ComputationGraphConfiguration

            return ComputationGraphConfiguration.from_dict(d)
        errors.append(f"json: format tag {fmt!r} is not a ported configuration")

    raise ValueError(f"load_any({path!r}): no loader succeeded — " + "; ".join(errors))
