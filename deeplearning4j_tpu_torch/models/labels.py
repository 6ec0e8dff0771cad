"""Class-label utilities for zoo models (PyTorch port of
``deeplearning4j_tpu/models/labels.py``; a copy).

Capability parity with the reference's zoo/util/ package: Labels.java:19-27
(getLabel + decodePredictions), BaseLabels.java (text-resource loading),
imagenet/ImageNetLabels.java, darknet/DarknetLabels.java,
darknet/VOCLabels.java.

The reference bundles label lists as classpath resources; this build is
air-gapped, so (matching `models/pretrained.py`) ImageNet/Darknet label
files resolve from ``$DL4J_TPU_HOME/labels/`` or an explicit path. The
20-class VOC list is universal and tiny, so it ships inline.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

ClassPrediction = Tuple[int, str, float]  # (index, label, probability)


def labels_cache_dir() -> str:
    root = os.environ.get("DL4J_TPU_HOME") or os.path.join(
        os.path.expanduser("~"), ".deeplearning4j_tpu")
    return os.path.join(root, "labels")


class BaseLabels:
    """getLabel + decodePredictions over an ordered label list."""

    def __init__(self, labels: Sequence[str]):
        self.labels = list(labels)

    def get_label(self, n: int) -> str:
        return self.labels[n]

    def __len__(self) -> int:
        return len(self.labels)

    def decode_predictions(self, predictions, top: int = 5
                           ) -> List[List[ClassPrediction]]:
        """[batch, classes] probabilities -> per-example top-n
        (index, label, probability), best first (Labels.decodePredictions)."""
        p = np.asarray(predictions)
        if p.ndim == 1:
            p = p[None, :]
        if p.shape[-1] != len(self.labels):
            raise ValueError(
                f"predictions have {p.shape[-1]} classes but {len(self.labels)} "
                "labels are loaded")
        top = min(top, p.shape[-1])
        out: List[List[ClassPrediction]] = []
        for row in p:
            idx = np.argsort(-row)[:top]
            out.append([(int(i), self.labels[int(i)], float(row[int(i)]))
                        for i in idx])
        return out

    @staticmethod
    def _resolve(filename: str, path: Optional[str]) -> str:
        p = path or os.path.join(labels_cache_dir(), filename)
        if not os.path.exists(p):
            raise FileNotFoundError(
                f"Label file not found: {p}. This build is air-gapped — place "
                f"the standard {filename} there (or pass an explicit path).")
        return p

    @classmethod
    def from_text_file(cls, path: str) -> "BaseLabels":
        """One label per line (BaseLabels.getLabels text-resource loader)."""
        with open(path, encoding="utf-8") as f:
            return cls([ln.rstrip("\n") for ln in f if ln.strip() != ""])


class ImageNetLabels(BaseLabels):
    """1000 ImageNet classes (imagenet/ImageNetLabels.java). Loads the
    standard ``imagenet_class_index.json`` ({"0": [wnid, name], ...}) from
    the cache dir or an explicit path."""

    def __init__(self, path: Optional[str] = None):
        p = self._resolve("imagenet_class_index.json", path)
        with open(p, encoding="utf-8") as f:
            idx = json.load(f)
        super().__init__([idx[str(i)][1] for i in range(len(idx))])


class DarknetLabels(BaseLabels):
    """Darknet's ImageNet label list (darknet/DarknetLabels.java):
    ``imagenet.shortnames.list`` (or ``imagenet.labels.list`` with
    short_names=False) from the cache dir."""

    def __init__(self, path: Optional[str] = None, short_names: bool = True):
        name = ("imagenet.shortnames.list" if short_names
                else "imagenet.labels.list")
        p = self._resolve(name, path)
        with open(p, encoding="utf-8") as f:
            super().__init__([ln.rstrip("\n") for ln in f if ln.strip() != ""])


_VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


class VOCLabels(BaseLabels):
    """The 20 PASCAL VOC classes (darknet/VOCLabels.java) — inline, the
    list is a universal constant."""

    def __init__(self):
        super().__init__(_VOC_CLASSES)
