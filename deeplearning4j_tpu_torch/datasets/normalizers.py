"""Data normalizers: fit/transform/revert, serializable (PyTorch port of
``deeplearning4j_tpu/datasets/normalizers.py``; host numpy, a copy whose
``to_dict`` is the JAX package's, so ``normalizer.json`` in a checkpoint zip
reads in both packages).

Capability parity with ND4J's DataNormalization family
(NormalizerStandardize, NormalizerMinMaxScaler, ImagePreProcessingScaler,
MultiNormalizer — external nd4j-api, embedded in model zips by
util/ModelSerializer.java:65; SURVEY.md §5.4)."""

from __future__ import annotations

import json
from typing import Optional

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet


class Normalizer:
    TYPE = "base"

    def fit(self, data) -> "Normalizer":
        """``data``: a DataSet or an iterable of DataSets."""
        sets = [data] if isinstance(data, DataSet) else list(data)
        self._fit_features(np.concatenate([np.asarray(d.features, np.float64) for d in sets]))
        return self

    def _fit_features(self, x):
        raise NotImplementedError

    def transform(self, ds: DataSet) -> DataSet:
        return DataSet(self.transform_features(ds.features), ds.labels,
                       ds.features_mask, ds.labels_mask)

    def transform_features(self, x):
        raise NotImplementedError

    def revert_features(self, x):
        raise NotImplementedError

    def __call__(self, ds: DataSet) -> DataSet:
        return self.transform(ds)

    # -- serde -------------------------------------------------------------
    def to_dict(self) -> dict:
        raise NotImplementedError

    @staticmethod
    def from_dict(d: dict) -> "Normalizer":
        cls = {c.TYPE: c for c in (NormalizerStandardize, NormalizerMinMaxScaler,
                                   ImagePreProcessingScaler,
                                   VGG16ImagePreProcessor)}[d["@type"]]
        return cls._from_dict(d)

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @staticmethod
    def from_json(s: str) -> "Normalizer":
        return Normalizer.from_dict(json.loads(s))


class NormalizerStandardize(Normalizer):
    """Per-feature z-score over the feature axis (last axis for 2D, channel
    stats for 4D NHWC)."""

    TYPE = "standardize"

    def __init__(self):
        self.mean: Optional[np.ndarray] = None
        self.std: Optional[np.ndarray] = None

    def _axes(self, x):
        return tuple(range(x.ndim - 1))  # all but the trailing feature/channel axis

    def _fit_features(self, x):
        ax = self._axes(x)
        self.mean = x.mean(axis=ax)
        self.std = x.std(axis=ax)
        self.std[self.std < 1e-12] = 1.0

    def transform_features(self, x):
        return ((np.asarray(x) - self.mean) / self.std).astype(np.float32)

    def revert_features(self, x):
        return np.asarray(x) * self.std + self.mean

    def to_dict(self):
        return {"@type": self.TYPE, "mean": self.mean.tolist(), "std": self.std.tolist()}

    @classmethod
    def _from_dict(cls, d):
        n = cls()
        n.mean = np.asarray(d["mean"])
        n.std = np.asarray(d["std"])
        return n


class NormalizerMinMaxScaler(Normalizer):
    """Scale features into [min_range, max_range] (default [0,1])."""

    TYPE = "minmax"

    def __init__(self, min_range: float = 0.0, max_range: float = 1.0):
        self.min_range = min_range
        self.max_range = max_range
        self.data_min: Optional[np.ndarray] = None
        self.data_max: Optional[np.ndarray] = None

    def _fit_features(self, x):
        ax = tuple(range(x.ndim - 1))
        self.data_min = x.min(axis=ax)
        self.data_max = x.max(axis=ax)

    def transform_features(self, x):
        rng = self.data_max - self.data_min
        rng = np.where(rng < 1e-12, 1.0, rng)
        unit = (np.asarray(x) - self.data_min) / rng
        return (unit * (self.max_range - self.min_range) + self.min_range).astype(np.float32)

    def revert_features(self, x):
        rng = self.data_max - self.data_min
        unit = (np.asarray(x) - self.min_range) / (self.max_range - self.min_range)
        return unit * rng + self.data_min

    def to_dict(self):
        return {"@type": self.TYPE, "min_range": self.min_range, "max_range": self.max_range,
                "data_min": self.data_min.tolist(), "data_max": self.data_max.tolist()}

    @classmethod
    def _from_dict(cls, d):
        n = cls(d["min_range"], d["max_range"])
        n.data_min = np.asarray(d["data_min"])
        n.data_max = np.asarray(d["data_max"])
        return n


class ImagePreProcessingScaler(Normalizer):
    """Fixed-range pixel scaler (0..255 → [a,b]); no fitting required."""

    TYPE = "image"

    def __init__(self, min_range: float = 0.0, max_range: float = 1.0, max_pixel: float = 255.0):
        self.min_range = min_range
        self.max_range = max_range
        self.max_pixel = max_pixel

    def fit(self, data):
        return self

    def transform_features(self, x):
        unit = np.asarray(x, np.float32) / self.max_pixel
        return unit * (self.max_range - self.min_range) + self.min_range

    def revert_features(self, x):
        unit = (np.asarray(x) - self.min_range) / (self.max_range - self.min_range)
        return unit * self.max_pixel

    def to_dict(self):
        return {"@type": self.TYPE, "min_range": self.min_range,
                "max_range": self.max_range, "max_pixel": self.max_pixel}

    @classmethod
    def _from_dict(cls, d):
        return cls(d["min_range"], d["max_range"], d["max_pixel"])


class VGG16ImagePreProcessor(Normalizer):
    """ImageNet per-channel mean subtraction (nd4j
    VGG16ImagePreProcessor, used by the reference's
    trainedmodels/TrainedModels.java:86 getPreProcessor): x - mean_rgb,
    no scaling. Channels-LAST here ([..., h, w, 3] NHWC) — the framework's
    native image layout."""

    TYPE = "vgg16"
    MEAN_RGB = (123.68, 116.779, 103.939)

    def fit(self, data):
        return self  # fixed statistics, nothing to fit

    @staticmethod
    def _check_nhwc(x):
        x = np.asarray(x, np.float32)
        if x.shape[-1] != 3:
            raise ValueError(
                f"VGG16ImagePreProcessor expects NHWC RGB input, got "
                f"trailing dim {x.shape[-1]}")
        return x

    def transform_features(self, x):
        return self._check_nhwc(x) - np.asarray(self.MEAN_RGB, np.float32)

    def revert_features(self, x):
        return self._check_nhwc(x) + np.asarray(self.MEAN_RGB, np.float32)

    def to_dict(self):
        return {"@type": self.TYPE}

    @classmethod
    def _from_dict(cls, d):
        return cls()
