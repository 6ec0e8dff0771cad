"""DataSet / MultiDataSet containers.

Capability parity with ND4J's DataSet/MultiDataSet (consumed throughout the
reference, e.g. nn/multilayer/MultiLayerNetwork.java fit paths; the classes
themselves live in the external nd4j-api — SURVEY.md §2.4). Host-side they
are plain numpy; ``fit`` copies the arrays to the model's device. A copy of
the numpy-only ``deeplearning4j_tpu/datasets/dataset.py``.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np


class DataSet:
    """(features, labels, features_mask, labels_mask) bundle."""

    def __init__(self, features, labels=None, features_mask=None, labels_mask=None):
        self.features = np.asarray(features)
        self.labels = np.asarray(labels) if labels is not None else None
        self.features_mask = np.asarray(features_mask) if features_mask is not None else None
        self.labels_mask = np.asarray(labels_mask) if labels_mask is not None else None

    # -- protocol used by model.fit (nn/model.py::_as_batch) ---------------
    def as_tuple(self):
        return (self.features, self.labels, self.features_mask, self.labels_mask)

    def __iter__(self):
        return iter(self.as_tuple())

    def __len__(self):
        return len(self.features)

    def __getitem__(self, i):
        return self.as_tuple()[i]

    def num_examples(self) -> int:
        return len(self.features)

    # -- manipulation ------------------------------------------------------
    def shuffle(self, seed: Optional[int] = None) -> "DataSet":
        idx = np.random.RandomState(seed).permutation(len(self.features))
        pick = lambda a: a[idx] if a is not None else None
        return DataSet(self.features[idx], pick(self.labels),
                       pick(self.features_mask), pick(self.labels_mask))

    def split_test_and_train(self, n_train: int) -> Tuple["DataSet", "DataSet"]:
        take = lambda a, s: a[s] if a is not None else None
        tr = DataSet(self.features[:n_train], take(self.labels, slice(None, n_train)),
                     take(self.features_mask, slice(None, n_train)),
                     take(self.labels_mask, slice(None, n_train)))
        te = DataSet(self.features[n_train:], take(self.labels, slice(n_train, None)),
                     take(self.features_mask, slice(n_train, None)),
                     take(self.labels_mask, slice(n_train, None)))
        return tr, te

    def batch_by(self, batch_size: int) -> List["DataSet"]:
        out = []
        for i in range(0, len(self.features), batch_size):
            s = slice(i, i + batch_size)
            take = lambda a: a[s] if a is not None else None
            out.append(DataSet(self.features[s], take(self.labels),
                               take(self.features_mask), take(self.labels_mask)))
        return out

    def sample(self, n: int, seed: Optional[int] = None) -> "DataSet":
        idx = np.random.RandomState(seed).choice(len(self.features), n, replace=False)
        take = lambda a: a[idx] if a is not None else None
        return DataSet(self.features[idx], take(self.labels),
                       take(self.features_mask), take(self.labels_mask))

    @staticmethod
    def merge(datasets: Sequence["DataSet"]) -> "DataSet":
        cat = lambda parts: (np.concatenate(parts) if parts[0] is not None else None)
        return DataSet(
            cat([d.features for d in datasets]),
            cat([d.labels for d in datasets]),
            cat([d.features_mask for d in datasets]),
            cat([d.labels_mask for d in datasets]),
        )

    # -- persistence (ModelSerializer-style single-file container) ---------
    def save(self, path: str):
        arrs = {"features": self.features}
        if self.labels is not None:
            arrs["labels"] = self.labels
        if self.features_mask is not None:
            arrs["features_mask"] = self.features_mask
        if self.labels_mask is not None:
            arrs["labels_mask"] = self.labels_mask
        np.savez_compressed(path, **arrs)

    @staticmethod
    def load(path: str) -> "DataSet":
        with np.load(path) as z:
            return DataSet(z["features"], z.get("labels"),
                           z.get("features_mask"), z.get("labels_mask"))


class MultiDataSet:
    """Multi-input/multi-output bundle (ComputationGraph fit surface)."""

    def __init__(self, features: Sequence, labels: Sequence = (),
                 features_masks: Optional[Sequence] = None,
                 labels_masks: Optional[Sequence] = None):
        norm = lambda t: tuple(np.asarray(a) if a is not None else None for a in t) if t else None
        self.features = norm(tuple(features))
        self.labels = norm(tuple(labels))
        self.features_masks = norm(tuple(features_masks)) if features_masks else None
        self.labels_masks = norm(tuple(labels_masks)) if labels_masks else None

    def as_tuple(self):
        return (self.features, self.labels, self.features_masks, self.labels_masks)

    def __iter__(self):
        return iter(self.as_tuple())

    def __getitem__(self, i):
        return self.as_tuple()[i]

    def num_examples(self) -> int:
        return len(self.features[0])

    @staticmethod
    def merge(sets: Sequence["MultiDataSet"]) -> "MultiDataSet":
        def cat_tuple(tuples):
            if tuples[0] is None:
                return None
            n = len(tuples[0])
            return tuple(
                np.concatenate([t[i] for t in tuples]) if tuples[0][i] is not None else None
                for i in range(n)
            )

        return MultiDataSet(
            cat_tuple([s.features for s in sets]) or (),
            cat_tuple([s.labels for s in sets]) or (),
            cat_tuple([s.features_masks for s in sets]),
            cat_tuple([s.labels_masks for s in sets]),
        )
