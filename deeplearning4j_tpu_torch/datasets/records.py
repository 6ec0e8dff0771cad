"""Record readers: CSV / sequence-CSV / images → DataSets (PyTorch port of
``deeplearning4j_tpu/datasets/records.py``; host numpy, a copy).

Capability parity with DataVec (external dependency of the reference —
SURVEY.md §2.4 'DataVec' row: record readers feeding
RecordReaderDataSetIterator). Readers parse on the host into numpy;
`RecordReaderDataSetIterator` assembles fixed-shape batches for ``fit``.
"""

from __future__ import annotations

import csv
import os
from typing import Iterable, Iterator, List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import DataSetIterator


class CSVRecordReader:
    """One row = one record of floats (DataVec CSVRecordReader).

    Plain numeric CSVs parse through the native single-pass C++ loader
    (deeplearning4j_tpu_torch/native) when a toolchain is available; quoted or
    otherwise non-trivial files fall back to the Python csv module."""

    def __init__(self, skip_lines: int = 0, delimiter: str = ","):
        self.skip_lines = skip_lines
        self.delimiter = delimiter

    def read(self, path: str) -> np.ndarray:
        from deeplearning4j_tpu_torch import native

        if native.available():
            with open(path, "rb") as f:
                data = f.read()
            try:
                m = native.parse_csv(data, skip_lines=self.skip_lines,
                                     delimiter=self.delimiter)
                if m is not None:
                    return m.astype(np.float32)
            except ValueError:
                pass  # quotes/exotic formatting: python csv handles it
        with open(path, newline="") as f:
            rows = list(csv.reader(f, delimiter=self.delimiter))[self.skip_lines:]
        return np.asarray([[float(v) for v in r] for r in rows if r], np.float32)


class CSVSequenceRecordReader:
    """One FILE = one sequence (DataVec CSVSequenceRecordReader as used by
    dl4j-spark's csvsequence test fixtures)."""

    def __init__(self, skip_lines: int = 0, delimiter: str = ","):
        self.inner = CSVRecordReader(skip_lines, delimiter)

    def read_sequences(self, paths: Sequence[str]) -> List[np.ndarray]:
        return [self.inner.read(p) for p in paths]


class ImageRecordReader:
    """Folder-per-label image reader (DataVec ImageRecordReader): label =
    parent directory name; resizes to (height, width)."""

    def __init__(self, height: int, width: int, channels: int = 3):
        self.height, self.width, self.channels = height, width, channels
        self.labels: List[str] = []

    def read_dir(self, root: str):
        from PIL import Image

        self.labels = sorted(
            d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
        )
        xs, ys = [], []
        for li, label in enumerate(self.labels):
            d = os.path.join(root, label)
            for fn in sorted(os.listdir(d)):
                if not fn.lower().endswith((".png", ".jpg", ".jpeg", ".bmp")):
                    continue
                img = Image.open(os.path.join(d, fn))
                img = img.convert("RGB" if self.channels == 3 else "L")
                img = img.resize((self.width, self.height))
                a = np.asarray(img, np.float32) / 255.0
                if self.channels == 1:
                    a = a[..., None]
                xs.append(a)
                ys.append(li)
        x = np.stack(xs)
        y = np.eye(len(self.labels), dtype=np.float32)[np.asarray(ys)]
        return x, y


class RecordReaderDataSetIterator(DataSetIterator):
    """CSV rows → (features, one-hot label) batches (DataVec
    RecordReaderDataSetIterator: label_index column, num_classes)."""

    def __init__(self, path: str, batch_size: int, label_index: int,
                 num_classes: int, reader: Optional[CSVRecordReader] = None,
                 regression: bool = False):
        super().__init__(batch_size)
        self.rows = (reader or CSVRecordReader()).read(path)
        self.label_index = label_index
        self.num_classes = num_classes
        self.regression = regression

    def _produce(self) -> Iterator[DataSet]:
        x = np.delete(self.rows, self.label_index, axis=1)
        raw = self.rows[:, self.label_index]
        if self.regression:
            y = raw[:, None].astype(np.float32)
        else:
            y = np.eye(self.num_classes, dtype=np.float32)[raw.astype(np.int64)]
        for i in range(0, len(x), self.batch_size):
            s = slice(i, i + self.batch_size)
            yield DataSet(x[s], y[s])


class SequenceRecordReaderDataSetIterator(DataSetIterator):
    """Per-file sequences + per-file or per-step labels, padded + masked to
    the longest sequence in each batch (DataVec SequenceRecordReaderDataSetIterator
    with ALIGN_END-style masking)."""

    def __init__(self, feature_paths: Sequence[str], label_paths: Sequence[str],
                 batch_size: int, num_classes: int,
                 reader: Optional[CSVSequenceRecordReader] = None):
        super().__init__(batch_size)
        rdr = reader or CSVSequenceRecordReader()
        self.features = rdr.read_sequences(list(feature_paths))
        self.labels = rdr.read_sequences(list(label_paths))
        self.num_classes = num_classes

    def _produce(self) -> Iterator[DataSet]:
        for i in range(0, len(self.features), self.batch_size):
            feats = self.features[i:i + self.batch_size]
            labs = self.labels[i:i + self.batch_size]
            T = max(len(f) for f in feats)
            B, F = len(feats), feats[0].shape[1]
            x = np.zeros((B, T, F), np.float32)
            m = np.zeros((B, T), np.float32)
            y = np.zeros((B, T, self.num_classes), np.float32)
            for b, (f, l) in enumerate(zip(feats, labs)):
                x[b, : len(f)] = f
                m[b, : len(f)] = 1.0
                steps = np.asarray(l).astype(np.int64).reshape(len(l), -1)[:, -1]
                y[b, np.arange(len(l)), steps] = 1.0
            yield DataSet(x, y, m, m.copy())
