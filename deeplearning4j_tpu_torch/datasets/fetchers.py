"""Built-in dataset fetchers + iterators (PyTorch port of
``deeplearning4j_tpu/datasets/fetchers.py``; host numpy, a copy: the same
archives, the same seeded surrogates, bit for bit).

Capability parity with deeplearning4j-core's datasets/fetchers + iterator/impl
(MnistDataFetcher, EmnistDataFetcher, UciSequenceDataFetcher;
MnistDataSetIterator, CifarDataSetIterator, EmnistDataSetIterator,
IrisDataSetIterator, TinyImageNetDataSetIterator, UciSequenceDataSetIterator
— SURVEY.md §2.2). Fetchers look for the standard archives in a local cache
(``$DL4J_TPU_DATA`` or ``~/.deeplearning4j_tpu``); in air-gapped
environments (no egress) they fall back to a DETERMINISTIC synthetic
surrogate with the same shapes/classes, clearly flagged via ``.synthetic``.
UCI "synthetic control" is generated exactly — the original dataset IS a
generator's output, reproduced here from its published equations.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import DataSetIterator, ListDataSetIterator


def cache_dir() -> str:
    d = os.environ.get("DL4J_TPU_DATA", os.path.expanduser("~/.deeplearning4j_tpu"))
    os.makedirs(d, exist_ok=True)
    return d


def _read_idx_images(path: str) -> np.ndarray:
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        data = f.read()
    from deeplearning4j_tpu_torch import native

    if native.available():
        try:
            imgs = native.parse_idx_images(data)
            if imgs is not None:
                return imgs
        except ValueError:
            pass  # fall through to the Python path's clearer assert
    magic, n, h, w = struct.unpack(">IIII", data[:16])
    assert magic == 2051, f"bad idx image magic {magic}"
    return np.frombuffer(data[16:], np.uint8).reshape(n, h, w)


def _read_idx_labels(path: str) -> np.ndarray:
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        magic, n = struct.unpack(">II", f.read(8))
        assert magic == 2049, f"bad idx label magic {magic}"
        return np.frombuffer(f.read(), np.uint8)


def _find(*names: str) -> Optional[str]:
    for root in (cache_dir(), os.path.join(cache_dir(), "mnist"), os.path.join(cache_dir(), "emnist")):
        for n in names:
            p = os.path.join(root, n)
            if os.path.exists(p):
                return p
    return None


def _synthetic_images(n: int, n_classes: int, h: int, w: int, channels: int,
                      seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic class-conditional image surrogate: a fixed per-class
    template plus pixel noise — separable (so training curves move) and
    reproducible across runs. Templates are seeded by (dataset shape, class
    count) ONLY, so train and test splits share the same class structure."""
    template_rs = np.random.RandomState(1_000_003 + n_classes * 17 + h * 7 + channels)
    shape = (h, w) if channels == 1 else (h, w, channels)
    templates = template_rs.rand(n_classes, *shape).astype(np.float32)
    rs = np.random.RandomState(seed)
    labels = rs.randint(0, n_classes, n)
    noise = rs.rand(n, *shape).astype(np.float32)
    imgs = np.clip(0.7 * templates[labels] + 0.3 * noise, 0, 1) * 255.0
    return imgs.astype(np.uint8), labels.astype(np.int64)


class MnistDataFetcher:
    """MNIST loader: idx archives from the cache dir, else synthetic
    surrogate (datasets/fetchers/MnistDataFetcher.java)."""

    N_CLASSES = 10
    H = W = 28

    def __init__(self, train: bool = True, seed: int = 12345):
        img = _find(*(["train-images-idx3-ubyte", "train-images-idx3-ubyte.gz"] if train
                      else ["t10k-images-idx3-ubyte", "t10k-images-idx3-ubyte.gz"]))
        lbl = _find(*(["train-labels-idx1-ubyte", "train-labels-idx1-ubyte.gz"] if train
                      else ["t10k-labels-idx1-ubyte", "t10k-labels-idx1-ubyte.gz"]))
        if img and lbl:
            self.images = _read_idx_images(img)
            self.labels = _read_idx_labels(lbl)
            self.synthetic = False
        else:
            n = 60000 if train else 10000
            n = int(os.environ.get("DL4J_TPU_SYNTH_N", n))
            self.images, self.labels = _synthetic_images(
                n, self.N_CLASSES, self.H, self.W, 1, seed + (0 if train else 1)
            )
            self.synthetic = True

    def dataset(self, binarize: bool = False, flatten: bool = False) -> DataSet:
        x = self.images.astype(np.float32) / 255.0
        if binarize:
            x = (x > 0.5).astype(np.float32)
        x = x.reshape(len(x), -1) if flatten else x[..., None]  # NHWC
        y = np.eye(self.N_CLASSES, dtype=np.float32)[self.labels]
        return DataSet(x, y)


class EmnistDataFetcher(MnistDataFetcher):
    """EMNIST splits (datasets/fetchers/EmnistDataFetcher.java). Class count
    per split; idx files share MNIST's format."""

    SPLITS = {"balanced": 47, "byclass": 62, "bymerge": 47, "digits": 10,
              "letters": 26, "mnist": 10}

    def __init__(self, split: str = "balanced", train: bool = True, seed: int = 12345):
        self.N_CLASSES = self.SPLITS[split]
        prefix = f"emnist-{split}-{'train' if train else 'test'}"
        img = _find(f"{prefix}-images-idx3-ubyte", f"{prefix}-images-idx3-ubyte.gz")
        lbl = _find(f"{prefix}-labels-idx1-ubyte", f"{prefix}-labels-idx1-ubyte.gz")
        if img and lbl:
            self.images = _read_idx_images(img)
            self.labels = _read_idx_labels(lbl)
            if split == "letters":  # letters labels are 1-based
                self.labels = self.labels - 1
            self.synthetic = False
        else:
            n = int(os.environ.get("DL4J_TPU_SYNTH_N", 10000))
            # stable per-split offset (hash() is randomized per process by
            # PYTHONHASHSEED and would break the deterministic surrogate)
            split_seed = sum(ord(c) for c in split) % 1000
            self.images, self.labels = _synthetic_images(
                n, self.N_CLASSES, 28, 28, 1, seed + split_seed
            )
            self.synthetic = True


class MnistDataSetIterator(ListDataSetIterator):
    """datasets/iterator/impl/MnistDataSetIterator.java."""

    def __init__(self, batch_size: int, train: bool = True, binarize: bool = False,
                 shuffle: bool = True, seed: int = 12345, flatten: bool = False,
                 num_examples: Optional[int] = None):
        f = MnistDataFetcher(train, seed)
        ds = f.dataset(binarize, flatten)
        if shuffle:
            ds = ds.shuffle(seed)
        if num_examples is not None:
            ds, _ = ds.split_test_and_train(num_examples)
        super().__init__(ds, batch_size)
        self.synthetic = f.synthetic


class EmnistDataSetIterator(ListDataSetIterator):
    def __init__(self, split: str, batch_size: int, train: bool = True,
                 shuffle: bool = True, seed: int = 12345):
        f = EmnistDataFetcher(split, train, seed)
        ds = f.dataset()
        if shuffle:
            ds = ds.shuffle(seed)
        super().__init__(ds, batch_size)
        self.synthetic = f.synthetic


# Fisher's iris measurements in cm x 10, one 8-digit group per flower
# (sepal length, sepal width, petal length, petal width; two digits each),
# 50 of each class in class order: scikit-learn's load_iris() data, which the
# JAX package reads; kept inline here, since the port needs no scikit-learn.
_IRIS = (
    "51351402 49301402 47321302 46311502 50361402 54391704 46341403 "
    "50341502 44291402 49311501 54371502 48341602 48301401 43301101 "
    "58401202 57441504 54391304 51351403 57381703 51381503 54341702 "
    "51371504 46361002 51331705 48341902 50301602 50341604 52351502 "
    "52341402 47321602 48311602 54341504 52411501 55421402 49311502 "
    "50321202 55351302 49361401 44301302 51341502 50351303 45231303 "
    "44321302 50351606 51381904 48301403 51381602 46321402 53371502 "
    "50331402 70324714 64324515 69314915 55234013 65284615 57284513 "
    "63334716 49243310 66294613 52273914 50203510 59304215 60224010 "
    "61294714 56293613 67314414 56304515 58274110 62224515 56253911 "
    "59324818 61284013 63254915 61284712 64294313 66304414 68284814 "
    "67305017 60294515 57263510 55243811 55243710 58273912 60275116 "
    "54304515 60344516 67314715 63234413 56304113 55254013 55264412 "
    "61304614 58264012 50233310 56274213 57304212 57294213 62294313 "
    "51253011 57284113 63336025 58275119 71305921 63295618 65305822 "
    "76306621 49254517 73296318 67255818 72366125 65325120 64275319 "
    "68305521 57255020 58285124 64325323 65305518 77386722 77266923 "
    "60225015 69325723 56284920 77286720 63274918 67335721 72326018 "
    "62284818 61304918 64285621 72305816 74286119 79386420 64285622 "
    "63285115 61265614 77306123 63345624 64315518 60304818 69315421 "
    "67315624 69315123 58275119 68325923 67335725 67305223 63255019 "
    "65305220 62345423 59305118"
)


def _iris_arrays() -> Tuple[np.ndarray, np.ndarray]:
    rows = [[int(g[i:i + 2]) for i in range(0, 8, 2)] for g in _IRIS.split()]
    x = np.asarray(rows, np.float64) / 10.0
    return x, np.repeat(np.arange(3), 50)


class IrisDataSetIterator(ListDataSetIterator):
    """The real Fisher iris data (datasets/iterator/impl/IrisDataSetIterator.java)."""

    def __init__(self, batch_size: int = 150, num_examples: int = 150, seed: int = 12345):
        data, target = _iris_arrays()
        x = data.astype(np.float32)
        y = np.eye(3, dtype=np.float32)[target]
        idx = np.random.RandomState(seed).permutation(len(x))[:num_examples]
        super().__init__(DataSet(x[idx], y[idx]), batch_size)


class CifarDataSetIterator(ListDataSetIterator):
    """CIFAR-10 (datasets/iterator/impl/CifarDataSetIterator.java): python
    pickle batches from the cache dir, else synthetic surrogate."""

    N_CLASSES = 10

    def __init__(self, batch_size: int, train: bool = True, shuffle: bool = True,
                 seed: int = 12345, num_examples: Optional[int] = None):
        root = os.path.join(cache_dir(), "cifar-10-batches-py")
        xs, ys = [], []
        if os.path.isdir(root):
            import pickle

            names = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
            for n in names:
                with open(os.path.join(root, n), "rb") as f:
                    d = pickle.load(f, encoding="bytes")
                xs.append(np.asarray(d[b"data"], np.uint8).reshape(-1, 3, 32, 32))
                ys.append(np.asarray(d[b"labels"], np.int64))
            x = np.concatenate(xs).transpose(0, 2, 3, 1)  # NHWC
            y = np.concatenate(ys)
            self.synthetic = False
        else:
            n = int(os.environ.get("DL4J_TPU_SYNTH_N", 50000 if train else 10000))
            x, y = _synthetic_images(n, 10, 32, 32, 3, seed + (2 if train else 3))
            self.synthetic = True
        xf = x.astype(np.float32) / 255.0
        yf = np.eye(self.N_CLASSES, dtype=np.float32)[y]
        ds = DataSet(xf, yf)
        if shuffle:
            ds = ds.shuffle(seed)
        if num_examples is not None:
            ds, _ = ds.split_test_and_train(num_examples)
        super().__init__(ds, batch_size)


class TinyImageNetDataSetIterator(ListDataSetIterator):
    """TinyImageNet 64x64x3, 200 classes (TinyImageNetFetcher.java); images
    load from the cache-dir folder layout
    (``tiny-imagenet-200/train/<wnid>/images/*.JPEG``) when present and PIL
    is importable, else a deterministic synthetic surrogate."""

    N_CLASSES = 200

    def __init__(self, batch_size: int, train: bool = True, seed: int = 12345,
                 num_examples: Optional[int] = None):
        loaded = self._try_load_folder(train, num_examples)
        if loaded is not None:
            x, y = loaded
            self.synthetic = False
        else:
            n = int(os.environ.get("DL4J_TPU_SYNTH_N", 2000))
            x, y = _synthetic_images(n, self.N_CLASSES, 64, 64, 3, seed + 7)
            self.synthetic = True
        ds = DataSet(x.astype(np.float32) / 255.0,
                     np.eye(self.N_CLASSES, dtype=np.float32)[y])
        if num_examples is not None:
            ds, _ = ds.split_test_and_train(num_examples)
        super().__init__(ds, batch_size)

    def _try_load_folder(self, train: bool, limit: Optional[int]):
        root = os.path.join(cache_dir(), "tiny-imagenet-200")
        split_dir = os.path.join(root, "train" if train else "val")
        if not os.path.isdir(split_dir):
            return None
        try:
            from PIL import Image
        except ImportError:
            return None
        wnids_file = os.path.join(root, "wnids.txt")
        if not os.path.exists(wnids_file):
            return None
        wnids = [w.strip() for w in open(wnids_file) if w.strip()]
        cls_of = {w: i for i, w in enumerate(wnids)}
        xs, ys = [], []
        for wnid in wnids:
            img_dir = os.path.join(split_dir, wnid, "images")
            if not os.path.isdir(img_dir):
                continue
            for fn in sorted(os.listdir(img_dir)):
                img = Image.open(os.path.join(img_dir, fn)).convert("RGB")
                xs.append(np.asarray(img, np.uint8))
                ys.append(cls_of[wnid])
                if limit is not None and len(xs) >= limit:
                    break
            if limit is not None and len(xs) >= limit:
                break
        if not xs:
            return None
        return np.stack(xs), np.asarray(ys, np.int64)


def uci_synthetic_control(n_per_class: int = 100, timesteps: int = 60,
                          seed: int = 12345) -> Tuple[np.ndarray, np.ndarray]:
    """The UCI 'synthetic control chart' generator (6 classes): normal,
    cyclic, increasing trend, decreasing trend, upward shift, downward shift.
    (UciSequenceDataFetcher.java downloads the dataset; it was itself
    generated from these equations, so we generate it directly.)"""
    rs = np.random.RandomState(seed)
    t = np.arange(timesteps, dtype=np.float64)
    series, labels = [], []
    for cls in range(6):
        for _ in range(n_per_class):
            m, s = 30.0, 2.0
            r = rs.rand(timesteps)
            base = m + s * (r - 0.5) * 2
            if cls == 1:  # cyclic
                a, T = 15.0 * rs.rand() + 10.0, 10.0 + 5.0 * rs.rand()
                base = base + a * np.sin(2 * np.pi * t / T)
            elif cls == 2:  # increasing trend
                base = base + (0.2 + 0.3 * rs.rand()) * t
            elif cls == 3:  # decreasing trend
                base = base - (0.2 + 0.3 * rs.rand()) * t
            elif cls == 4:  # upward shift
                t3 = rs.randint(timesteps // 3, 2 * timesteps // 3)
                base = base + (t >= t3) * (7.5 + 12.5 * rs.rand())
            elif cls == 5:  # downward shift
                t3 = rs.randint(timesteps // 3, 2 * timesteps // 3)
                base = base - (t >= t3) * (7.5 + 12.5 * rs.rand())
            series.append(base)
            labels.append(cls)
    x = np.asarray(series, np.float32)[..., None]  # [N, T, 1]
    y = np.eye(6, dtype=np.float32)[np.asarray(labels)]
    return x, y


class UciSequenceDataSetIterator(ListDataSetIterator):
    """Sequence classification set (UciSequenceDataSetIterator.java):
    labels broadcast per-timestep for RnnOutputLayer heads."""

    def __init__(self, batch_size: int, train: bool = True, seed: int = 12345):
        x, y = uci_synthetic_control(seed=seed)
        idx = np.random.RandomState(seed + 1).permutation(len(x))
        cut = int(0.75 * len(x))
        pick = idx[:cut] if train else idx[cut:]
        yy = np.repeat(y[pick][:, None, :], x.shape[1], axis=1)  # [N, T, C]
        super().__init__(DataSet(x[pick], yy), batch_size)


class SvhnDataSetIterator(ListDataSetIterator):
    """SVHN 32x32x3 digits (datasets/fetchers/SvhnDataFetcher.java): loads
    the cropped-digits .mat files from the cache dir when scipy is
    importable, else a deterministic synthetic surrogate."""

    N_CLASSES = 10

    def __init__(self, batch_size: int, train: bool = True, seed: int = 12345,
                 num_examples: Optional[int] = None):
        loaded = self._try_load_mat(train)
        if loaded is not None:
            x, y = loaded
            self.synthetic = False
        else:
            n = int(os.environ.get("DL4J_TPU_SYNTH_N", 5000))
            x, y = _synthetic_images(n, self.N_CLASSES, 32, 32, 3,
                                     seed + (11 if train else 12))
            self.synthetic = True
        ds = DataSet(x.astype(np.float32) / 255.0,
                     np.eye(self.N_CLASSES, dtype=np.float32)[y])
        if num_examples is not None:
            ds, _ = ds.split_test_and_train(num_examples)
        super().__init__(ds, batch_size)

    def _try_load_mat(self, train: bool):
        path = os.path.join(cache_dir(),
                            "train_32x32.mat" if train else "test_32x32.mat")
        if not os.path.exists(path):
            return None
        try:
            from scipy.io import loadmat
        except ImportError:
            return None
        d = loadmat(path)
        x = np.transpose(d["X"], (3, 0, 1, 2))          # HWCN -> NHWC
        y = d["y"].ravel().astype(np.int64) % 10        # SVHN labels digit '0' as 10
        return x, y


class LFWDataSetIterator(ListDataSetIterator):
    """Labeled Faces in the Wild (datasets/iterator/impl/LFWDataSetIterator.java):
    ``lfw/<person>/<person>_NNNN.jpg`` folders from the cache dir when PIL is
    importable, else a synthetic surrogate. ``num_labels``: keep the N most
    frequent identities (the reference's numLabels knob)."""

    def __init__(self, batch_size: int, image_shape: Tuple[int, int, int] = (64, 64, 3),
                 num_labels: int = 10, train: bool = True, seed: int = 12345,
                 num_examples: Optional[int] = None):
        h, w, c = image_shape
        self.num_labels = num_labels
        loaded = self._try_load_folder(h, w, num_labels)
        if loaded is not None:
            x, y = loaded
            self.synthetic = False
        else:
            n = int(os.environ.get("DL4J_TPU_SYNTH_N", 1000))
            x, y = _synthetic_images(n, num_labels, h, w, c,
                                     seed + (13 if train else 14))
            self.synthetic = True
        ds = DataSet(x.astype(np.float32) / 255.0,
                     np.eye(num_labels, dtype=np.float32)[y])
        if num_examples is not None:
            ds, _ = ds.split_test_and_train(num_examples)
        super().__init__(ds, batch_size)

    def _try_load_folder(self, h: int, w: int, num_labels: int):
        root = os.path.join(cache_dir(), "lfw")
        if not os.path.isdir(root):
            return None
        try:
            from PIL import Image
        except ImportError:
            return None
        def n_images(d):
            return sum(1 for f in os.listdir(os.path.join(root, d))
                       if f.lower().endswith((".jpg", ".jpeg", ".png")))

        people = sorted(
            (d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
             and n_images(d) > 0),
            key=lambda d: -n_images(d))[:num_labels]
        xs, ys = [], []
        for li, person in enumerate(people):
            pdir = os.path.join(root, person)
            for f in sorted(os.listdir(pdir)):
                if not f.lower().endswith((".jpg", ".jpeg", ".png")):
                    continue
                img = Image.open(os.path.join(pdir, f)).convert("RGB").resize((w, h))
                xs.append(np.asarray(img, np.uint8))
                ys.append(li)
        if not xs:
            return None
        return np.stack(xs), np.asarray(ys, np.int64)
