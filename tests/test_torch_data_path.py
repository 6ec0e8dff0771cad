"""The port's data path (deeplearning4j_tpu_torch/datasets/{normalizers,
records, transform, fetchers, iterator}.py and native/) against the JAX
package's on the CPU: normalizers and their JSON, the CSV / sequence /
image readers and their iterators, TransformProcess and its JSON, the
fetchers on local IDX files and on their seeded surrogates, and the C++
parsers against the Python ones."""

import gzip
import os
import struct

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets import DataSet as JDataSet
from deeplearning4j_tpu.datasets import fetchers as jfetchers
from deeplearning4j_tpu.datasets import normalizers as jnorm
from deeplearning4j_tpu.datasets import records as jrecords
from deeplearning4j_tpu.datasets.transform import Schema as JSchema
from deeplearning4j_tpu.datasets.transform import TransformProcess as JTransformProcess
from deeplearning4j_tpu_torch import native
from deeplearning4j_tpu_torch.datasets import (
    DataSet,
    ListDataSetIterator,
    fetchers,
    normalizers as norm,
    records,
)
from deeplearning4j_tpu_torch.datasets.transform import Schema, TransformProcess


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith("DL4J_TPU_"):
            monkeypatch.delenv(k)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f")


def _same_sets(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in ("features", "labels", "features_mask", "labels_mask"):
            gv, wv = getattr(g, k), getattr(w, k)
            assert (gv is None) == (wv is None), k
            if wv is not None:
                _same(gv, wv)


# -- normalizers ---------------------------------------------------------------

NORMALIZERS = {
    "standardize_2d": (lambda m: m.NormalizerStandardize(), (40, 5)),
    "standardize_nhwc": (lambda m: m.NormalizerStandardize(), (6, 4, 4, 3)),
    "minmax": (lambda m: m.NormalizerMinMaxScaler(-1.0, 2.0), (40, 5)),
    "image": (lambda m: m.ImagePreProcessingScaler(0.0, 1.0), (6, 4, 4, 3)),
    "vgg16": (lambda m: m.VGG16ImagePreProcessor(), (6, 4, 4, 3)),
}


@pytest.mark.parametrize("case", sorted(NORMALIZERS))
def test_normalizer_fit_transform_revert_and_json(case):
    make, shape = NORMALIZERS[case]
    rs = np.random.RandomState(4)
    x = (rs.rand(*shape) * 255).astype(np.float32)
    x[:, 0] = 3.0                      # a constant column / row (std 0)
    y = np.eye(2, dtype=np.float32)[rs.randint(0, 2, shape[0])]
    mine = make(norm).fit(DataSet(x, y))
    theirs = make(jnorm).fit(JDataSet(x, y))
    assert mine.to_dict() == theirs.to_dict()
    t = mine.transform(DataSet(x, y))
    _same(t.features, theirs.transform(JDataSet(x, y)).features)
    _same(t.labels, y)
    _same(mine.revert_features(t.features), theirs.revert_features(t.features))
    # each package reads the other's normalizer.json
    back = norm.Normalizer.from_json(theirs.to_json())
    _same(back.transform_features(x), theirs.transform_features(x))
    assert jnorm.Normalizer.from_json(mine.to_json()).to_dict() == mine.to_dict()


def test_normalizer_fits_over_an_iterator():
    rs = np.random.RandomState(5)
    x = rs.randn(30, 3).astype(np.float32)
    y = np.zeros((30, 1), np.float32)
    mine = norm.NormalizerStandardize().fit(ListDataSetIterator(DataSet(x, y), 7))
    theirs = jnorm.NormalizerStandardize().fit(jfetchers.ListDataSetIterator(JDataSet(x, y), 7))
    assert mine.to_dict() == theirs.to_dict()


# -- iterator combinators ------------------------------------------------------------

def _base(m, D):
    rs = np.random.RandomState(13)
    return m.ListDataSetIterator(D(rs.rand(23, 3).astype(np.float32),
                                   np.eye(2, dtype=np.float32)[rs.randint(0, 2, 23)]), 5)


COMBINATORS = {
    "async": lambda m, D: m.AsyncDataSetIterator(_base(m, D), queue_size=2),
    "early_termination": lambda m, D: m.EarlyTerminationDataSetIterator(_base(m, D), 3),
    "multiple_epochs": lambda m, D: m.MultipleEpochsIterator(_base(m, D), 2),
    "splitter_train": lambda m, D: m.DataSetIteratorSplitter(_base(m, D), 5, 0.6).train,
    "splitter_test": lambda m, D: m.DataSetIteratorSplitter(_base(m, D), 5, 0.6).test,
    "benchmark": lambda m, D: m.BenchmarkDataSetIterator((4, 3), 2, 3, seed=7),
    "joint_parallel": lambda m, D: m.JointParallelDataSetIterator(_base(m, D),
                                                                  m.ListDataSetIterator(
                                                                      _base(m, D).data, 7)),
}


@pytest.mark.parametrize("name", sorted(COMBINATORS))
def test_iterator_combinators_yield_the_jax_batches(name):
    from deeplearning4j_tpu.datasets import iterator as jiterator
    from deeplearning4j_tpu_torch.datasets import iterator

    got = COMBINATORS[name](iterator, DataSet)
    want = COMBINATORS[name](jiterator, JDataSet)
    _same_sets(got, want)
    scaler = norm.ImagePreProcessingScaler(0.0, 2.0, max_pixel=1.0)
    got.set_pre_processor(scaler)
    want.set_pre_processor(jnorm.ImagePreProcessingScaler(0.0, 2.0, max_pixel=1.0))
    _same_sets(got, want)


def test_file_iterator_reads_saved_datasets(tmp_path):
    from deeplearning4j_tpu.datasets import iterator as jiterator
    from deeplearning4j_tpu_torch.datasets import iterator

    for i, ds in enumerate(_base(jfetchers, JDataSet)):
        ds.save(str(tmp_path / f"b{i}.npz"))
    for shuffle in (False, True):
        _same_sets(iterator.FileDataSetIterator(str(tmp_path), shuffle=shuffle),
                   jiterator.FileDataSetIterator(str(tmp_path), shuffle=shuffle))


# -- record readers -------------------------------------------------------------

def _write_csv(path, rows, header=None):
    with open(path, "w") as f:
        if header:
            f.write(header + "\n")
        for r in rows:
            f.write(",".join(repr(float(v)) if not float(v).is_integer() else str(int(v))
                             for v in r) + "\n")


@pytest.mark.parametrize("skip", [0, 1])
def test_csv_reader_and_iterator_match(tmp_path, skip):
    rs = np.random.RandomState(6)
    rows = np.concatenate([rs.randn(23, 4).round(5), rs.randint(0, 3, (23, 1))], axis=1)
    path = str(tmp_path / "t.csv")
    _write_csv(path, rows, header="a,b,c,d,label" if skip else None)
    _same(records.CSVRecordReader(skip_lines=skip).read(path),
          jrecords.CSVRecordReader(skip_lines=skip).read(path))
    reader = records.CSVRecordReader(skip_lines=skip)
    got = records.RecordReaderDataSetIterator(path, 8, label_index=4, num_classes=3,
                                              reader=reader)
    want = jrecords.RecordReaderDataSetIterator(path, 8, label_index=4, num_classes=3,
                                                reader=jrecords.CSVRecordReader(skip_lines=skip))
    _same_sets(got, want)
    reg = records.RecordReaderDataSetIterator(path, 8, label_index=0, num_classes=1,
                                              reader=reader, regression=True)
    jreg = jrecords.RecordReaderDataSetIterator(
        path, 8, label_index=0, num_classes=1,
        reader=jrecords.CSVRecordReader(skip_lines=skip), regression=True)
    _same_sets(reg, jreg)


def test_csv_reader_falls_back_on_quoted_fields(tmp_path):
    path = str(tmp_path / "q.csv")
    with open(path, "w") as f:
        f.write('"1.5",2\n"3",4\n')
    _same(records.CSVRecordReader().read(path), jrecords.CSVRecordReader().read(path))


def test_sequence_reader_and_iterator_match(tmp_path):
    rs = np.random.RandomState(7)
    feats, labs = [], []
    for i, T in enumerate((5, 3, 7, 4, 2)):
        fp, lp = str(tmp_path / f"f{i}.csv"), str(tmp_path / f"l{i}.csv")
        _write_csv(fp, rs.randn(T, 3).round(4))
        _write_csv(lp, rs.randint(0, 4, (T, 1)))
        feats.append(fp)
        labs.append(lp)
    seqs = records.CSVSequenceRecordReader().read_sequences(feats)
    for a, b in zip(seqs, jrecords.CSVSequenceRecordReader().read_sequences(feats)):
        _same(a, b)
    _same_sets(records.SequenceRecordReaderDataSetIterator(feats, labs, 2, 4),
               jrecords.SequenceRecordReaderDataSetIterator(feats, labs, 2, 4))


def test_image_reader_matches(tmp_path):
    from PIL import Image

    rs = np.random.RandomState(8)
    for label in ("cat", "dog"):
        d = tmp_path / label
        d.mkdir()
        for i in range(3):
            Image.fromarray(rs.randint(0, 256, (9, 7, 3), dtype=np.uint8)).save(d / f"{i}.png")
    for ch in (3, 1):
        got = records.ImageRecordReader(6, 5, ch)
        want = jrecords.ImageRecordReader(6, 5, ch)
        for a, b in zip(got.read_dir(str(tmp_path)), want.read_dir(str(tmp_path))):
            _same(a, b)
        assert got.labels == want.labels == ["cat", "dog"]


# -- TransformProcess --------------------------------------------------------------

def _schema(S):
    return (S.builder().add_double("sepal_len", "sepal_wid").add_integer("count")
            .add_categorical("species", ["setosa", "versicolor", "virginica"])
            .add_string("note").build())


RECORDS = [[5.1, 3.5, 2, "setosa", "ok"], [6.2, float("nan"), 0, "virginica", "ok"],
           [4.8, 3.0, 5, "versicolor", "meh"], [7.0, 3.2, 1, "setosa", "bad"]]


def _pipeline(S, TP):
    return (TP.builder(_schema(S))
            .remove_columns("note")
            .replace_invalid("sepal_wid", -1.0)
            .filter_numeric("count", ">=", 5)
            .rename_column("count", "n")
            .categorical_to_one_hot("species")
            .double_math_op("sepal_wid", "multiply", 2.0)
            .normalize_min_max("sepal_len", 4.0, 8.0)
            .build())


def test_transform_process_json_round_trip_and_outputs():
    mine, theirs = _pipeline(Schema, TransformProcess), _pipeline(JSchema, JTransformProcess)
    assert mine.to_dict() == theirs.to_dict()
    assert TransformProcess.from_dict(theirs.to_dict()).to_dict() == theirs.to_dict()
    assert JTransformProcess.from_dict(mine.to_dict()).to_dict() == mine.to_dict()
    got, want = mine.execute(RECORDS), theirs.execute(RECORDS)
    assert list(got) == list(want)
    for k in want:
        _same(got[k], want[k])
    _same(mine.execute_to_matrix(RECORDS), theirs.execute_to_matrix(RECORDS))
    cols = {k: np.asarray([r[i] for r in RECORDS]) for i, k in enumerate(_schema(Schema).names())}
    _same(mine.execute_to_matrix(cols), theirs.execute_to_matrix(cols))


def test_transform_process_errors_match():
    tp = (TransformProcess.builder(_schema(Schema)).categorical_to_integer("species").build())
    jtp = (JTransformProcess.builder(_schema(JSchema)).categorical_to_integer("species").build())
    bad = [[5.1, 3.5, 2, "unknown", "x"]]
    with pytest.raises(ValueError):
        jtp.execute(bad)
    with pytest.raises(ValueError):
        tp.execute(bad)


# -- fetchers --------------------------------------------------------------------

def _write_idx(root, prefix, n, seed, gz=False, labels_from=0, classes=10):
    rs = np.random.RandomState(seed)
    imgs = rs.randint(0, 256, (n, 28, 28), dtype=np.uint8)
    labels = rs.randint(labels_from, labels_from + classes, n).astype(np.uint8)
    op = gzip.open if gz else open
    sfx = ".gz" if gz else ""
    with op(os.path.join(root, f"{prefix}-images-idx3-ubyte{sfx}"), "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
    with op(os.path.join(root, f"{prefix}-labels-idx1-ubyte{sfx}"), "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())
    return imgs, labels


@pytest.mark.parametrize("gz", [False, True])
def test_mnist_from_local_idx_files(tmp_path, monkeypatch, gz):
    monkeypatch.setenv("DL4J_TPU_DATA", str(tmp_path))
    imgs, labels = _write_idx(str(tmp_path), "train", 50, 9, gz)
    _write_idx(str(tmp_path), "t10k", 20, 10, gz)
    before = native.CALLS["parse_idx_images"]
    got = fetchers.MnistDataSetIterator(16, train=True, seed=3)
    want = jfetchers.MnistDataSetIterator(16, train=True, seed=3)
    assert got.synthetic is False and want.synthetic is False
    assert native.CALLS["parse_idx_images"] == before + 1
    _same_sets(got, want)
    f = fetchers.MnistDataFetcher(train=True)
    _same(f.images, imgs)
    _same(f.labels, labels)
    _same_sets(fetchers.MnistDataSetIterator(8, train=False, flatten=True, binarize=True),
               jfetchers.MnistDataSetIterator(8, train=False, flatten=True, binarize=True))


def test_emnist_letters_from_local_idx_files(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_DATA", str(tmp_path))
    os.makedirs(tmp_path / "emnist")
    # the letters split's labels are 1-based in the archive
    _write_idx(str(tmp_path / "emnist"), "emnist-letters-train", 30, 11, labels_from=1,
               classes=26)
    got = fetchers.EmnistDataSetIterator("letters", 10, seed=2)
    assert got.synthetic is False
    _same_sets(got, jfetchers.EmnistDataSetIterator("letters", 10, seed=2))


SURROGATES = {
    "mnist": lambda m: m.MnistDataSetIterator(32, train=False, seed=5),
    "emnist": lambda m: m.EmnistDataSetIterator("balanced", 32, seed=5),
    "cifar10": lambda m: m.CifarDataSetIterator(32, train=True, seed=5),
    "tinyimagenet": lambda m: m.TinyImageNetDataSetIterator(32, seed=5),
    "svhn": lambda m: m.SvhnDataSetIterator(32, seed=5),
    "lfw": lambda m: m.LFWDataSetIterator(32, image_shape=(16, 16, 3), num_labels=4, seed=5),
    "uci": lambda m: m.UciSequenceDataSetIterator(32, seed=5),
    "iris": lambda m: m.IrisDataSetIterator(40, seed=5),
}


@pytest.mark.parametrize("name", sorted(SURROGATES))
def test_fetcher_surrogates_equal_the_jax_packages(tmp_path, monkeypatch, name):
    monkeypatch.setenv("DL4J_TPU_DATA", str(tmp_path))
    monkeypatch.setenv("DL4J_TPU_SYNTH_N", "64")
    got, want = SURROGATES[name](fetchers), SURROGATES[name](jfetchers)
    assert getattr(got, "synthetic", None) == getattr(want, "synthetic", None)
    _same_sets(got, want)


def test_iris_is_the_real_data():
    from sklearn.datasets import load_iris

    x, target = fetchers._iris_arrays()
    d = load_iris()
    _same(x, d.data)
    _same(target, d.target)


# -- the native parsers ------------------------------------------------------------

@pytest.mark.parametrize("text,skip", [("1,2,3\n4,5.5,-6e-3\n", 0), ("h1;h2\n1;2\n3;4", 1),
                                        ("1.25,2\n\n3,4\n", 0)])
def test_native_csv_equals_the_python_parse(tmp_path, text, skip):
    delim = ";" if ";" in text else ","
    got = native.parse_csv(text.encode(), skip_lines=skip, delimiter=delim)
    import csv
    rows = list(csv.reader(text.splitlines(), delimiter=delim))[skip:]
    want = np.asarray([[float(v) for v in r] for r in rows if r], np.float64)
    _same(got, want)


@pytest.mark.parametrize("text", ["1,2\n3\n", "1,x\n", '"1",2\n'])
def test_native_csv_rejects_what_the_python_path_must_handle(text):
    with pytest.raises(ValueError):
        native.parse_csv(text.encode())


def test_native_idx_equals_the_python_parse():
    rs = np.random.RandomState(12)
    imgs = rs.randint(0, 256, (5, 4, 3), dtype=np.uint8)
    data = struct.pack(">IIII", 2051, 5, 4, 3) + imgs.tobytes()
    _same(native.parse_idx_images(data), imgs)
    with pytest.raises(ValueError):
        native.parse_idx_images(struct.pack(">IIII", 2049, 5, 4, 3) + imgs.tobytes())
    with pytest.raises(ValueError):
        native.parse_idx_images(data[:-7])
