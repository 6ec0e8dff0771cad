"""Datasets (PyTorch port of ``deeplearning4j_tpu/datasets``): containers,
iterator combinators, built-in sets, normalizers, record readers.

The DataSet / MultiDataSet containers (numpy) that ``fit`` takes as input;
the DataSetIterator combinators (host numpy batches; ``fit`` takes an
iterator as a callable that returns a fresh iterable per epoch); the
built-in fetchers (local archives under ``$DL4J_TPU_DATA``, else the JAX
package's seeded synthetic surrogates, flagged ``.synthetic``); the
normalizers, whose ``to_dict`` the JAX package reads; the DataVec-style
record readers and ``TransformProcess``; and ``prefetch_to_device``, which
copies batches to the card on a side stream ahead of the step that uses
them. Everything but ``prefetch_to_device`` is host numpy, a copy of the
JAX package's; the numeric parsers go through ``deeplearning4j_tpu_torch/
native`` when ``g++`` is present. ``ShardedDataSetIterator`` deals the
batches of a shared stream out to the ranks of a process group.
"""

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterator import (
    AsyncDataSetIterator,
    AsyncMultiDataSetIterator,
    BenchmarkDataSetIterator,
    DataSetIterator,
    DataSetIteratorSplitter,
    EarlyTerminationDataSetIterator,
    FileDataSetIterator,
    JointParallelDataSetIterator,
    ListDataSetIterator,
    MultipleEpochsIterator,
    ShardedDataSetIterator,
    prefetch_to_device,
)
from deeplearning4j_tpu_torch.datasets.fetchers import (
    CifarDataSetIterator,
    EmnistDataSetIterator,
    IrisDataSetIterator,
    LFWDataSetIterator,
    MnistDataSetIterator,
    SvhnDataSetIterator,
    TinyImageNetDataSetIterator,
    UciSequenceDataSetIterator,
    cache_dir,
    uci_synthetic_control,
)
from deeplearning4j_tpu_torch.datasets.normalizers import (
    ImagePreProcessingScaler,
    Normalizer,
    NormalizerMinMaxScaler,
    NormalizerStandardize,
    VGG16ImagePreProcessor,
)
from deeplearning4j_tpu_torch.datasets.transform import Schema, TransformProcess
from deeplearning4j_tpu_torch.datasets.records import (
    CSVRecordReader,
    CSVSequenceRecordReader,
    ImageRecordReader,
    RecordReaderDataSetIterator,
    SequenceRecordReaderDataSetIterator,
)

__all__ = [
    "DataSet", "MultiDataSet",
    "DataSetIterator", "ListDataSetIterator", "AsyncDataSetIterator",
    "AsyncMultiDataSetIterator", "EarlyTerminationDataSetIterator",
    "MultipleEpochsIterator", "ShardedDataSetIterator", "DataSetIteratorSplitter",
    "BenchmarkDataSetIterator", "FileDataSetIterator",
    "JointParallelDataSetIterator", "prefetch_to_device",
    "MnistDataSetIterator", "EmnistDataSetIterator", "IrisDataSetIterator",
    "CifarDataSetIterator", "TinyImageNetDataSetIterator",
    "SvhnDataSetIterator", "LFWDataSetIterator",
    "UciSequenceDataSetIterator", "uci_synthetic_control", "cache_dir",
    "Normalizer", "NormalizerStandardize", "NormalizerMinMaxScaler",
    "VGG16ImagePreProcessor",
    "ImagePreProcessingScaler",
    "Schema", "TransformProcess",
    "CSVRecordReader", "CSVSequenceRecordReader", "ImageRecordReader",
    "RecordReaderDataSetIterator", "SequenceRecordReaderDataSetIterator",
]
