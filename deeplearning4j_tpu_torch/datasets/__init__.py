"""Datasets (PyTorch port of part of ``deeplearning4j_tpu/datasets``).

Ported so far: the ``DataSet`` / ``MultiDataSet`` containers (numpy, a
copy) that ``fit`` takes as input, and ``prefetch_to_device``, which copies
batches to the card on a side stream ahead of the step that uses them. The
iterator combinators, fetchers, normalizers and record readers wait for
the data-path slice (ROADMAP Queue 1 item 8).
"""

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.datasets.iterator import prefetch_to_device

__all__ = ["DataSet", "MultiDataSet", "prefetch_to_device"]
