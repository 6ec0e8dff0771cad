"""Device prefetch for the fit loops (PyTorch port of ``prefetch_to_device``
in ``deeplearning4j_tpu/datasets/iterator.py``).

A background thread copies each batch's arrays to the device ahead of the
step that uses them. On a CUDA device the copies run on a side stream from
page-locked host buffers, so batch N+1's copy overlaps batch N's compute;
the consumer's stream waits on the copy's event before it touches the
batch, and every copied tensor is ``record_stream``-ed on the consumer's
stream, so the caching allocator does not hand its memory to another
tensor while the step still reads it. On the CPU the batches become
tensors and nothing is copied.

The DataSetIterator family above it (the base, ListDataSetIterator, the
async, early-termination, multi-epoch, splitter, benchmark, file and joint
iterators) is a copy of the JAX package's: host numpy batches that ``fit``
takes as an iterable or, being callable, a fresh iterable per epoch.
``ShardedDataSetIterator`` deals one batch of every group of N to each of
N processes, its process index and count from ``torch.distributed``.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Callable, Iterable, Iterator, List, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet

__all__ = ["AsyncDataSetIterator", "AsyncMultiDataSetIterator", "BenchmarkDataSetIterator",
           "DataSetIterator", "DataSetIteratorSplitter", "EarlyTerminationDataSetIterator",
           "FileDataSetIterator", "JointParallelDataSetIterator", "ListDataSetIterator",
           "MultipleEpochsIterator", "ShardedDataSetIterator", "prefetch_to_device"]


class DataSetIterator:
    """Base: iterable over DataSet batches, re-iterable via reset().

    Subclasses implement ``_produce()`` yielding DataSets. A
    ``pre_processor`` (normalizer or callable) is applied to every batch.
    """

    def __init__(self, batch_size: int = 32):
        self.batch_size = batch_size
        self.pre_processor: Optional[Callable] = None

    def set_pre_processor(self, pp):
        self.pre_processor = pp
        return self

    def _produce(self) -> Iterator[DataSet]:
        raise NotImplementedError

    def __iter__(self):
        for ds in self._produce():
            if self.pre_processor is not None:
                ds = _apply_pp(self.pre_processor, ds)
            yield ds

    def reset(self):
        """Iterators are re-iterable by default; stateful subclasses override."""

    def __call__(self):
        """model.fit accepts callables returning a fresh iterable per epoch."""
        return iter(self)


def _apply_pp(pp, ds: DataSet) -> DataSet:
    if hasattr(pp, "transform"):
        return pp.transform(ds)
    return pp(ds)


class ListDataSetIterator(DataSetIterator):
    """Batches over an in-memory DataSet (reference ListDataSetIterator)."""

    def __init__(self, data: DataSet, batch_size: int = 32):
        super().__init__(batch_size)
        self.data = data

    def _produce(self):
        yield from self.data.batch_by(self.batch_size)

    def total_examples(self) -> int:
        return self.data.num_examples()


class AsyncDataSetIterator(DataSetIterator):
    """Background-thread prefetch with a bounded buffer
    (AsyncDataSetIterator.java; queue_size = bufferSize)."""

    _SENTINEL = object()

    def __init__(self, base: Iterable, queue_size: int = 8):
        super().__init__(getattr(base, "batch_size", 32))
        self.base = base
        self.queue_size = queue_size

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.queue_size)
        err: List[BaseException] = []

        def worker():
            try:
                src = self.base() if callable(self.base) and not hasattr(self.base, "__iter__") else self.base
                for item in src:
                    q.put(item)
            except BaseException as e:  # surface producer errors to consumer
                err.append(e)
            finally:
                q.put(self._SENTINEL)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is self._SENTINEL:
                break
            if self.pre_processor is not None and isinstance(item, DataSet):
                item = _apply_pp(self.pre_processor, item)
            yield item
        t.join()
        if err:
            raise err[0]


# MultiDataSet prefetch is the same machinery (reference has a separate
# AsyncMultiDataSetIterator class only because of Java generics).
AsyncMultiDataSetIterator = AsyncDataSetIterator


class EarlyTerminationDataSetIterator(DataSetIterator):
    """Cap the number of minibatches per epoch (EarlyTerminationDataSetIterator.java)."""

    def __init__(self, base: Iterable, max_batches: int):
        super().__init__(getattr(base, "batch_size", 32))
        self.base = base
        self.max_batches = max_batches

    def _produce(self):
        for i, ds in enumerate(self.base):
            if i >= self.max_batches:
                break
            yield ds


class MultipleEpochsIterator(DataSetIterator):
    """Replay the base iterator N times as one epoch (MultipleEpochsIterator.java)."""

    def __init__(self, base: Iterable, n_epochs: int):
        super().__init__(getattr(base, "batch_size", 32))
        self.base = base
        self.n_epochs = n_epochs

    def _produce(self):
        for _ in range(self.n_epochs):
            if hasattr(self.base, "reset"):
                self.base.reset()
            yield from self.base


class DataSetIteratorSplitter:
    """Split one iterator into train/test partitions by a ratio of batches
    (DataSetIteratorSplitter.java)."""

    def __init__(self, base: Iterable, total_batches: int, ratio: float):
        self.base = base
        self.n_train = int(total_batches * ratio)
        self.total = total_batches

    @property
    def train(self) -> DataSetIterator:
        outer = self

        class _Train(DataSetIterator):
            def _produce(self):
                for i, ds in enumerate(outer.base):
                    if i >= outer.n_train:
                        break
                    yield ds

        return _Train(getattr(self.base, "batch_size", 32))

    @property
    def test(self) -> DataSetIterator:
        outer = self

        class _Test(DataSetIterator):
            def _produce(self):
                for i, ds in enumerate(outer.base):
                    if i < outer.n_train:
                        continue
                    if i >= outer.total:
                        break
                    yield ds

        return _Test(getattr(self.base, "batch_size", 32))


class BenchmarkDataSetIterator(DataSetIterator):
    """Synthetic fixed-shape batches for perf tests
    (impl/BenchmarkDataSetIterator.java): one batch generated once, yielded
    N times — measures the training loop, not the ETL."""

    def __init__(self, feature_shape: Sequence[int], n_classes: int,
                 n_batches: int, seed: int = 12345):
        super().__init__(feature_shape[0])
        rs = np.random.RandomState(seed)
        x = rs.rand(*feature_shape).astype(np.float32)
        y = np.eye(n_classes, dtype=np.float32)[rs.randint(0, n_classes, feature_shape[0])]
        self.ds = DataSet(x, y)
        self.n_batches = n_batches

    def _produce(self):
        for _ in range(self.n_batches):
            yield self.ds


class FileDataSetIterator(DataSetIterator):
    """Stream DataSets saved with DataSet.save() from a directory
    (file/FileDataSetIterator.java)."""

    def __init__(self, path: str, batch_size: int = 32, shuffle: bool = False,
                 seed: int = 12345):
        super().__init__(batch_size)
        self.path = path
        self.shuffle = shuffle
        self.seed = seed

    def _produce(self):
        files = sorted(f for f in os.listdir(self.path) if f.endswith(".npz"))
        if self.shuffle:
            np.random.RandomState(self.seed).shuffle(files)
        for f in files:
            yield DataSet.load(os.path.join(self.path, f))


class JointParallelDataSetIterator(DataSetIterator):
    """Round-robin over several iterators (parallel/JointParallelDataSetIterator.java,
    used to feed multiple DP workers distinct streams)."""

    def __init__(self, *iterators: Iterable):
        super().__init__(getattr(iterators[0], "batch_size", 32))
        self.iterators = iterators

    def _produce(self):
        actives = [iter(it) for it in self.iterators]
        while actives:
            nxt = []
            for it in actives:
                try:
                    yield next(it)
                    nxt.append(it)
                except StopIteration:
                    pass
            actives = nxt


def _is_array(a) -> bool:
    return isinstance(a, (np.ndarray, torch.Tensor)) or (
        hasattr(a, "__array__") and not isinstance(a, (str, bytes)))


def _map_item(item, fn):
    """``fn`` over every array leaf of a batch: tuples, lists, dicts, and
    DataSet / MultiDataSet rebuilt around the results (their ``__init__``
    would turn device tensors back into numpy arrays); None and other
    leaves pass through."""
    if item is None:
        return None
    if isinstance(item, (DataSet, MultiDataSet)):
        new = item.__class__.__new__(item.__class__)
        new.__dict__.update({k: _map_item(v, fn) for k, v in item.__dict__.items()})
        return new
    if isinstance(item, dict):
        return {k: _map_item(v, fn) for k, v in item.items()}
    if isinstance(item, (tuple, list)):
        return type(item)(_map_item(v, fn) for v in item)
    return fn(item) if _is_array(item) else item


def _tensors(item) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []

    def visit(a):
        if isinstance(a, torch.Tensor):
            out.append(a)
        return a

    _map_item(item, visit)
    return out


class ShardedDataSetIterator(DataSetIterator):
    """One process's shard of a base iterator for a multi-process input
    pipeline (SPMD). Every process runs the same global stream; batches
    are taken in groups of N consecutive batches and process p takes the
    p-th of each group, so every step exists on every process. Groups that
    are incomplete (the stream's tail) or whose batches differ in size (a
    short remainder) are dropped on every process alike, which keeps
    ParallelWrapper's equal-local-batch steps.

    ``process_index`` / ``process_count`` default to the default process
    group's rank and world size (0 and 1 without one); pass both for
    tests or custom layouts."""

    def __init__(self, base, process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        super().__init__(getattr(base, "batch_size", 32))
        if (process_index is None) != (process_count is None):
            raise ValueError("pass both process_index and process_count, or neither")
        self.base = base
        self._idx = process_index
        self._cnt = process_count

    def _coords(self):
        if self._idx is not None:
            return self._idx, self._cnt
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank(), dist.get_world_size()
        return 0, 1

    def _produce(self):
        p, n = self._coords()
        if not 0 <= p < n:
            raise ValueError(f"process_index {p} out of range for {n} processes")
        src = self.base() if callable(self.base) else self.base
        group: list = []
        for ds in src:
            group.append(ds)
            if len(group) == n:
                sizes = {len(b.features) if hasattr(b, "features") else len(b[0])
                         for b in group}
                if len(sizes) == 1:   # an equal-size group: safe on every process
                    yield group[p]
                group = []
        # a trailing incomplete group is dropped, on every process alike

    def reset(self):
        if hasattr(self.base, "reset"):
            self.base.reset()


def prefetch_to_device(iterable, depth: int = 2, device=None):
    """Generator: yield ``iterable``'s batches with their arrays already on
    ``device`` (the current CUDA device when None), copied by a background
    thread up to ``depth`` batches ahead.

    The producer blocks on a bounded queue, so at most ``depth`` batches
    are resident beyond the one in use; closing the generator early (break
    or ``.close()``) stops and joins the producer, and an error raised by
    the source reaches the consumer."""
    if depth < 1:
        raise ValueError(f"prefetch depth must be >= 1, got {depth}")
    dev = torch.device(device) if device is not None else torch.device(
        "cuda", torch.cuda.current_device())
    cuda = dev.type == "cuda"
    copy_stream = torch.cuda.Stream(device=dev) if cuda else None

    def put(a):
        t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
        if t.device == dev:
            return t
        if not cuda:
            return t.to(dev)
        if t.device.type == "cpu" and not t.is_pinned():
            t = t.pin_memory()
        return t.to(dev, non_blocking=True)

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    stop = threading.Event()
    err: List[BaseException] = []

    def worker():
        try:
            for item in iterable:
                if cuda:
                    with torch.cuda.stream(copy_stream):
                        item = _map_item(item, put)
                        ready = torch.cuda.Event()
                        ready.record(copy_stream)
                else:
                    item, ready = _map_item(item, put), None
                while not stop.is_set():
                    try:
                        q.put((item, ready), timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if stop.is_set():
                    return
        except BaseException as e:  # surface producer errors to the consumer
            err.append(e)
        finally:
            while not stop.is_set():
                try:
                    q.put(sentinel, timeout=0.1)
                    break
                except queue.Full:
                    continue

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            got = q.get()
            if got is sentinel:
                break
            item, ready = got
            if ready is not None:
                compute = torch.cuda.current_stream(dev)
                compute.wait_event(ready)
                for x in _tensors(item):
                    if x.device.type == "cuda":
                        x.record_stream(compute)
            yield item
    finally:
        stop.set()
        while True:  # unblock a producer stuck on a full queue
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=5)
    if err:
        raise err[0]
