"""Device prefetch for the fit loops (PyTorch port of ``prefetch_to_device``
in ``deeplearning4j_tpu/datasets/iterator.py``).

A background thread copies each batch's arrays to the device ahead of the
step that uses them. On a CUDA device the copies run on a side stream from
page-locked host buffers, so batch N+1's copy overlaps batch N's compute;
the consumer's stream waits on the copy's event before it touches the
batch, and every copied tensor is ``record_stream``-ed on the consumer's
stream, so the caching allocator does not hand its memory to another
tensor while the step still reads it. On the CPU the batches become
tensors and nothing is copied. The iterator combinators of the reference
module wait for the data-path slice.
"""

from __future__ import annotations

import queue
import threading
from typing import List

import numpy as np
import torch

from deeplearning4j_tpu_torch.datasets.dataset import DataSet, MultiDataSet

__all__ = ["prefetch_to_device"]


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
