"""Trainer CLI: ``python -m deeplearning4j_tpu_torch.train``.

Counterpart of ``python -m deeplearning4j_tpu.train`` (the reference's
ParallelWrapperMain): loads a model zip (native or DL4J), a Keras HDF5
file or a configuration JSON with ModelGuesser semantics (a
MultiLayerNetwork or a ComputationGraph), trains it on an ``.npz`` dataset
(arrays ``x`` and ``y``, optional ``fmask``/``lmask``) or a built-in
fetcher (``--dataset``: local archives under ``$DL4J_TPU_DATA``, else the
seeded synthetic surrogate) and writes a checkpoint zip in the format both
packages read. A graph with several inputs or outputs reads ``x0``,
``x1``, ... and ``y0``, ``y1``, ... in the order of its ``inputs`` and
``outputs`` instead (an extension of the JAX package's CLI, whose ``.npz``
holds one ``x`` and one ``y``).

Example::

    python -m deeplearning4j_tpu_torch.train conf.json \\
        --data train.npz --epochs 3 --batch-size 16 --output trained.zip
    python -m deeplearning4j_tpu_torch.train lenet.json --dataset mnist --epochs 1

Training runs on the GPU unless ``--device`` names another device
(``--device cpu`` runs the plain PyTorch path); with no GPU and no
``--device`` it raises. ``--data-parallel`` trains through
``ParallelWrapper`` over the default process group: a world of one without
``torchrun``'s environment, else ``RANK`` / ``WORLD_SIZE`` (and
``MASTER_ADDR`` / ``MASTER_PORT``) from it, NCCL on cards and gloo with
``--device cpu``; each rank passes its share of every batch (the rows
``rank::world`` of the batch), so the run equals the single-process fit,
and rank 0 writes the zip.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from deeplearning4j_tpu_torch.nn.graph import ComputationGraph, ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration, MultiLayerNetwork
from deeplearning4j_tpu_torch.train.listeners import ScoreIterationListener
from deeplearning4j_tpu_torch.utils.guesser import load_any
from deeplearning4j_tpu_torch.utils.serialization import save_network


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.train",
        description="Train a model from a config JSON or a model zip.")
    p.add_argument("model", help="configuration JSON (MultiLayerConfiguration or "
                   "ComputationGraphConfiguration), native or DL4J zip, or Keras h5")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--data", help=".npz file with arrays x and y "
                     "(optional fmask/lmask)")
    src.add_argument("--dataset", choices=["mnist", "emnist", "iris", "cifar10"],
                     help="built-in dataset fetcher")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--output", default="model.zip", help="checkpoint zip path")
    p.add_argument("--data-parallel", action="store_true",
                   help="data-parallel training over the default process group "
                        "(torchrun's RANK/WORLD_SIZE, else a world of one)")
    p.add_argument("--listener-frequency", type=int, default=10,
                   help="score print frequency (iterations)")
    p.add_argument("--evaluate", action="store_true",
                   help="run classification evaluation after training")
    p.add_argument("--device", default=None,
                   help="device to train on, e.g. cpu or cuda:1 (default: the GPU)")
    return p


def _load_model(path: str, device):
    obj = load_any(path, device=device)
    if isinstance(obj, MultiLayerConfiguration):
        return MultiLayerNetwork(obj, device=device).init()
    if isinstance(obj, ComputationGraphConfiguration):
        return ComputationGraph(obj, device=device).init()
    return obj  # already a model


def _arrays(d, name: str, path: str):
    """``name`` itself, or ``name0``, ``name1``, ... as a tuple."""
    if name in d:
        return d[name]
    n = 0
    while f"{name}{n}" in d:
        n += 1
    if n == 0:
        raise SystemExit(f"{path}: expected arrays 'x' and 'y' (or x0, x1, ... and "
                         f"y0, y1, ...), found {sorted(d.files)}")
    return tuple(d[f"{name}{i}"] for i in range(n))


def _load_npz(path: str):
    with np.load(path) as d:
        fmask = d["fmask"] if "fmask" in d else None
        lmask = d["lmask"] if "lmask" in d else None
        return (_arrays(d, "x", path), _arrays(d, "y", path), fmask, lmask)


def _load_data(args):
    """The ``.npz`` arrays, or the built-in fetcher's iterator (the JAX
    CLI's ``_load_data``)."""
    if args.data:
        return _load_npz(args.data)
    from deeplearning4j_tpu_torch import native
    from deeplearning4j_tpu_torch.datasets.fetchers import (
        CifarDataSetIterator, EmnistDataSetIterator, IrisDataSetIterator,
        MnistDataSetIterator)

    it = {"mnist": MnistDataSetIterator, "emnist": EmnistDataSetIterator,
          "iris": IrisDataSetIterator, "cifar10": CifarDataSetIterator}[
              args.dataset](batch_size=args.batch_size)
    print(f"dataset {args.dataset}: {it.total_examples()} examples, synthetic="
          f"{getattr(it, 'synthetic', False)}, native parses {dict(native.CALLS)}",
          flush=True)
    return it


def _join_group(device) -> bool:
    """Form the default process group for ``--data-parallel`` unless one
    exists: torchrun's environment when it is set, else a world of one over
    a private store. Returns whether it formed one (and so must leave it)."""
    import os
    import tempfile

    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel import init_distributed

    if dist.is_available() and dist.is_initialized():
        return False
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        init_distributed("env://", device=device)
    else:
        store = tempfile.mkdtemp(prefix="dl4j-dp-")
        init_distributed(f"file://{store}/store", 1, 0, device=device)
    return True


def _rank_rows(data, batch_size):
    """This rank's share of every batch: a callable giving, per epoch, the
    rows ``rank::world`` of each batch of ``batch_size`` rows (a world of
    one takes every row)."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.nn.model import _iter_batches

    rank, world = dist.get_rank(), dist.get_world_size()

    def epoch():
        source = data() if callable(data) else data
        for batch in _iter_batches(source, batch_size):
            yield tuple(a[rank::world] if a is not None else None for a in batch)

    return epoch


def run(argv=None):
    """Parse ``argv``, train, write the checkpoint (and evaluate with
    ``--evaluate``); returns the trained model."""
    args = build_parser().parse_args(argv)
    if not args.data_parallel:
        return _train(args)
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel import shutdown_distributed

    owned = _join_group(args.device)
    try:
        return _train(args, rank=dist.get_rank())
    finally:
        if owned:
            shutdown_distributed()


def _train(args, rank=None):
    """Load, train (data-parallel when ``rank`` is given) and write the zip
    (rank 0)."""
    model = _load_model(args.model, args.device)
    if not hasattr(model, "fit"):
        raise SystemExit(f"{args.model} does not contain a trainable model")
    model.set_listeners(ScoreIterationListener(args.listener_frequency))
    data = _load_data(args)
    if rank is not None:
        from deeplearning4j_tpu_torch.parallel import ParallelWrapper

        ParallelWrapper(model).fit(_rank_rows(data, args.batch_size), epochs=args.epochs)
    else:
        model.fit(data, epochs=args.epochs, batch_size=args.batch_size)
    if not rank:
        save_network(model, args.output)
        print(f"saved {args.output}")
    if args.evaluate:
        print(model.evaluate(data, batch_size=args.batch_size).stats())
    return model


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
