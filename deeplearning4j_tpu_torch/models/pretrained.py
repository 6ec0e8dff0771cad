"""Pretrained-weight loading for zoo models (ZooModel.initPretrained parity;
PyTorch port of ``deeplearning4j_tpu/models/pretrained.py``).

Reference: zoo/ZooModel.java:40-52 — initPretrained(PretrainedType) resolves
a checkpoint URL, downloads into a local cache (~/.deeplearning4j), and
restores the model. This environment is air-gapped, so the cache IS the
contract: weights are resolved from ``$DL4J_TPU_HOME/models/<name>.zip``
(default ``~/.deeplearning4j_tpu``) or an explicit path, in any format
``utils/guesser.load_any`` understands (native zip, reference DL4J zip,
Keras h5).

Transplant semantics: parameters are copied per vertex/layer wherever the
name exists in both models with identical leaf shapes (the transfer-learning
scenario: a checkpoint with a different classifier head still loads the
backbone, and the mismatched head keeps its fresh initialization — this is
reported in the returned summary rather than silently).

The model is built on ``device`` (the GPU unless named; it raises without
one) and the checkpoint is read onto the same device.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch

from deeplearning4j_tpu_torch.utils.tree import tree_leaves, tree_map


def pretrained_cache_dir() -> str:
    root = os.environ.get("DL4J_TPU_HOME") or os.path.join(
        os.path.expanduser("~"), ".deeplearning4j_tpu")
    return os.path.join(root, "models")


def pretrained_path(name: str, cache_dir: Optional[str] = None) -> str:
    d = cache_dir or pretrained_cache_dir()
    p = os.path.join(d, f"{name}.zip")
    if not os.path.exists(p):
        raise FileNotFoundError(
            f"No cached weights for {name!r}: expected {p}. This build is "
            "air-gapped — place a checkpoint zip (native or DL4J format) "
            "there, or pass an explicit path.")
    return p


def _shapes_equal(a, b) -> bool:
    la = tree_leaves(a)
    lb = tree_leaves(b)
    return (len(la) == len(lb)
            and all(tuple(x.shape) == tuple(y.shape) for x, y in zip(la, lb)))


def _cast_like(src_tree, dst_tree):
    """Transplanted leaves take the DESTINATION dtype and device (a bf16
    config loading an f32 checkpoint must stay bf16 — mixed-dtype params
    break the step)."""
    return tree_map(lambda s, d: torch.as_tensor(s).to(device=d.device, dtype=d.dtype),
                    src_tree, dst_tree)


def init_pretrained(conf, weights: Optional[str] = None, *,
                    name: Optional[str] = None,
                    cache_dir: Optional[str] = None, device=None) -> Any:
    """Build a model from ``conf`` (a MultiLayerConfiguration or
    ComputationGraphConfiguration, e.g. a zoo constructor's output) and load
    pretrained parameters into it.

    ``weights``: explicit checkpoint path; otherwise resolved from the local
    cache via ``name``. Returns the initialized model; the transplant summary
    lives on ``model.pretrained_summary`` as
    {"loaded": [...], "skipped": [...]} of vertex/layer identifiers.
    """
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph, ComputationGraphConfiguration
    from deeplearning4j_tpu_torch.nn.model import MultiLayerNetwork
    from deeplearning4j_tpu_torch.utils.guesser import load_any

    if weights is None:
        if name is None:
            raise ValueError("init_pretrained needs `weights=` path or `name=`")
        weights = pretrained_path(name, cache_dir)

    src = load_any(weights, device=device)
    if not hasattr(src, "params"):
        raise ValueError(f"{weights!r} contains a bare configuration, not a model")

    if isinstance(conf, ComputationGraphConfiguration):
        model = ComputationGraph(conf, device=device).init()
        if not isinstance(src, ComputationGraph):
            raise ValueError(
                f"checkpoint is {type(src).__name__}, config is a ComputationGraph")
        loaded, skipped = [], []
        new_params = dict(model.params)
        new_state = dict(model.state)
        for vname in model.topo_order:
            if not tree_leaves(new_params[vname]):
                continue  # param-free vertex: neither loaded nor skipped
            if vname in src.params and _shapes_equal(src.params[vname], new_params[vname]):
                new_params[vname] = _cast_like(src.params[vname], new_params[vname])
                if vname in src.state and _shapes_equal(src.state[vname], new_state[vname]):
                    new_state[vname] = _cast_like(src.state[vname], new_state[vname])
                loaded.append(vname)
            else:
                skipped.append(vname)
        model.params, model.state = new_params, new_state
    else:
        model = MultiLayerNetwork(conf, device=device).init()
        if not isinstance(src, MultiLayerNetwork):
            raise ValueError(
                f"checkpoint is {type(src).__name__}, config is a MultiLayerNetwork")
        loaded, skipped = [], []
        new_params = list(model.params)
        new_state = list(model.state)
        for i in range(min(len(new_params), len(src.params))):
            if not tree_leaves(new_params[i]):
                continue
            if _shapes_equal(src.params[i], new_params[i]):
                new_params[i] = _cast_like(src.params[i], new_params[i])
                if _shapes_equal(src.state[i], new_state[i]):
                    new_state[i] = _cast_like(src.state[i], new_state[i])
                loaded.append(i)
            else:
                skipped.append(i)
        model.params, model.state = tuple(new_params), tuple(new_state)

    if not loaded:
        raise ValueError(
            f"init_pretrained: no layer of {weights!r} matched the config "
            "(wrong architecture?)")
    model.pretrained_summary = {"loaded": loaded, "skipped": skipped}
    return model
