"""Carry parameters and layer state between the JAX package and the port as
numpy trees.

The JAX package's params are a tuple of per-layer dicts (nested for
TransformerBlock's ``attn``/``ln1``/``ln2``) for a MultiLayerNetwork and a
dict ``{vertex_name: layer params}`` for a ComputationGraph; the port keeps
the same names, shapes and layouts. ``jax.tree_util.tree_map(np.asarray,
jax_model.params)`` therefore loads here with :func:`params_from_numpy`,
and :func:`params_to_numpy` gives it back. Layer state (BatchNorm's f32
running ``mean`` and ``var``) goes the same way with
:func:`state_from_numpy` and :func:`state_to_numpy`.

bf16: JAX exports bfloat16 leaves as ``ml_dtypes.bfloat16`` numpy arrays,
which ``torch.from_numpy`` rejects. They go through float32 — exact, since
every bf16 value is a float32 value — and are cast to the model dtype on
the device. :func:`params_to_numpy` returns bf16 leaves as float32 arrays
for the same reason.

The embedding models (``nlp/embeddings.py`` SequenceVectors and its
subclasses, ``graph/deepwalk.py`` DeepWalk, ``nlp/glove.py`` Glove) keep a
flat dict of tables: ``syn0``, ``syn1neg`` (and ``syn1`` with hierarchical
softmax) for SequenceVectors, ``syn0`` and ``syn1`` for DeepWalk, ``W``,
``Wc``, ``b``, ``bc`` and the AdaGrad accumulators ``hW``, ``hWc``, ``hb``,
``hbc`` for Glove — the JAX package's names and shapes.
:func:`embeddings_from_numpy` loads such a dict into a port model and
:func:`embeddings_to_numpy` gives it back.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["embeddings_from_numpy", "embeddings_to_numpy", "params_from_numpy",
           "params_to_numpy", "state_from_numpy", "state_to_numpy"]


def _to_tensor(a, like: torch.Tensor, where: str) -> torch.Tensor:
    a = np.asarray(a)
    if tuple(a.shape) != tuple(like.shape):
        raise ValueError(f"{where}: shape {a.shape} != expected {tuple(like.shape)}")
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a)).to(device=like.device, dtype=like.dtype)


def _load(tree, like, where: str):
    if isinstance(like, dict):
        if not isinstance(tree, dict) or set(tree) != set(like):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"{where}: keys {got} != expected {sorted(like)}")
        return {k: _load(tree[k], like[k], f"{where}.{k}") for k in like}
    if isinstance(like, (tuple, list)):
        if not isinstance(tree, (tuple, list)) or len(tree) != len(like):
            raise ValueError(f"{where}: {len(like)} entries expected")
        return type(like)(_load(t, x, f"{where}[{i}]")
                          for i, (t, x) in enumerate(zip(tree, like)))
    return _to_tensor(tree, like, where)


def _load_layers(model, attr: str, tree):
    if model.params is None:
        model.init()
    have = getattr(model, attr)
    if isinstance(have, dict):   # a ComputationGraph: keyed by vertex name
        setattr(model, attr, _load(dict(tree), have, f"graph {attr}"))
        return model
    if len(tree) != len(have):
        raise ValueError(f"{len(tree)} layer {attr} dicts for a model of "
                         f"{len(have)} layers")
    setattr(model, attr, tuple(_load(t, p, f"layer {i} {attr}")
                               for i, (t, p) in enumerate(zip(tree, have))))
    return model


def params_from_numpy(model, tree):
    """Load a tuple of per-layer dicts of numpy arrays (a
    MultiLayerNetwork's) or a dict of per-vertex dicts (a
    ComputationGraph's) into ``model``'s
    params (keys and shapes must match the model's own layout; values are
    cast to the model dtype on its device). Initialises the model first if
    it has no params yet. Returns the model."""
    return _load_layers(model, "params", tree)


def state_from_numpy(model, tree):
    """Load a tuple of per-layer dicts (or a graph's dict of per-vertex
    dicts) of numpy arrays into ``model``'s layer state (the same keys and shapes; each leaf keeps the dtype of
    the model's own state, f32 for BatchNorm). Returns the model."""
    return _load_layers(model, "state", tree)


def _dump(p):
    if isinstance(p, dict):
        return {k: _dump(v) for k, v in p.items()}
    if isinstance(p, (tuple, list)):
        return type(p)(_dump(v) for v in p)
    t = p.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def params_to_numpy(model):
    """``model``'s params as numpy arrays in its own tree (a tuple of
    per-layer dicts, or a graph's dict of per-vertex dicts; bf16 as
    float32)."""
    return _dump(model.params) if isinstance(model.params, dict) else tuple(
        _dump(p) for p in model.params)


def state_to_numpy(model):
    """``model``'s layer state as numpy arrays in its own tree."""
    return _dump(model.state) if isinstance(model.state, dict) else tuple(
        _dump(s) for s in model.state)


def embeddings_from_numpy(model, tables):
    """Load a dict of numpy tables (``{"syn0": ..., "syn1neg": ...}``, a
    DeepWalk's ``syn0``/``syn1``, a Glove's eight arrays) into an embedding
    model's params: the keys and shapes must be the model's own, each table
    keeps the model's dtype and device. The model must have its params
    already (``build_vocab`` and ``_init_params``, ``initialize(graph)`` or
    a ``fit``). Returns the model."""
    if model.params is None:
        raise ValueError("the model has no params yet: build its vocab and "
                         "initialise it (or fit it) first")
    model.params = _load(dict(tables), model.params, "embeddings")
    return model


def embeddings_to_numpy(model) -> dict:
    """An embedding model's tables as a dict of numpy arrays (the inverse
    of :func:`embeddings_from_numpy`)."""
    return _dump(model.params)
