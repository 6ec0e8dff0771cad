"""Transfer learning: surgery on trained networks (PyTorch port of
``nn/transfer.py``; TransferLearning.java, FineTuneConfiguration.java,
TransferLearningHelper.java).

Freezing is ``trainable=False`` on a layer config: the network gives that
layer the noop updater and asks autograd for no gradient of its params.
Params move by a shape-matched copy into a freshly built network on the
source network's device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph,
    ComputationGraphConfiguration,
    VertexSpec,
)
from deeplearning4j_tpu_torch.nn.model import (
    MultiLayerConfiguration,
    MultiLayerNetwork,
    _as_batch,
    _cast_mask,
)
from deeplearning4j_tpu_torch.utils.tree import tree_leaves, tree_map

__all__ = ["FineTuneConfiguration", "TransferLearning", "TransferLearningBuilder",
           "TransferLearningGraphBuilder", "TransferLearningHelper"]


@dataclass
class FineTuneConfiguration:
    """Overrides applied to every layer during surgery
    (FineTuneConfiguration.java); only the fields that are not None."""

    updater: Any = None
    seed: Optional[int] = None
    dropout: Optional[float] = None
    l1: Optional[float] = None
    l2: Optional[float] = None

    def apply_to_layer(self, layer):
        kw = {}
        if self.dropout is not None and hasattr(layer, "dropout"):
            kw["dropout"] = self.dropout
        if self.l1 is not None and hasattr(layer, "l1"):
            kw["l1"] = self.l1
        if self.l2 is not None and hasattr(layer, "l2"):
            kw["l2"] = self.l2
        return dataclasses.replace(layer, **kw) if kw else layer


def _tree_shapes_match(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb) or _structure(a) != _structure(b):
        return False
    return all(x.shape == y.shape and x.dtype == y.dtype for x, y in zip(la, lb))


def _structure(t):
    if isinstance(t, dict):
        return {k: _structure(v) for k, v in t.items()}
    if isinstance(t, (tuple, list)):
        return [_structure(v) for v in t]
    return None


def _copy(t):
    return tree_map(lambda x: x.detach().clone(), t)


class TransferLearning:
    """Entry point: ``TransferLearning.builder(mln)`` or
    ``TransferLearning.graph_builder(cg)``."""

    @staticmethod
    def builder(model: MultiLayerNetwork) -> "TransferLearningBuilder":
        return TransferLearningBuilder(model)

    @staticmethod
    def graph_builder(model: ComputationGraph) -> "TransferLearningGraphBuilder":
        return TransferLearningGraphBuilder(model)


class TransferLearningBuilder:
    """Sequential-model surgery (TransferLearning.Builder). Layer indices
    are those of the USER config (``conf.layers``), not of the resolved
    stack."""

    def __init__(self, model: MultiLayerNetwork):
        if model.params is None:
            raise ValueError("Transfer learning needs an initialized model")
        self._model = model
        self._layers: List[Any] = list(model.conf.layers)
        self._ftc: Optional[FineTuneConfiguration] = None
        self._freeze_until: Optional[int] = None
        self._reinit: set = set()  # indices whose params must NOT transfer

    def fine_tune_configuration(self, ftc: FineTuneConfiguration):
        self._ftc = ftc
        return self

    def set_feature_extractor(self, layer_idx: int):
        """Freeze layers 0..layer_idx inclusive (setFeatureExtractor)."""
        self._freeze_until = layer_idx
        return self

    def n_out_replace(self, layer_idx: int, n_out: int, weight_init: Any = None):
        """Change a layer's n_out; its params and the next layer's (whose
        n_in changes) are initialized afresh, even when n_out is unchanged
        (nOutReplace)."""
        layer = self._layers[layer_idx]
        kw: Dict[str, Any] = {"n_out": n_out}
        if weight_init is not None:
            kw["weight_init"] = weight_init
        self._layers[layer_idx] = dataclasses.replace(layer, **kw)
        self._reinit.add(layer_idx)
        if layer_idx + 1 < len(self._layers) and hasattr(self._layers[layer_idx + 1], "n_in"):
            # n_in re-infers from the new n_out
            self._layers[layer_idx + 1] = dataclasses.replace(
                self._layers[layer_idx + 1], n_in=None)
            self._reinit.add(layer_idx + 1)
        return self

    def remove_output_layer(self):
        self._layers.pop()
        return self

    def remove_layers_from_output(self, n: int):
        del self._layers[len(self._layers) - n:]
        return self

    def add_layer(self, layer):
        self._layers.append(layer)
        return self

    def build(self) -> MultiLayerNetwork:
        layers = list(self._layers)
        if self._freeze_until is not None:
            for i in range(min(self._freeze_until + 1, len(layers))):
                layers[i] = dataclasses.replace(layers[i], trainable=False)
        if self._ftc is not None:
            layers = [self._ftc.apply_to_layer(l) for l in layers]
        old = self._model.conf
        ftc = self._ftc
        conf = MultiLayerConfiguration(
            layers=tuple(layers), input_type=old.input_type,
            seed=ftc.seed if ftc and ftc.seed is not None else old.seed,
            updater=ftc.updater if ftc and ftc.updater is not None else old.updater,
            dtype=old.dtype, backprop_type=old.backprop_type,
            tbptt_fwd_length=old.tbptt_fwd_length, tbptt_back_length=old.tbptt_back_length)
        new = MultiLayerNetwork(conf, device=self._model.device).init()
        # resolved indices of the layers to initialize afresh (auto-inserted
        # preprocessors, tagged "pp_*", shift the config indices)
        no_transfer, cfg_i = set(), 0
        for r, l in enumerate(new.layers):
            if l._type_name.startswith("pp_"):
                continue
            if cfg_i in self._reinit:
                no_transfer.add(r)
            cfg_i += 1
        params, state = list(new.params), list(new.state)
        for i in range(min(len(params), len(self._model.params))):
            if i not in no_transfer and _tree_shapes_match(params[i], self._model.params[i]):
                params[i] = _copy(self._model.params[i])
                state[i] = _copy(self._model.state[i])
        new.params, new.state = tuple(params), tuple(state)
        return new


class TransferLearningGraphBuilder:
    """DAG surgery (TransferLearning.GraphBuilder): vertices by name,
    params transferred by name and shape."""

    def __init__(self, model: ComputationGraph):
        if model.params is None:
            raise ValueError("Transfer learning needs an initialized model")
        self._model = model
        self._vertices: Dict[str, VertexSpec] = dict(model.conf.vertices)
        self._outputs = list(model.conf.outputs)
        self._ftc: Optional[FineTuneConfiguration] = None
        self._frozen: set = set()

    def fine_tune_configuration(self, ftc: FineTuneConfiguration):
        self._ftc = ftc
        return self

    def set_feature_extractor(self, *vertex_names: str):
        """Freeze the named vertices and everything upstream of them."""
        frontier = list(vertex_names)
        while frontier:
            v = frontier.pop()
            if v in self._frozen or v not in self._vertices:
                continue
            self._frozen.add(v)
            frontier.extend(self._vertices[v].inputs)
        return self

    def n_out_replace(self, name: str, n_out: int, weight_init: Any = None):
        spec = self._vertices[name]
        kw: Dict[str, Any] = {"n_out": n_out}
        if weight_init is not None:
            kw["weight_init"] = weight_init
        self._vertices[name] = VertexSpec(dataclasses.replace(spec.config, **kw), spec.inputs)
        # direct consumers re-infer an explicit n_in
        for vname, vspec in list(self._vertices.items()):
            if (name in vspec.inputs and hasattr(vspec.config, "n_in")
                    and vspec.config.n_in is not None):
                self._vertices[vname] = VertexSpec(
                    dataclasses.replace(vspec.config, n_in=None), vspec.inputs)
        return self

    def remove_vertex(self, name: str, and_outputs: bool = False):
        self._vertices.pop(name)
        if and_outputs and name in self._outputs:
            self._outputs.remove(name)
        return self

    def add_layer(self, name: str, layer, *inputs: str):
        self._vertices[name] = VertexSpec(layer, tuple(inputs))
        return self

    def add_vertex(self, name: str, vertex, *inputs: str):
        self._vertices[name] = VertexSpec(vertex, tuple(inputs))
        return self

    def set_outputs(self, *names: str):
        self._outputs = list(names)
        return self

    def build(self) -> ComputationGraph:
        vertices: Dict[str, VertexSpec] = {}
        for name, spec in self._vertices.items():
            cfg = spec.config
            if name in self._frozen and any(
                    f.name == "trainable" for f in dataclasses.fields(cfg)):
                # param-free vertices (merge, elementwise, ...) have nothing
                # to freeze and no trainable field
                cfg = dataclasses.replace(cfg, trainable=False)
            if self._ftc is not None and hasattr(cfg, "dropout"):
                cfg = self._ftc.apply_to_layer(cfg)
            vertices[name] = VertexSpec(cfg, spec.inputs)
        old = self._model.conf
        conf = ComputationGraphConfiguration(
            inputs=old.inputs, input_types=old.input_types, vertices=vertices,
            outputs=tuple(self._outputs), seed=old.seed,
            updater=(self._ftc.updater if self._ftc and self._ftc.updater is not None
                     else old.updater),
            dtype=old.dtype)
        new = ComputationGraph(conf, device=self._model.device).init()
        for name in new.params:
            if name in self._model.params and _tree_shapes_match(
                    new.params[name], self._model.params[name]):
                new.params[name] = _copy(self._model.params[name])
                new.state[name] = _copy(self._model.state[name])
        return new


class TransferLearningHelper:
    """Featurize-once training of the unfrozen tail
    (TransferLearningHelper.java): the frozen front runs once over the
    data, then only the small unfrozen network trains."""

    def __init__(self, model: MultiLayerNetwork, frozen_till: int):
        """``frozen_till``: the last frozen USER layer index (inclusive)."""
        if model.params is None:
            raise ValueError("needs an initialized model")
        self._model = model
        # user layer index -> resolved index (auto-inserted preprocessors,
        # tagged "pp_*", shift it)
        resolved_idx, user_idx = -1, -1
        for i, l in enumerate(model.layers):
            if not l._type_name.startswith("pp_"):
                user_idx += 1
            if user_idx == frozen_till:
                resolved_idx = i
                break
        if resolved_idx < 0:
            raise ValueError(f"frozen_till={frozen_till} out of range")
        self._boundary = resolved_idx + 1
        sub_conf = MultiLayerConfiguration(
            layers=tuple(model.layers[self._boundary:]),
            input_type=(model.layer_input_types[self._boundary]
                        if self._boundary < len(model.layers) else model.output_type),
            seed=model.conf.seed, updater=model.conf.updater, dtype=model.conf.dtype)
        self._sub = MultiLayerNetwork(sub_conf, device=model.device).init()
        self._sub.params = tuple(_copy(p) for p in model.params[self._boundary:])
        self._sub.state = tuple(_copy(s) for s in model.state[self._boundary:])

    @property
    def unfrozen_network(self) -> MultiLayerNetwork:
        return self._sub

    def featurize(self, batch):
        """(x, y, ...) -> (features at the boundary, y, mask, lmask), the
        features and mask as tensors on the model's device."""
        x, y, fm, lm = _as_batch(batch)
        m = self._model
        with torch.no_grad():   # plain tensors: the tail trains on them
            a, _, _, mask, _ = m._forward(m.params, m.state, x, train=False,
                                          fmask=_cast_mask(fm, m.dtype, m.device),
                                          upto=self._boundary)
        return (a, y, mask, lm)

    def fit_featurized(self, featurized, epochs: int = 1, batch_size=None):
        """Train the unfrozen tail on featurized data, then write its params
        and state back into the full model."""
        self._sub.fit(featurized, epochs=epochs, batch_size=batch_size)
        n = len(self._model.params)
        self._model.params = self._model.params[:self._boundary] + tuple(
            _copy(p) for p in self._sub.params)
        self._model.state = self._model.state[:self._boundary] + tuple(
            _copy(s) for s in self._sub.state)
        assert len(self._model.params) == n
        return self._sub

    def output_from_featurized(self, features):
        return self._sub.output(features)
