"""The port's memory report (``deeplearning4j_tpu_torch/nn/memory.py``)
against the JAX package's: params and updater-state bytes equal for
MultiLayerNetwork and ComputationGraph under Adam, SGD and RMSProp; the
forward's output bytes equal and the training step's written bytes at most
OUTPUT_VS_XLA_BYTES below XLA's output bytes; the report never trains; a
TransformerLM's dummy input is int ids."""

import os

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn import memory as jmemory
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.graph import ComputationGraphConfiguration as JGraphConf
from deeplearning4j_tpu.nn.graph import MergeVertex as JMerge
from deeplearning4j_tpu.nn.input_type import InputType as JInputType
from deeplearning4j_tpu.nn.model import MultiLayerConfiguration as JConf
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JNetwork
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph, ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.memory import MemoryReport, memory_report
from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration, MultiLayerNetwork
from deeplearning4j_tpu_torch.utils.tree import tree_leaves

UPDATERS = {"adam": {"type": "adam", "lr": 1e-3}, "sgd": {"type": "sgd", "lr": 0.1},
            "rmsprop": {"type": "rmsprop", "lr": 1e-3}}
# XLA's step returns a few scalars besides what it writes (the step
# counter, the rng key, per-layer statistics): at most this many bytes
OUTPUT_VS_XLA_BYTES = 256


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


def _jmln(updater):
    return JConf(layers=(jl.Dense(n_out=32, activation="relu"),
                         jl.Dense(n_out=16, activation="tanh"),
                         jl.OutputLayer(n_out=5, activation="softmax")),
                 input_type=JInputType.feed_forward(12), seed=4, updater=updater)


def _jcg(updater):
    return (JGraphConf.builder().add_inputs("a", "b")
            .set_input_types(JInputType.feed_forward(6), JInputType.feed_forward(10))
            .add_layer("da", jl.Dense(n_out=8, activation="relu"), "a")
            .add_layer("db", jl.Dense(n_out=8, activation="relu"), "b")
            .add_vertex("m", JMerge(), "da", "db")
            .add_layer("out", jl.OutputLayer(n_out=3, activation="softmax"), "m")
            .set_outputs("out").seed(6).updater(updater).build())


def _state(model):
    return ([t.detach().clone() for t in tree_leaves(model.params)],
            None if model.opt_state is None else
            [t.detach().clone() for t in tree_leaves(model.opt_state)],
            model._gen.get_state().clone(), model.iteration)


def _same(a, b):
    eq = lambda x, y: (x is None and y is None) or (  # noqa: E731
        x is not None and y is not None and len(x) == len(y)
        and all(torch.equal(p, q) for p, q in zip(x, y)))
    return eq(a[0], b[0]) and eq(a[1], b[1]) and torch.equal(a[2], b[2]) and a[3] == b[3]


@pytest.mark.parametrize("kind", ["mln", "cg"])
@pytest.mark.parametrize("updater", sorted(UPDATERS))
def test_fixed_bytes_equal_the_jax_package(kind, updater):
    up = UPDATERS[updater]
    if kind == "mln":
        jconf = _jmln(up)
        jm = JNetwork(jconf).init()
        pm = MultiLayerNetwork(MultiLayerConfiguration.from_json(jconf.to_json()),
                               device="cpu").init()
    else:
        jconf = _jcg(up)
        jm = JGraph(jconf).init()
        pm = ComputationGraph(ComputationGraphConfiguration.from_json(jconf.to_json()),
                              device="cpu").init()
    want = jmemory.memory_report(jm, 8)
    before = _state(pm)
    got = memory_report(pm, 8)
    assert isinstance(got, MemoryReport) and got.model_class == want.model_class
    assert got.params_bytes == want.params_bytes
    assert got.opt_state_bytes == want.opt_state_bytes
    assert _same(_state(pm), before), "the report changed the model"
    extra = want.training["output_bytes"] - got.training["output_bytes"]
    assert 0 <= extra <= OUTPUT_VS_XLA_BYTES
    assert got.inference["output_bytes"] == want.inference["output_bytes"]
    assert got.training["temp_bytes"] > 0 and got.inference["temp_bytes"] > 0
    assert got.total_training_bytes() > got.total_inference_bytes()
    assert "MemoryReport: " in got.to_string()


def test_training_output_bytes_are_what_the_step_writes():
    m = MultiLayerNetwork(MultiLayerConfiguration.from_json(_jmln(UPDATERS["adam"]).to_json()),
                          device="cpu").init()
    x = np.random.RandomState(0).rand(16, 12).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[np.arange(16) % 5]
    m.fit((x, y), epochs=1, batch_size=8)           # the updater state exists now
    before = _state(m)
    r = memory_report(m, 8)
    nbytes = lambda t: sum(v.numel() * v.element_size() for v in tree_leaves(t))  # noqa: E731
    assert r.training["output_bytes"] == (nbytes(m.params) + nbytes(m.opt_state)
                                          + nbytes(m.state) + 4)
    assert r.opt_state_bytes == nbytes(m.opt_state)
    assert _same(_state(m), before)


def test_a_transformer_lm_reports_from_int_ids():
    conf = zoo.TransformerLM(vocab_size=40, max_len=8, d_model=16, n_heads=2, n_blocks=1)
    m = MultiLayerNetwork(conf, device="cpu").init()
    before = _state(m)
    r = memory_report(m, 4)
    jm = JNetwork(jzoo.TransformerLM(vocab_size=40, max_len=8, d_model=16, n_heads=2,
                                     n_blocks=1)).init()
    n = m.num_params()
    e = torch.tensor([], dtype=m.dtype).element_size()
    assert r.params_bytes == e * n == sum(a.size * a.dtype.itemsize for a in
                                          jax.tree_util.tree_leaves(jm.params))
    assert r.opt_state_bytes == 2 * 4 * n            # Adam's two f32 moments
    assert r.inference["output_bytes"] == 4 * 8 * 40 * e
    assert _same(_state(m), before) and m.opt_state is None
