"""Transfer learning on the CPU against the JAX package: freezing a
sequential network's front (the frozen layers keep their params through
``fit``), ``n_out_replace`` (the replaced layer and its successor start
afresh, the rest transfer), graph surgery that replaces a head and freezes
everything upstream of a vertex, ``FineTuneConfiguration``, and
``TransferLearningHelper.featurize`` / ``fit_featurized``. The same
surgery on the same weights must give the same network, params and
outputs in both packages (f32 within 1e-5)."""

import os

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.nn import graph as jg
from deeplearning4j_tpu.nn import transfer as jt
from deeplearning4j_tpu.nn.input_type import InputType as JInputType
from deeplearning4j_tpu.nn.layers import Dense as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutputLayer
from deeplearning4j_tpu.nn.model import MultiLayerConfiguration as JConf
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JNetwork
from deeplearning4j_tpu_torch.interop import params_from_numpy, params_to_numpy
from deeplearning4j_tpu_torch.nn import transfer as tl
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph, ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.layers import Dense, OutputLayer
from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration, MultiLayerNetwork

F32 = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    # another test module may leave tuning knobs (DL4J_TPU_GRAD_ACCUM, ...)
    # in os.environ; both packages' fit paths read them
    for k in list(os.environ):
        if k.startswith("DL4J_TPU_"):
            monkeypatch.delenv(k)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _np_tree(t):
    return jax.tree_util.tree_map(np.asarray, t)


def _mln_pair():
    jconf = JConf(layers=(JDense(n_out=6, activation="tanh"), JDense(n_out=5, activation="relu"),
                          JOutputLayer(n_out=3, activation="softmax")),
                  input_type=JInputType.feed_forward(4), updater={"type": "sgd", "lr": 0.1})
    jm = JNetwork(jconf).init()
    m = MultiLayerNetwork(MultiLayerConfiguration.from_json(jconf.to_json()), device="cpu").init()
    params_from_numpy(m, _np_tree(jm.params))
    return jm, m


def _graph_pair():
    jconf = (jg.ComputationGraphConfiguration.builder().add_inputs("in")
             .set_input_types(JInputType.feed_forward(4))
             .add_layer("h1", JDense(n_out=6, activation="tanh"), "in")
             .add_layer("h2", JDense(n_out=5, activation="relu"), "h1")
             .add_vertex("skip", jg.MergeVertex(), "h1", "h2")
             .add_layer("out", JOutputLayer(n_out=3, activation="softmax"), "skip")
             .set_outputs("out").updater({"type": "sgd", "lr": 0.1}).build())
    jm = jg.ComputationGraph(jconf).init()
    m = ComputationGraph(ComputationGraphConfiguration.from_json(jconf.to_json()),
                         device="cpu").init()
    params_from_numpy(m, _np_tree(jm.params))
    return jm, m


def _data(n=8, seed=0):
    rs = np.random.RandomState(seed)
    return rs.randn(n, 4).astype(np.float32), np.eye(3, dtype=np.float32)[rs.randint(0, 3, n)]


def _assert_same(got, want):
    got, want = _np_tree(got), _np_tree(want)
    gl, wl = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        np.testing.assert_allclose(a, b, **F32)


def test_feature_extractor_freezes_the_front_through_fit():
    jm, m = _mln_pair()
    x, y = _data()
    new = tl.TransferLearning.builder(m).set_feature_extractor(1).build()
    jnew = jt.TransferLearning.builder(jm).set_feature_extractor(1).build()
    assert [l.trainable for l in new.layers] == [False, False, True]
    frozen = [dict((k, v.clone()) for k, v in p.items()) for p in new.params[:2]]
    new.fit((x, y), epochs=3)
    jnew.fit((x, y), epochs=3)
    for p, f in zip(new.params[:2], frozen):
        assert all(torch.equal(p[k], f[k]) for k in f)
    assert not torch.equal(new.params[2]["W"], m.params[2]["W"])
    _assert_same(params_to_numpy(new), jnew.params)


def test_n_out_replace_reinitialises_the_layer_and_its_successor():
    jm, m = _mln_pair()
    new = tl.TransferLearning.builder(m).n_out_replace(1, 7).build()
    assert new.params[1]["W"].shape == (6, 7) and new.params[2]["W"].shape == (7, 3)
    assert torch.equal(new.params[0]["W"], m.params[0]["W"])
    # same n_out: still initialised afresh (the reference's nOutReplace)
    same = tl.TransferLearning.builder(m).n_out_replace(1, 5).build()
    assert not torch.equal(same.params[1]["W"], m.params[1]["W"])
    jnew = jt.TransferLearning.builder(jm).n_out_replace(1, 7).build()
    assert new.conf.to_dict() == jnew.conf.to_dict()


def test_fine_tune_configuration_and_layer_surgery():
    jm, m = _mln_pair()
    ftc = tl.FineTuneConfiguration(updater={"type": "adam", "lr": 1e-3}, l2=1e-4)
    jftc = jt.FineTuneConfiguration(updater={"type": "adam", "lr": 1e-3}, l2=1e-4)
    new = (tl.TransferLearning.builder(m).fine_tune_configuration(ftc)
           .remove_output_layer().add_layer(OutputLayer(n_out=2, activation="softmax")).build())
    jnew = (jt.TransferLearning.builder(jm).fine_tune_configuration(jftc)
            .remove_output_layer().add_layer(JOutputLayer(n_out=2, activation="softmax"))
            .build())
    assert new.conf.to_dict() == jnew.conf.to_dict()
    assert all(l.l2 == 1e-4 for l in new.conf.layers)
    _assert_same(params_to_numpy(new)[:2], jnew.params[:2])


def test_graph_head_replacement_and_freezing_match_jax():
    jm, m = _graph_pair()
    x, y2 = _data(8, 1)
    y = np.eye(2, dtype=np.float32)[y2.argmax(-1) % 2]
    new = (tl.TransferLearning.graph_builder(m).set_feature_extractor("h2")
           .remove_vertex("out", and_outputs=True)
           .add_layer("out2", OutputLayer(n_out=2, activation="softmax"), "skip")
           .set_outputs("out2").build())
    jnew = (jt.TransferLearning.graph_builder(jm).set_feature_extractor("h2")
            .remove_vertex("out", and_outputs=True)
            .add_layer("out2", JOutputLayer(n_out=2, activation="softmax"), "skip")
            .set_outputs("out2").build())
    assert new.conf.to_dict() == jnew.conf.to_dict()
    assert not new.rt["h1"].config.trainable and not new.rt["h2"].config.trainable
    # the new head starts from each package's own init: align it
    params_from_numpy(new, _np_tree(jnew.params))
    before = {k: v.clone() for k, v in new.params["h1"].items()}
    new.fit((x, y), epochs=2)
    jnew.fit((x, y), epochs=2)
    assert all(torch.equal(new.params["h1"][k], before[k]) for k in before)
    _assert_same(params_to_numpy(new), jnew.params)
    np.testing.assert_allclose(new.output(x).numpy(), np.asarray(jnew.output(x)), **F32)


def test_graph_n_out_replace_reinfers_consumers():
    jm, m = _graph_pair()
    new = tl.TransferLearning.graph_builder(m).n_out_replace("h2", 9).build()
    jnew = jt.TransferLearning.graph_builder(jm).n_out_replace("h2", 9).build()
    assert new.conf.to_dict() == jnew.conf.to_dict()
    assert new.params["h2"]["W"].shape == (6, 9)
    assert new.params["out"]["W"].shape == (15, 3)
    assert torch.equal(new.params["h1"]["W"], m.params["h1"]["W"])


def test_helper_featurize_and_fit_featurized_match_jax():
    jm, m = _mln_pair()
    x, y = _data(8, 2)
    helper, jhelper = tl.TransferLearningHelper(m, 0), jt.TransferLearningHelper(jm, 0)
    feats, jfeats = helper.featurize((x, y)), jhelper.featurize((x, y))
    assert tuple(feats[0].shape) == (8, 6)
    np.testing.assert_allclose(feats[0].numpy(), np.asarray(jfeats[0]), **F32)
    helper.fit_featurized(feats[:2], epochs=2)
    jhelper.fit_featurized(jfeats[:2], epochs=2)
    _assert_same(params_to_numpy(m), jm.params)
    np.testing.assert_allclose(helper.output_from_featurized(feats[0]).numpy(),
                               np.asarray(jhelper.output_from_featurized(jfeats[0])), **F32)
    np.testing.assert_allclose(m.output(x).numpy(), np.asarray(jm.output(x)), **F32)
    with pytest.raises(ValueError, match="out of range"):
        tl.TransferLearningHelper(m, 7)


def test_unfrozen_dense_layer_keeps_its_class():
    _, m = _mln_pair()
    new = tl.TransferLearning.builder(m).set_feature_extractor(0).build()
    assert isinstance(new.layers[1], Dense) and new.layers[1].trainable
