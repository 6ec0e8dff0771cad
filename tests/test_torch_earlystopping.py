"""Early stopping (train/earlystopping.py) against the JAX package's on the
CPU: the same f32 network, data and configuration through both trainers —
the termination reason and details, the best epoch, the scores per epoch
and the best model's params — for every termination condition, both score
calculators and both model savers, on a MultiLayerNetwork and a
ComputationGraph."""

import math
import os

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.graph import ComputationGraphConfiguration as JGraphConf
from deeplearning4j_tpu.nn.input_type import InputType as JInputType
from deeplearning4j_tpu.nn.layers import Dense as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutputLayer
from deeplearning4j_tpu.nn.model import MultiLayerConfiguration as JConf
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JNetwork
from deeplearning4j_tpu.train import earlystopping as jes
from deeplearning4j_tpu_torch.interop import params_from_numpy, params_to_numpy
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph, ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration, MultiLayerNetwork
from deeplearning4j_tpu_torch.train import earlystopping as es
from deeplearning4j_tpu_torch.utils.tree import tree_leaves

# f32, a few epochs of SGD in two frameworks
F32 = dict(rtol=1e-4, atol=1e-5)


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


def _jconf(lr=0.5):
    return JConf(layers=(JDense(n_out=8, activation="tanh"),
                         JOutputLayer(n_out=3, activation="softmax")),
                 input_type=JInputType.feed_forward(4),
                 updater={"type": "sgd", "lr": lr}, seed=7)


def _pair(lr=0.5, graph=False):
    if graph:
        jconf = (JGraphConf.builder().add_inputs("in").set_input_types(JInputType.feed_forward(4))
                 .add_layer("h", JDense(n_out=8, activation="tanh"), "in")
                 .add_layer("out", JOutputLayer(n_out=3, activation="softmax"), "h")
                 .set_outputs("out").updater({"type": "sgd", "lr": lr}).seed(7).build())
        jm = JGraph(jconf).init()
        m = ComputationGraph(ComputationGraphConfiguration.from_json(jconf.to_json()),
                             device="cpu").init()
    else:
        jm = JNetwork(_jconf(lr)).init()
        m = MultiLayerNetwork(MultiLayerConfiguration.from_json(jm.conf.to_json()),
                              device="cpu").init()
    params_from_numpy(m, jax.tree_util.tree_map(np.asarray, jm.params))
    return jm, m


def _data(n=48, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 4).astype(np.float32)
    return x, np.eye(3, dtype=np.float32)[(x[:, 0] > 0).astype(int) + (x[:, 1] > 1)]


def _run(pkg, model, make_cfg, train, batch_size=16):
    return pkg.EarlyStoppingTrainer(make_cfg(pkg), model, train, batch_size=batch_size).fit()


def _compare(r, jr, best_params=True):
    assert r.termination_reason == jr.termination_reason
    assert r.termination_details == jr.termination_details
    assert r.best_model_epoch == jr.best_model_epoch
    assert r.total_epochs == jr.total_epochs
    assert sorted(r.score_vs_epoch) == sorted(jr.score_vs_epoch)
    for k in r.score_vs_epoch:
        np.testing.assert_allclose(r.score_vs_epoch[k], jr.score_vs_epoch[k], **F32)
    if math.isfinite(jr.best_model_score):
        np.testing.assert_allclose(r.best_model_score, jr.best_model_score, **F32)
    if best_params and jr.best_model is not None:
        for a, b in zip(tree_leaves(params_to_numpy(r.best_model)),
                        jax.tree_util.tree_leaves(jr.best_model.params)):
            np.testing.assert_allclose(a, np.asarray(b), **F32)


CASES = {
    "max_epochs": lambda pkg, val: pkg.EarlyStoppingConfiguration(
        epoch_termination_conditions=[pkg.MaxEpochsTerminationCondition(3)],
        score_calculator=pkg.DataSetLossCalculator(val, batch_size=16)),
    "patience": lambda pkg, val: pkg.EarlyStoppingConfiguration(
        epoch_termination_conditions=[pkg.MaxEpochsTerminationCondition(12),
                                      pkg.ScoreImprovementEpochTerminationCondition(
                                          patience=1, min_improvement=0.05)],
        score_calculator=pkg.DataSetLossCalculator(val)),
    "best_score": lambda pkg, val: pkg.EarlyStoppingConfiguration(
        epoch_termination_conditions=[pkg.MaxEpochsTerminationCondition(10),
                                      pkg.BestScoreEpochTerminationCondition(0.9)],
        score_calculator=pkg.DataSetLossCalculator(val), save_last_model=True),
    "accuracy": lambda pkg, val: pkg.EarlyStoppingConfiguration(
        epoch_termination_conditions=[pkg.MaxEpochsTerminationCondition(4)],
        score_calculator=pkg.ClassificationScoreCalculator(val), evaluate_every_n_epochs=2),
    "max_score": lambda pkg, val: pkg.EarlyStoppingConfiguration(
        epoch_termination_conditions=[pkg.MaxEpochsTerminationCondition(5)],
        iteration_termination_conditions=[pkg.MaxScoreIterationTerminationCondition(0.01)],
        score_calculator=pkg.DataSetLossCalculator(val)),
    "param_norm": lambda pkg, val: pkg.EarlyStoppingConfiguration(
        epoch_termination_conditions=[pkg.MaxEpochsTerminationCondition(6)],
        iteration_termination_conditions=[pkg.MaxParamNormIterationTerminationCondition(3.4)],
        score_calculator=pkg.DataSetLossCalculator(val)),
    "max_time": lambda pkg, val: pkg.EarlyStoppingConfiguration(
        epoch_termination_conditions=[pkg.MaxEpochsTerminationCondition(3)],
        iteration_termination_conditions=[pkg.MaxTimeIterationTerminationCondition(1e4),
                                          pkg.InvalidScoreIterationTerminationCondition()],
        score_calculator=pkg.DataSetLossCalculator(val)),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("graph", [False, True], ids=["mln", "graph"])
def test_early_stopping_matches_the_reference(case, graph):
    jm, m = _pair(graph=graph)
    train, val = _data(48, 0), _data(32, 1)
    jr = _run(jes, jm, lambda pkg: CASES[case](pkg, val), train)
    r = _run(es, m, lambda pkg: CASES[case](pkg, val), train)
    _compare(r, jr)


def test_invalid_score_stops_on_a_diverging_run():
    jm, m = _pair(lr=1e6)   # the loss overflows within an epoch
    train, val = _data(48, 0), _data(32, 1)
    make = lambda pkg: pkg.EarlyStoppingConfiguration(  # noqa: E731
        epoch_termination_conditions=[pkg.MaxEpochsTerminationCondition(5)],
        iteration_termination_conditions=[pkg.InvalidScoreIterationTerminationCondition(),
                                          pkg.MaxParamNormIterationTerminationCondition(1e3)],
        score_calculator=pkg.DataSetLossCalculator(val))
    with np.errstate(all="ignore"):
        jr = _run(jes, jm, make, train)
        r = _run(es, m, make, train)
    assert r.termination_reason == jr.termination_reason == "IterationTerminationCondition"
    assert r.termination_details == jr.termination_details
    assert r.best_model_epoch == jr.best_model_epoch


def test_local_file_saver_round_trip(tmp_path):
    jm, m = _pair()
    train, val = _data(48, 0), _data(32, 1)

    def make(pkg, d):
        return pkg.EarlyStoppingConfiguration(
            epoch_termination_conditions=[pkg.MaxEpochsTerminationCondition(3)],
            score_calculator=pkg.DataSetLossCalculator(val),
            model_saver=(pkg.LocalFileModelSaver(str(d), device="cpu") if pkg is es
                         else pkg.LocalFileModelSaver(str(d))),
            save_last_model=True)

    jr = jes.EarlyStoppingTrainer(make(jes, tmp_path / "j"), jm, train, batch_size=16).fit()
    r = es.EarlyStoppingTrainer(make(es, tmp_path / "p"), m, train, batch_size=16).fit()
    _compare(r, jr)
    assert sorted(os.listdir(tmp_path / "p")) == ["bestModel.zip", "latestModel.zip"]
    assert r.best_model.device.type == "cpu"
    latest = es.LocalFileModelSaver(str(tmp_path / "p"), device="cpu").get_latest_model()
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(latest.params),
                                                 tree_leaves(m.params)))
