"""The evaluations the port copies from the JAX package (eval/regression,
roc, binary, calibration, serde) fed the same arrays in both packages:
their metrics, their merges and their JSON, byte for byte; and the models'
``evaluate_regression`` / ``evaluate_roc`` against the JAX package's from
the same f32 params (predictions within 1e-5, so the metrics agree to
1e-4)."""

import json
import os

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu import eval as jev
from deeplearning4j_tpu.nn.input_type import InputType as JInputType
from deeplearning4j_tpu.nn.layers import Dense as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutputLayer
from deeplearning4j_tpu.nn.model import MultiLayerConfiguration as JConf
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JNetwork
from deeplearning4j_tpu_torch import eval as ev
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.interop import params_from_numpy
from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration, MultiLayerNetwork

# model predictions in two frameworks (f32 sums in other orders)
PRED = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith("DL4J_TPU_"):
            monkeypatch.delenv(k)


def test_exports_match_the_reference():
    assert sorted(ev.__all__) == sorted(jev.__all__)


def _arrays(seed=0, n=64, k=3):
    rs = np.random.RandomState(seed)
    logits = rs.randn(n, k)
    probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    onehot = np.eye(k)[rs.randint(0, k, n)]
    binary = (rs.rand(n, k) > 0.5).astype(np.float64)
    mask = (rs.rand(n, k) > 0.2).astype(np.float64)
    reg_y, reg_p = rs.randn(n, k), rs.randn(n, k)
    return dict(probs=probs, onehot=onehot, binary=binary, mask=mask, sig=rs.rand(n, k),
                reg_y=reg_y, reg_p=reg_p, b1=rs.randint(0, 2, (n, 1)).astype(np.float64),
                p1=rs.rand(n, 1))


def _feed(pkg, name, a):
    """One evaluation of ``name`` from package ``pkg`` fed two halves of
    the arrays and merged with a third, as workers would."""
    def make():
        return {"regression": lambda: pkg.RegressionEvaluation(),
                "regression_masked": lambda: pkg.RegressionEvaluation(),
                "roc": lambda: pkg.ROC(50), "roc_exact": lambda: pkg.ROC(0),
                "roc_binary": lambda: pkg.ROCBinary(20),
                "roc_multiclass": lambda: pkg.ROCMultiClass(20),
                "binary": lambda: pkg.EvaluationBinary(),
                "calibration": lambda: pkg.EvaluationCalibration(10)}[name]()

    def feed(e, s):
        if name == "regression":
            e.eval(a["reg_y"][s], a["reg_p"][s])
        elif name == "regression_masked":
            e.eval(a["reg_y"][s], a["reg_p"][s], mask=a["mask"][s][:, 0])   # a row mask
        elif name in ("roc", "roc_exact"):
            e.eval(a["b1"][s], a["p1"][s])
        elif name == "roc_binary":
            e.eval(a["binary"][s], a["sig"][s], mask=a["mask"][s])
        elif name == "roc_multiclass":
            e.eval(a["onehot"][s], a["probs"][s])
        elif name == "binary":
            e.eval(a["binary"][s], a["sig"][s], mask=a["mask"][s])
        else:
            e.eval(a["onehot"][s], a["probs"][s])

    e1, e2 = make(), make()
    feed(e1, slice(0, 40))
    feed(e2, slice(40, None))
    e1.merge(e2)
    return e1


METRICS = {
    "regression": lambda e: [e.mean_squared_error(), e.mean_absolute_error(),
                             e.root_mean_squared_error(), e.relative_squared_error(),
                             e.pearson_correlation(), e.r_squared(), e.r_squared(1)],
    "roc": lambda e: [e.calculate_auc(), e.calculate_auprc()],
    "roc_binary": lambda e: [e.calculate_auc(0), e.calculate_average_auc()],
    "roc_multiclass": lambda e: [e.calculate_auc(1), e.calculate_average_auc()],
    "binary": lambda e: [e.accuracy(0), e.precision(1), e.recall(2), e.f1(0),
                         e.average_accuracy(), e.average_f1()],
    "calibration": lambda e: [e.expected_calibration_error(0),
                              *np.ravel(e.reliability_diagram(1)[0])],
}
METRICS["regression_masked"] = METRICS["regression"]
METRICS["roc_exact"] = METRICS["roc"]


@pytest.mark.parametrize("name", sorted(METRICS))
def test_evaluations_and_their_json_match_the_reference(name):
    a = _arrays()
    mine, ref = _feed(ev, name, a), _feed(jev, name, a)
    np.testing.assert_array_equal(np.asarray(METRICS[name](mine), np.float64),
                                  np.asarray(METRICS[name](ref), np.float64))
    js, jjs = ev.to_json(mine), jev.to_json(ref)
    assert json.loads(js) == json.loads(jjs)
    back = ev.from_json(jjs)            # the reference's JSON read by the port
    assert type(back).__name__ == type(mine).__name__
    np.testing.assert_array_equal(np.asarray(METRICS[name](back), np.float64),
                                  np.asarray(METRICS[name](mine), np.float64))
    assert type(mine).from_json(mine.to_json()).to_json() == js
    if hasattr(mine, "stats"):
        assert mine.stats() == ref.stats()


def _pair(out_act, loss, n_out):
    jconf = JConf(layers=(JDense(n_out=6, activation="tanh"),
                          JOutputLayer(n_out=n_out, activation=out_act, loss=loss)),
                  input_type=JInputType.feed_forward(4), seed=2)
    jm = JNetwork(jconf).init()
    m = MultiLayerNetwork(MultiLayerConfiguration.from_json(jconf.to_json()),
                          device="cpu").init()
    params_from_numpy(m, jax.tree_util.tree_map(np.asarray, jm.params))
    return jm, m


def test_evaluate_regression_matches_the_reference():
    jm, m = _pair("identity", "mse", 2)
    rs = np.random.RandomState(4)
    x, y = rs.randn(40, 4).astype(np.float32), rs.randn(40, 2).astype(np.float32)
    r, jr = m.evaluate_regression((x, y), batch_size=16), jm.evaluate_regression((x, y), 16)
    np.testing.assert_allclose(METRICS["regression"](r), METRICS["regression"](jr), **PRED)
    r2 = m.evaluate_regression(DataSet(x, y), batch_size=16)
    assert r2.to_json() == r.to_json()


def test_evaluate_roc_matches_the_reference():
    jm, m = _pair("sigmoid", "xent", 1)
    rs = np.random.RandomState(5)
    x = rs.randn(48, 4).astype(np.float32)
    y = (x[:, :1] > 0).astype(np.float32)
    r, jr = m.evaluate_roc((x, y), batch_size=16), jm.evaluate_roc((x, y), 16)
    np.testing.assert_allclose(METRICS["roc"](r), METRICS["roc"](jr), **PRED)
    r0, jr0 = m.evaluate_roc((x, y), num_bins=0), jm.evaluate_roc((x, y), num_bins=0)
    np.testing.assert_allclose(r0.calculate_auc(), jr0.calculate_auc(), **PRED)
    # labels as a tensor on the model's device
    r1 = m.evaluate_roc((torch.as_tensor(x), torch.as_tensor(y)), batch_size=16)
    assert r1.to_json() == r.to_json()
