"""The graph zoo on the CPU against the JAX package, at the small input
sizes of tests/test_zoo.py (ResNet50 at 32 x 32 with 5 classes): each of
the nine builders gives the same configuration JSON, the same output type
and the same parameter count as the JAX package's, one eval-mode forward
from the same weights matches, and one ResNet50 training step matches.

Tolerances: the eval forward within 1e-4 relative of the largest output
(f32, dozens of layers whose sums regroup); ResNet50's step as stated at
its test."""

import json
import os

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu import models as jmodels
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.graph import ComputationGraphConfiguration as JGraphConf
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JNetwork
from deeplearning4j_tpu_torch import models
from deeplearning4j_tpu_torch.interop import (
    params_from_numpy,
    params_to_numpy,
    state_from_numpy,
    state_to_numpy,
)
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph, ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration, MultiLayerNetwork


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


SMALL = [
    ("AlexNet", dict(height=63, width=63, num_classes=5)),
    ("VGG16", dict(height=32, width=32, num_classes=5)),
    ("VGG19", dict(height=32, width=32, num_classes=5)),
    ("ResNet50", dict(height=32, width=32, num_classes=5)),
    ("GoogLeNet", dict(height=64, width=64, num_classes=5)),
    ("Darknet19", dict(height=32, width=32, num_classes=5)),
    ("TinyYOLO", dict(height=64, width=64, num_classes=3)),
    ("InceptionResNetV1", dict(height=64, width=64, num_classes=5, n_blocks=(1, 1, 1))),
    ("FaceNetNN4Small2", dict(height=64, width=64, num_classes=5)),
]


def _flat(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}."))
    elif tree is not None:
        out[prefix.rstrip(".")] = np.asarray(tree)
    return out


def _pair(name, **kw):
    """(JAX model, port model) of one zoo builder with the same weights and
    BatchNorm state (running statistics from a numpy seed)."""
    jconf = getattr(jmodels, name)(**kw)
    if isinstance(jconf, JGraphConf):
        jm = JGraph(jconf).init()
        m = ComputationGraph(ComputationGraphConfiguration.from_json(jconf.to_json()),
                             device="cpu").init()
        rs = np.random.RandomState(3)
        jm.state = {k: ({"mean": np.float32(0.1) * rs.randn(*s["mean"].shape).astype(np.float32),
                         "var": rs.uniform(0.5, 1.5, s["var"].shape).astype(np.float32)}
                        if s else s) for k, s in jm.state.items()}
    else:
        jm = JNetwork(jconf).init()
        m = MultiLayerNetwork(MultiLayerConfiguration.from_json(jconf.to_json()),
                              device="cpu").init()
        rs = np.random.RandomState(3)
        jm.state = tuple({"mean": np.float32(0.1) * rs.randn(*s["mean"].shape).astype(np.float32),
                          "var": rs.uniform(0.5, 1.5, s["var"].shape).astype(np.float32)}
                         if s else s for s in jm.state)
    params_from_numpy(m, jax.tree_util.tree_map(np.asarray, jm.params))
    state_from_numpy(m, jax.tree_util.tree_map(np.asarray, jm.state))
    return jm, m


@pytest.mark.parametrize("name,kw", SMALL, ids=[n for n, _ in SMALL])
def test_zoo_builder_matches_jax(name, kw):
    jconf, conf = getattr(jmodels, name)(**kw), getattr(models, name)(**kw)
    assert json.loads(conf.to_json()) == json.loads(jconf.to_json())
    assert type(conf).__name__ == type(jconf).__name__
    jm, m = _pair(name, **kw)
    assert m.num_params() == jm.num_params()
    if isinstance(m, ComputationGraph):
        assert [t.to_dict() for t in m.output_types] == [t.to_dict() for t in jm.output_types]
        it = conf.input_types[conf.inputs[0]]
    else:
        assert m.output_type.to_dict() == jm.output_type.to_dict()
        it = conf.input_type
    x = np.random.RandomState(0).randn(2, it.height, it.width, 3).astype(np.float32)
    got, want = m.output(x).numpy(), np.asarray(jm.output(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


def test_resnet50_both_stems_match_jax():
    conf = models.ResNet50(height=32, width=32, num_classes=5, stem="space_to_depth")
    jconf = jmodels.ResNet50(height=32, width=32, num_classes=5, stem="space_to_depth")
    assert json.loads(conf.to_json()) == json.loads(jconf.to_json())
    assert "stem_s2d" in conf.vertices and "stem_s2d" not in models.ResNet50().vertices
    with pytest.raises(ValueError, match="stem"):
        models.ResNet50(stem="other")


def test_resnet50_training_step_matches_jax():
    """One SGD step of ResNet50 (32 x 32, 5 classes, batch 4) from the same
    weights, in float64 in both packages (JAX under ``jax.enable_x64``): the
    loss, every vertex's params after the update and the 53 BatchNorm
    running statistics, to 1e-9 relative. Float64 because in f32 this step
    is chaotic, not wrong: train-mode BatchNorm over 4 rows a channel
    magnifies the regrouped sums to ~1e-4 at the last stage, enough to flip
    a ReLU whose input is within 1e-5 of zero, and one flipped unit moves
    its channel's gradient, and every conv gradient behind it, by a few
    percent."""
    sgd = {"type": "sgd", "lr": 0.05}
    with jax.enable_x64(True):
        jm, m = _pair("ResNet50", height=32, width=32, num_classes=5, updater=sgd,
                      dtype="float64")
        rs = np.random.RandomState(1)
        x = rs.rand(4, 32, 32, 3)
        y = np.eye(5)[rs.randint(0, 5, 4)]
        jloss = float(jm.fit_batch(((x,), (y,), None, None)))
        loss = float(m.fit_batch((x, y)))
        want = _flat(jax.tree_util.tree_map(np.asarray, jm.params))
        ws = _flat(jax.tree_util.tree_map(np.asarray, jm.state))
    assert m.params["stem_conv"]["W"].dtype == torch.float64
    np.testing.assert_allclose(loss, jloss, rtol=1e-9)
    got, gs = _flat(params_to_numpy(m)), _flat(state_to_numpy(m))
    assert got.keys() == want.keys() and len(got) == 161
    assert gs.keys() == ws.keys() and len(gs) == 2 * 53
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9,
                                   atol=1e-9 * max(1.0, np.abs(want[k]).max()), err_msg=k)
    for k in ws:
        np.testing.assert_allclose(gs[k], ws[k], rtol=1e-9, atol=1e-9 * np.abs(ws[k]).max(),
                                   err_msg=k)
