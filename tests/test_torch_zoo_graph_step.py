"""One ResNet50 training step of the graph zoo on the CPU against the JAX
package (split from tests/test_torch_zoo_graph.py, whose helpers it uses,
so that the two files run on two test workers). Tolerance as stated at the
test."""

import os

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu_torch.interop import params_to_numpy, state_to_numpy
from test_torch_zoo_graph import _flat, _pair


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
