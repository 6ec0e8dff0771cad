"""The non-SGD solvers (train/solvers.py) against the JAX package's on the
CPU: the flat parameter order of ``ravel_pytree``, line gradient descent,
conjugate gradient and L-BFGS after 5 iterations from the same f32 params
and batch (loss and params), the tail padded up the bucket ladder, and
``fit`` dispatching on ``optimization_algo``. Plus ``check_gradients``
(utils/gradientcheck.py) in float64 on dense, conv, LSTM and graph nets,
and failing on a gradient that is wrong on purpose."""

import os

import numpy as np
import pytest
import torch

import jax
from jax.flatten_util import ravel_pytree

from deeplearning4j_tpu.nn.input_type import InputType as JInputType
from deeplearning4j_tpu.nn.layers import BatchNorm as JBatchNorm
from deeplearning4j_tpu.nn.layers import Dense as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutputLayer
from deeplearning4j_tpu.nn.model import MultiLayerConfiguration as JConf
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JNetwork
from deeplearning4j_tpu.train.solvers import Solver as JSolver
from deeplearning4j_tpu_torch.interop import params_from_numpy, params_to_numpy, state_from_numpy
from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph,
    ComputationGraphConfiguration,
    MergeVertex,
)
from deeplearning4j_tpu_torch.nn.input_type import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    Conv2D,
    Dense,
    GravesLSTM,
    OutputLayer,
    RnnOutputLayer,
    Subsampling2D,
)
from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration, MultiLayerNetwork
from deeplearning4j_tpu_torch.train.solvers import BackTrackLineSearch, Solver
from deeplearning4j_tpu_torch.utils import gradientcheck
from deeplearning4j_tpu_torch.utils.gradientcheck import check_gradients
from deeplearning4j_tpu_torch.utils.tree import tree_leaves

# f32, 5 solver iterations: the line search's comparisons may round
# differently near a tie, so losses and params are held to 1e-4
SOLVER_TOL = dict(rtol=1e-4, atol=1e-5)


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


def _jconf(algo="stochastic_gradient_descent"):
    return JConf(layers=(JDense(n_out=7, activation="tanh"), JBatchNorm(),
                         JDense(n_out=5, activation="sigmoid", l2=1e-3),
                         JOutputLayer(n_out=3, activation="softmax")),
                 input_type=JInputType.feed_forward(4), updater="sgd", seed=11,
                 optimization_algo=algo, solver_iterations=5)


def _pair(algo="stochastic_gradient_descent"):
    jm = JNetwork(_jconf(algo)).init()
    rs = np.random.RandomState(2)
    jm.state = tuple({k: jax.numpy.asarray(rs.uniform(0.5, 1.5, np.shape(v)), "float32")
                      for k, v in s.items()} for s in jm.state)
    m = MultiLayerNetwork(MultiLayerConfiguration.from_json(jm.conf.to_json()),
                          device="cpu").init()
    params_from_numpy(m, jax.tree_util.tree_map(np.asarray, jm.params))
    state_from_numpy(m, jax.tree_util.tree_map(np.asarray, jm.state))
    return jm, m


def _data(n=20, seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(n, 4).astype(np.float32),
            np.eye(3, dtype=np.float32)[rs.randint(0, 3, n)])


def test_flat_vector_follows_ravel_pytree_order():
    jm, m = _pair()
    flat_j, _ = ravel_pytree(jm.params)
    flat = torch.cat([p.reshape(-1) for p in tree_leaves(m.params)])
    np.testing.assert_array_equal(flat.numpy(), np.asarray(flat_j))
    s = Solver(m)
    back = s._unravel(flat)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back), tree_leaves(m.params)))


@pytest.mark.parametrize("algo", ["line_gradient_descent", "conjugate_gradient", "lbfgs"])
@pytest.mark.parametrize("n", [16, 20])   # 20 rows: padded to the 32 bucket
def test_solver_matches_the_reference_after_5_iterations(algo, n):
    jm, m = _pair()
    batch = _data(n)
    jloss = JSolver(jm, algo).optimize(batch, iterations=5)
    loss = Solver(m, algo).optimize(batch, iterations=5)
    np.testing.assert_allclose(loss, jloss, **SOLVER_TOL)
    for a, b in zip(tree_leaves(params_to_numpy(m)), jax.tree_util.tree_leaves(jm.params)):
        np.testing.assert_allclose(a, np.asarray(b), **SOLVER_TOL)


@pytest.mark.parametrize("algo", ["lbfgs", "conjugate_gradient"])
def test_fit_dispatches_on_optimization_algo(algo):
    jm, m = _pair(algo)
    x, y = _data(32)
    before = m.score((x, y))
    jm.fit((x, y), epochs=2, batch_size=16)
    m.fit((x, y), epochs=2, batch_size=16)
    assert m.iteration == jm.iteration == 4
    assert m.score((x, y)) < before
    np.testing.assert_allclose(m.score((x, y)), jm.score((x, y)), **SOLVER_TOL)
    assert m._solver is not None and m._solver.algorithm == algo


def test_unknown_algorithm_raises():
    with pytest.raises(ValueError):
        Solver(_pair()[1], "newton")


def test_line_search_rejects_an_ascent_direction():
    ls = BackTrackLineSearch()
    x = torch.zeros(3)
    g = torch.ones(3)
    assert ls.search(lambda v: float((v ** 2).sum()), x, 0.0, g, g) == (0.0, 0.0)


# -- gradient checks (float64, CPU) ---------------------------------------------------

def _net(layers, it):
    return MultiLayerNetwork(MultiLayerConfiguration(layers=layers, input_type=it, seed=4),
                             device="cpu").init()


def _gc_cases():
    rs = np.random.RandomState(0)
    eye = np.eye(3)
    return {
        "dense": (lambda: _net((Dense(n_out=5, activation="tanh"),
                                OutputLayer(n_out=3, activation="softmax", loss="mcxent")),
                               InputType.feed_forward(4)),
                  rs.rand(6, 4), eye[rs.randint(0, 3, 6)], None),
        "conv": (lambda: _net((Conv2D(n_out=2, kernel=(3, 3), activation="tanh"),
                               Subsampling2D(kernel=(2, 2), stride=(2, 2), pooling="max"),
                               OutputLayer(n_out=3, activation="softmax", loss="mcxent")),
                              InputType.convolutional(6, 6, 1)),
                 rs.rand(3, 6, 6, 1), eye[rs.randint(0, 3, 3)], 8),
        "lstm": (lambda: _net((GravesLSTM(n_out=3, activation="tanh"),
                               RnnOutputLayer(n_out=3, activation="softmax", loss="mcxent")),
                              InputType.recurrent(4, 5)),
                 rs.rand(2, 5, 4), eye[rs.randint(0, 3, (2, 5))], 8),
    }


@pytest.mark.parametrize("kind", ["dense", "conv", "lstm"])
def test_check_gradients_passes_in_float64(kind):
    make, x, y, subset = _gc_cases()[kind]
    assert check_gradients(make(), x, y, subset=subset)


def test_check_gradients_passes_on_a_graph():
    conf = (ComputationGraphConfiguration.builder().add_inputs("a", "b")
            .set_input_types(InputType.feed_forward(3), InputType.feed_forward(2))
            .add_layer("ha", Dense(n_out=4, activation="tanh"), "a")
            .add_layer("hb", Dense(n_out=4, activation="sigmoid"), "b")
            .add_vertex("m", MergeVertex(), "ha", "hb")
            .add_layer("out", OutputLayer(n_out=2, activation="softmax", loss="mcxent"), "m")
            .set_outputs("out").build())
    g = ComputationGraph(conf, device="cpu").init()
    rs = np.random.RandomState(1)
    assert check_gradients(g, (rs.rand(4, 3), rs.rand(4, 2)), np.eye(2)[rs.randint(0, 2, 4)])


def test_check_gradients_fails_on_a_wrong_gradient(monkeypatch):
    make, x, y, _ = _gc_cases()["dense"]
    real_grad = torch.autograd.grad

    def wrong(outputs, inputs, **kw):
        return tuple(None if g is None else g * 1.5 for g in real_grad(outputs, inputs, **kw))

    monkeypatch.setattr(gradientcheck.torch.autograd, "grad", wrong)
    assert not check_gradients(make(), x, y)
