"""The Keras importer of the port (deeplearning4j_tpu_torch/modelimport/
keras.py) against the JAX package's on the CPU: every committed
``keras_*.h5`` fixture through both packages (parameter trees leaf-equal,
outputs against the golden and against each other), the HDF5-free route
(model-config JSON + weight dict), config-only import, and the
Unsupported / Invalid errors on the same inputs."""

import glob
import json
import os

import numpy as np
import pytest
import torch

import h5py

from deeplearning4j_tpu.modelimport import keras as jkeras
from deeplearning4j_tpu_torch.interop import params_to_numpy, state_to_numpy
from deeplearning4j_tpu_torch.modelimport import keras, model_from_config
from deeplearning4j_tpu_torch.nn.model import MultiLayerNetwork

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
FIXTURES = sorted(os.path.basename(p)[:-3] for p in glob.glob(os.path.join(FIX, "keras_*.h5")))
TOL = dict(rtol=1e-4, atol=1e-5)     # tests/test_modelimport_r3.py's golden tolerance


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


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return [_np(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def _assert_leaf_equal(got, want, where="tree"):
    got, want = _np(got), _np(want)
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), where
        for k in want:
            _assert_leaf_equal(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_leaf_equal(g, w, f"{where}[{i}]")
    else:
        assert got.shape == want.shape and got.dtype == want.dtype, where
        assert np.array_equal(got, want), where


def test_every_fixture_is_listed():
    assert len(FIXTURES) == 17


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_imports_leaf_equal_and_matches_golden(name):
    path = os.path.join(FIX, f"{name}.h5")
    io = np.load(os.path.join(FIX, f"{name}_io.npz"))
    jm = jkeras.KerasModelImport.import_keras_model(path)
    pm = keras.KerasModelImport.import_keras_model(path, device="cpu")
    assert type(pm).__name__ == type(jm).__name__
    assert pm.conf.to_dict() == jm.conf.to_dict()
    _assert_leaf_equal(params_to_numpy(pm), jm.params, "params")
    _assert_leaf_equal(state_to_numpy(pm), jm.state, "state")
    got = pm.output(io["x"]).numpy()
    np.testing.assert_allclose(got, io["y"], **TOL)
    np.testing.assert_allclose(got, np.asarray(jm.output(io["x"])), **TOL)


@pytest.mark.parametrize("name", ["keras_lstm", "keras_graph", "keras_cnn", "keras_gru"])
def test_config_and_weight_dict_route_equals_the_hdf5_route(name):
    """The conversion without the container: the file's model_config and
    its {layer: [arrays]} through model_from_config give the HDF5 entry
    point's model."""
    path = os.path.join(FIX, f"{name}.h5")
    with h5py.File(path, "r") as f:
        cfg = jkeras._model_config_from_h5(f)
        weights = jkeras._layer_weights_from_h5(f)
    via_h5 = keras.KerasModelImport.import_keras_model(path, device="cpu")
    via_dict = model_from_config(json.dumps(cfg), weights, device="cpu")
    assert via_dict.conf.to_dict() == via_h5.conf.to_dict()
    _assert_leaf_equal(via_dict.params, via_h5.params)
    _assert_leaf_equal(via_dict.state, via_h5.state)


@pytest.mark.parametrize("name", ["keras_lstm", "keras_cnn", "keras_deconv", "keras_shape_ops"])
def test_config_only_import_gives_the_same_configuration(name):
    with h5py.File(os.path.join(FIX, f"{name}.h5"), "r") as f:
        raw = f.attrs["model_config"]
    raw = raw.decode() if isinstance(raw, bytes) else raw
    got = keras.KerasModelImport.import_keras_sequential_configuration(raw)
    want = jkeras.KerasModelImport.import_keras_sequential_configuration(raw)
    assert got.to_dict() == want.to_dict()
    m = MultiLayerNetwork(got, device="cpu").init()
    assert m.num_params() > 0


def _seq(*layers, shape=(None, 7, 3)):
    return {"class_name": "Sequential", "config": {"layers": [
        {"class_name": "InputLayer", "config": {"batch_input_shape": list(shape)}},
        *layers]}}


BAD_CONFIGS = {
    "unknown_layer": (_seq({"class_name": "NoSuchLayer", "config": {"name": "x"}}),
                      "UnsupportedKerasConfigurationError"),
    "unknown_activation": (_seq({"class_name": "Dense", "config": {
        "units": 3, "activation": "no_such_activation"}}), "UnsupportedKerasConfigurationError"),
    "masking_then_dense": (_seq({"class_name": "Masking", "config": {"mask_value": 0.0}},
                                {"class_name": "Dense", "config": {"units": 4}},
                                {"class_name": "LSTM", "config": {"units": 5}}),
                           "UnsupportedKerasConfigurationError"),
    "empty_sequential": ({"class_name": "Sequential", "config": {"layers": []}},
                         "InvalidKerasConfigurationError"),
    "no_input_shape": ({"class_name": "Sequential", "config": {"layers": [
        {"class_name": "Dense", "config": {"units": 3}}]}}, "InvalidKerasConfigurationError"),
    "bad_padding": (_seq({"class_name": "Conv2D", "config": {
        "filters": 2, "kernel_size": 3, "padding": "causal"}}, shape=(None, 6, 6, 1)),
                    "UnsupportedKerasConfigurationError"),
}


@pytest.mark.parametrize("case", sorted(BAD_CONFIGS))
def test_errors_are_raised_for_the_same_inputs(case):
    cfg, err = BAD_CONFIGS[case]
    with pytest.raises(getattr(jkeras, err)):
        jkeras.KerasModelImport.import_keras_sequential_configuration(json.dumps(cfg))
    with pytest.raises(getattr(keras, err)):
        keras.KerasModelImport.import_keras_sequential_configuration(json.dumps(cfg))


def test_hdf5_errors_are_raised_for_the_same_files(tmp_path):
    bare = tmp_path / "no_config.h5"
    with h5py.File(bare, "w") as f:
        f.create_dataset("w", data=np.zeros(3))
    with pytest.raises(jkeras.InvalidKerasConfigurationError):
        jkeras.KerasModelImport.import_keras_model(str(bare))
    with pytest.raises(keras.InvalidKerasConfigurationError):
        keras.KerasModelImport.import_keras_model(str(bare), device="cpu")
    graph = os.path.join(FIX, "keras_graph.h5")
    with pytest.raises(keras.InvalidKerasConfigurationError, match="not a Sequential"):
        keras.KerasModelImport.import_keras_sequential_model_and_weights(graph, device="cpu")
    seq = os.path.join(FIX, "keras_lstm.h5")
    with pytest.raises(keras.InvalidKerasConfigurationError, match="Sequential model"):
        keras.KerasModelImport.import_keras_model_and_weights(seq, device="cpu")


def _char_rnn_config(H=8, vocab=5, T=6, recurrent_activation="sigmoid"):
    """The smoke's Keras char-RNN at a small width: LSTM x2 with
    return_sequences, then a per-step softmax Dense."""
    return {"class_name": "Sequential", "config": {"name": "charrnn", "layers": [
        {"class_name": "InputLayer", "config": {"batch_input_shape": [None, T, vocab],
                                                "name": "in"}},
        {"class_name": "LSTM", "config": {"name": "lstm_1", "units": H, "return_sequences": True,
                                          "recurrent_activation": recurrent_activation}},
        {"class_name": "LSTM", "config": {"name": "lstm_2", "units": H, "return_sequences": True,
                                          "recurrent_activation": recurrent_activation}},
        {"class_name": "Dense", "config": {"name": "out", "units": vocab,
                                           "activation": "softmax"}}]}}


def _char_rnn_weights(H=8, vocab=5, seed=0):
    rs = np.random.RandomState(seed)
    w = lambda *s: (rs.randn(*s) * 0.3).astype(np.float32)  # noqa: E731
    return {"lstm_1": [w(vocab, 4 * H), w(H, 4 * H), w(4 * H)],
            "lstm_2": [w(H, 4 * H), w(H, 4 * H), w(4 * H)],
            "out": [w(H, vocab), w(vocab)]}


@pytest.mark.parametrize("gate", ["sigmoid", "hard_sigmoid"])
def test_char_rnn_weight_dict_matches_the_jax_import(gate):
    """The smoke's Keras route at a small width: the JAX package's
    Sequential builder over the same config and weights gives the same
    params and output (sigmoid gates take the fused recurrence in both
    packages when H is a multiple of 128; hard_sigmoid the step loop)."""
    cfg, weights = _char_rnn_config(recurrent_activation=gate), _char_rnn_weights()
    pm = model_from_config(cfg, weights, device="cpu")
    jconf, names = jkeras._sequential_from_config(cfg)
    from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JMLN

    jm = JMLN(jconf).init()
    params, state = list(jm.params), list(jm.state)
    j = 0
    for i, layer in enumerate(jm.layers):
        if type(layer).__module__.endswith("preprocessors"):
            continue
        params[i], state[i] = jkeras._set_weights(layer, weights[names[j]], params[i], state[i])
        j += 1
    jm.params, jm.state = tuple(params), tuple(state)
    _assert_leaf_equal(params_to_numpy(pm), jm.params)
    x = np.eye(5, dtype=np.float32)[np.random.RandomState(1).randint(0, 5, (3, 6))]
    np.testing.assert_allclose(pm.output(x).numpy(), np.asarray(jm.output(x)), **TOL)


@pytest.mark.skipif(torch.cuda.is_available(), reason="the default device is the GPU here")
def test_import_without_a_gpu_and_without_device_raises():
    with pytest.raises(RuntimeError):
        keras.KerasModelImport.import_keras_model(os.path.join(FIX, "keras_lstm.h5"))
