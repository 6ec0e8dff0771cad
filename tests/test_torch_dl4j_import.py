"""The DL4J zip importer and exporter of the port (deeplearning4j_tpu_torch/
modelimport/dl4j.py) against the JAX package's on the CPU: the ND4J byte
stream, the committed fixtures, and zips written by either package and read
by the other (params and layer state through ``interop.params_to_numpy``
/ ``state_to_numpy``, and Adam moments, leaf for leaf), for a GravesLSTM
with peepholes, a CNN with a dense layer after the conv and a small
residual ComputationGraph."""

import io
import json
import os
import zipfile

import numpy as np
import pytest
import torch

import jax

import deeplearning4j_tpu.nn.graph as jg
from deeplearning4j_tpu.modelimport import dl4j as jdl4j
from deeplearning4j_tpu.nn.input_type import InputType as JInputType
from deeplearning4j_tpu.nn.layers import (
    BatchNorm as JBatchNorm,
    Conv2D as JConv2D,
    Dense as JDense,
    GravesLSTM as JGravesLSTM,
    OutputLayer as JOutputLayer,
    RnnOutputLayer as JRnnOutputLayer,
    Subsampling2D as JSubsampling2D,
)
from deeplearning4j_tpu.nn.model import (
    MultiLayerConfiguration as JMLC,
    MultiLayerNetwork as JMLN,
)
from deeplearning4j_tpu_torch.interop import params_to_numpy, state_to_numpy
from deeplearning4j_tpu_torch.modelimport import dl4j
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
GOLDEN_TOL = dict(rtol=1e-5, atol=1e-6)    # tests/test_dl4j_import.py's
OUT_TOL = dict(rtol=1e-5, atol=1e-6)


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
    """Any tree of jax arrays / tensors / arrays as nested numpy (tuples and
    lists alike become lists)."""
    if tree is None:
        return None
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
        assert isinstance(got, dict) and set(got) == set(want), (where, got, want)
        for k in want:
            _assert_leaf_equal(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_leaf_equal(g, w, f"{where}[{i}]")
    else:
        assert got.shape == want.shape and got.dtype == want.dtype, (where, got.shape,
                                                                    want.shape)
        assert np.array_equal(got, want), where


def _entries(path):
    with zipfile.ZipFile(path) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


# -- the ND4J DataBuffer stream ---------------------------------------------

@pytest.mark.parametrize("shape,dtype", [((7,), "FLOAT"), ((3, 5), "FLOAT"),
                                         ((2, 3, 4), "DOUBLE"), ((4, 2), "INT"),
                                         ((6,), "LONG")])
def test_nd4j_stream_is_byte_equal(shape, dtype):
    rs = np.random.RandomState(3)
    a = (rs.randn(*shape) * 100).astype({"FLOAT": np.float32, "DOUBLE": np.float64,
                                         "INT": np.int32, "LONG": np.int64}[dtype])
    mine, theirs = io.BytesIO(), io.BytesIO()
    dl4j.write_nd4j(mine, a, dtype)
    jdl4j.write_nd4j(theirs, a, dtype)
    assert mine.getvalue() == theirs.getvalue()
    back = dl4j.read_nd4j(io.BytesIO(theirs.getvalue()))
    want = jdl4j.read_nd4j(io.BytesIO(theirs.getvalue()))
    assert back.dtype == want.dtype and np.array_equal(back, want)


def test_nd4j_reader_takes_f_order_and_rejects_offsets():
    a = np.arange(12, dtype=np.float32).reshape(3, 4)
    buf = io.BytesIO()
    # an F-order [3, 4] array: strides (1, 3), order char 'f'
    jdl4j.write_databuffer(buf, np.asarray([2, 3, 4, 1, 3, 0, 1, ord("f")], np.int32), "INT")
    jdl4j.write_databuffer(buf, a.ravel(order="F"), "FLOAT")
    got = dl4j.read_nd4j(io.BytesIO(buf.getvalue()))
    assert np.array_equal(got, a)
    bad = io.BytesIO()
    jdl4j.write_databuffer(bad, np.asarray([2, 3, 4, 4, 1, 5, 1, ord("c")], np.int32), "INT")
    jdl4j.write_databuffer(bad, a.ravel(), "FLOAT")
    with pytest.raises(ValueError, match="offset"):
        dl4j.read_nd4j(io.BytesIO(bad.getvalue()))


# -- the committed fixtures ---------------------------------------------------

@pytest.mark.parametrize("name", ["dl4j_cnn_tiny", "dl4j_cg_tiny"])
def test_committed_fixture_imports_leaf_equal_and_matches_golden(name):
    zpath = os.path.join(FIXDIR, f"{name}.zip")
    g = np.load(os.path.join(FIXDIR, f"{name}_golden.npz"))
    jm = jdl4j.import_dl4j_zip(zpath)
    pm = dl4j.import_dl4j_zip(zpath, device="cpu")
    assert type(pm).__name__ == type(jm).__name__
    assert pm.weights_imported is True and pm.iteration == jm.iteration
    _assert_leaf_equal(params_to_numpy(pm), jm.params, "params")
    _assert_leaf_equal(state_to_numpy(pm), jm.state, "state")
    got = pm.output(g["x"]).numpy()
    np.testing.assert_allclose(got, g["y"], **GOLDEN_TOL)
    np.testing.assert_allclose(got, np.asarray(jm.output(g["x"])), **GOLDEN_TOL)


# -- zips written by either package ------------------------------------------

def _graves():
    conf = JMLC(layers=(JGravesLSTM(n_out=8, activation="tanh"),
                        JRnnOutputLayer(n_out=5, activation="softmax", loss="mcxent")),
                input_type=JInputType.recurrent(6), updater={"type": "adam", "lr": 1e-2})
    rs = np.random.RandomState(0)
    x = rs.randn(4, 7, 6).astype(np.float32)
    y = np.eye(5, dtype=np.float32)[rs.randint(0, 5, (4, 7))]
    return JMLN(conf).init(), x, y


def _cnn():
    conf = JMLC(layers=(JConv2D(n_out=4, kernel=(3, 3), activation="relu"),
                        JSubsampling2D(kernel=(2, 2), stride=(2, 2)),
                        JDense(n_out=8, activation="tanh"),
                        JOutputLayer(n_out=3, activation="softmax", loss="mcxent")),
                input_type=JInputType.convolutional(8, 8, 2),
                updater={"type": "adam", "lr": 1e-2})
    rs = np.random.RandomState(1)
    x = rs.rand(4, 8, 8, 2).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 4)]
    return JMLN(conf).init(), x, y


def _residual_cg():
    conf = (jg.ComputationGraphConfiguration.builder()
            .add_inputs("in")
            .set_input_types(JInputType.feed_forward(6))
            .add_layer("h", JDense(n_out=8, activation="tanh"), "in")
            .add_layer("bn", JBatchNorm(), "h")
            .add_layer("b1", JDense(n_out=8, activation="relu"), "bn")
            .add_layer("b2", JDense(n_out=8, activation="identity"), "b1")
            .add_vertex("add", jg.ElementWiseVertex(op="add"), "b2", "h")
            .add_layer("out", JOutputLayer(n_out=3, activation="softmax", loss="mcxent"), "add")
            .set_outputs("out").updater({"type": "adam", "lr": 1e-2}).build())
    rs = np.random.RandomState(2)
    x = rs.randn(8, 6).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rs.randint(0, 3, 8)]
    return jg.ComputationGraph(conf).init(), x, y


MODELS = {"graves_lstm": _graves, "cnn_dense_after_conv": _cnn, "residual_cg": _residual_cg}


def _trained(name):
    """A JAX model after 2 Adam steps (non-zero moments, moved BN stats)."""
    jm, x, y = MODELS[name]()
    jm.fit((x, y), epochs=2)
    return jm, x, y


@pytest.mark.parametrize("name", sorted(MODELS))
def test_jax_zip_imports_leaf_equal_with_adam_state(name, tmp_path):
    jm, x, y = _trained(name)
    path = str(tmp_path / "j.zip")
    jdl4j.export_dl4j_zip(jm, path)
    want = jdl4j.import_dl4j_zip(path)
    got = dl4j.import_dl4j_zip(path, device="cpu")
    _assert_leaf_equal(params_to_numpy(got), want.params, "params")
    _assert_leaf_equal(state_to_numpy(got), want.state, "state")
    _assert_leaf_equal(got.opt_state, want.opt_state, "opt_state")
    assert got.iteration == want.iteration
    np.testing.assert_allclose(got.output(x).numpy(), np.asarray(want.output(x)), **OUT_TOL)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_port_export_is_the_jax_export_and_jax_reads_it(name, tmp_path):
    """JAX zip -> port import -> port export: the same configuration and
    the same coefficient and updater bytes as the JAX package's export of
    its own import; the JAX package reads the port's zip to equal leaves."""
    jm, x, y = _trained(name)
    src = str(tmp_path / "src.zip")
    jdl4j.export_dl4j_zip(jm, src)
    mine, theirs = str(tmp_path / "port.zip"), str(tmp_path / "jax.zip")
    dl4j.export_dl4j_zip(dl4j.import_dl4j_zip(src, device="cpu"), mine)
    jdl4j.export_dl4j_zip(jdl4j.import_dl4j_zip(src), theirs)
    a, b = _entries(mine), _entries(theirs)
    assert set(a) == set(b) == {"configuration.json", "coefficients.bin", "updaterState.bin"}
    assert json.loads(a["configuration.json"]) == json.loads(b["configuration.json"])
    assert a["coefficients.bin"] == b["coefficients.bin"]
    assert a["updaterState.bin"] == b["updaterState.bin"]
    back = jdl4j.import_dl4j_zip(mine)
    ref = jdl4j.import_dl4j_zip(src)
    _assert_leaf_equal(back.params, ref.params, "params")
    _assert_leaf_equal(back.opt_state, ref.opt_state, "opt_state")


@pytest.mark.parametrize("name", sorted(MODELS))
def test_fit_after_import_continues_the_jax_moments(name, tmp_path):
    """One more Adam step on each package's import of the same zip: the
    updated params agree, so the moments came across (a restart from zero
    moments moves the params by about the rate in every entry)."""
    jm, x, y = _trained(name)
    path = str(tmp_path / "j.zip")
    jdl4j.export_dl4j_zip(jm, path)
    want = jdl4j.import_dl4j_zip(path)
    got = dl4j.import_dl4j_zip(path, device="cpu")
    want.fit((x, y), epochs=1)
    got.fit((x, y), epochs=1)
    for g, w in zip(jax.tree_util.tree_leaves(_np(got.params)),
                    jax.tree_util.tree_leaves(_np(want.params))):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_port_model_without_updates_exports_zero_moments(tmp_path):
    """A port model that never updated holds no optimizer state; its export
    writes the zeros the JAX package's freshly initialised state holds."""
    jm, _, _ = _cnn()
    src = str(tmp_path / "fresh.zip")
    jdl4j.export_dl4j_zip(jm, src)
    pm = dl4j.import_dl4j_zip(src, device="cpu")
    assert pm.opt_state is not None   # the zip held updaterState.bin
    pm.opt_state = None
    out = str(tmp_path / "out.zip")
    dl4j.export_dl4j_zip(pm, out)
    assert _entries(out)["updaterState.bin"] == _entries(src)["updaterState.bin"]


def test_graves_gate_and_peephole_order_reach_the_port_layout(tmp_path):
    """The importer's [g,f,o,i] -> [i,f,g,o] permutation and the peephole
    columns, read straight from the zip's flat coefficient vector."""
    jm, x, _ = _graves()
    path = str(tmp_path / "g.zip")
    jdl4j.export_dl4j_zip(jm, path)
    flat = dl4j.read_nd4j(io.BytesIO(_entries(path)["coefficients.bin"])).ravel()
    pm = dl4j.import_dl4j_zip(path, device="cpu")
    H, n_in = 8, 6
    wx = flat[:n_in * 4 * H].reshape(n_in, 4 * H, order="F")
    rw = flat[n_in * 4 * H:n_in * 4 * H + H * (4 * H + 3)].reshape(H, 4 * H + 3, order="F")
    p = {k: v.numpy() for k, v in pm.params[0].items()}
    blocks = {"g": 0, "f": 1, "o": 2, "i": 3}          # DL4J's
    for ours, gate in enumerate("ifgo"):
        theirs = blocks[gate]
        assert np.array_equal(p["Wx"][:, ours * H:(ours + 1) * H],
                              wx[:, theirs * H:(theirs + 1) * H])
    assert np.array_equal(p["peephole"], np.concatenate([rw[:, 4 * H + 2], rw[:, 4 * H],
                                                         rw[:, 4 * H + 1]]))


def test_conv_graph_without_a_preprocessor_needs_input_type(tmp_path):
    """The reference behaviour the port mirrors: a conv graph whose dense
    layer follows global pooling pins no input size, so the import asks for
    input_type (and then works)."""
    from deeplearning4j_tpu.nn.layers import GlobalPooling as JGlobalPooling
    from deeplearning4j_tpu_torch.nn.input_type import InputType

    conf = (jg.ComputationGraphConfiguration.builder()
            .add_inputs("in").set_input_types(JInputType.convolutional(6, 6, 2))
            .add_layer("c", JConv2D(n_out=3, kernel=(3, 3), activation="relu"), "in")
            .add_layer("p", JGlobalPooling(pooling="avg"), "c")
            .add_layer("out", JOutputLayer(n_out=2, activation="softmax", loss="mcxent"), "p")
            .set_outputs("out").updater({"type": "sgd", "lr": 0.1}).build())
    jm = jg.ComputationGraph(conf).init()
    path = str(tmp_path / "conv_cg.zip")
    jdl4j.export_dl4j_zip(jm, path)
    with pytest.raises(ValueError, match="input_type"):
        jdl4j.import_dl4j_zip(path)
    with pytest.raises(ValueError, match="input_type"):
        dl4j.import_dl4j_zip(path, device="cpu")
    pm = dl4j.import_dl4j_zip(path, input_type=[InputType.convolutional(6, 6, 2)], device="cpu")
    assert isinstance(pm, ComputationGraph)
    _assert_leaf_equal(pm.params, jdl4j.import_dl4j_zip(
        path, input_type=[JInputType.convolutional(6, 6, 2)]).params)


@pytest.mark.skipif(torch.cuda.is_available(), reason="the default device is the GPU here")
def test_import_without_a_gpu_and_without_device_raises():
    with pytest.raises(RuntimeError):
        dl4j.import_dl4j_zip(os.path.join(FIXDIR, "dl4j_cnn_tiny.zip"))
