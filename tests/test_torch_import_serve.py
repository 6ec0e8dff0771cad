"""Loading a model from a file and serving or training it, in the port:
``utils/guesser.load_any`` on all four formats, ``models/pretrained.
init_pretrained``, ``ModelRegistry.load``, ``python -m
deeplearning4j_tpu_torch.serve`` answering ``:predict`` on the CPU, the
trainer CLI's ``--dataset`` and the zoo labels, each against the JAX
package where it has a counterpart."""

import json
import os
import struct
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.modelimport import dl4j as jdl4j
from deeplearning4j_tpu.models import labels as jlabels
from deeplearning4j_tpu.models.pretrained import init_pretrained as j_init_pretrained
from deeplearning4j_tpu_torch.models import labels
from deeplearning4j_tpu_torch.models.pretrained import init_pretrained
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph, ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration, MultiLayerNetwork
from deeplearning4j_tpu_torch.serve import InferenceServer, ModelRegistry, ServeConfig
from deeplearning4j_tpu_torch.train import __main__ as train_cli
from deeplearning4j_tpu_torch.utils.guesser import load_any
from deeplearning4j_tpu_torch.utils.serialization import restore_network, save_network

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures")
CG_ZIP = os.path.join(FIX, "dl4j_cg_tiny.zip")
CNN_ZIP = os.path.join(FIX, "dl4j_cnn_tiny.zip")
TOL = dict(rtol=1e-5, atol=1e-6)
CLI_WAIT_S = 120


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


def _post(port, name, payload, timeout=60):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/{name}:predict",
        data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


# -- load_any ----------------------------------------------------------------------

def test_load_any_reads_all_four_formats(tmp_path):
    g = np.load(os.path.join(FIX, "dl4j_cnn_tiny_golden.npz"))
    dl4j_model = load_any(CNN_ZIP, device="cpu")
    assert isinstance(dl4j_model, MultiLayerNetwork) and dl4j_model.weights_imported
    np.testing.assert_allclose(dl4j_model.output(g["x"]).numpy(), g["y"], **TOL)

    native = str(tmp_path / "native.zip")
    save_network(dl4j_model, native)
    back = load_any(native, device="cpu")
    assert isinstance(back, MultiLayerNetwork)
    np.testing.assert_allclose(back.output(g["x"]).numpy(), g["y"], **TOL)

    k = np.load(os.path.join(FIX, "keras_graph_io.npz"))
    keras_model = load_any(os.path.join(FIX, "keras_graph.h5"), device="cpu")
    assert isinstance(keras_model, ComputationGraph)
    np.testing.assert_allclose(keras_model.output(k["x"]).numpy(), k["y"], rtol=1e-4, atol=1e-5)

    conf = str(tmp_path / "conf.json")
    with open(conf, "w") as f:
        f.write(dl4j_model.conf.to_json())
    assert isinstance(load_any(conf, device="cpu"), MultiLayerConfiguration)
    cg_conf = str(tmp_path / "cg.json")
    with open(cg_conf, "w") as f:
        f.write(load_any(CG_ZIP, device="cpu").conf.to_json())
    assert isinstance(load_any(cg_conf), ComputationGraphConfiguration)


def test_load_any_lists_every_attempt(tmp_path):
    junk = tmp_path / "junk.bin"
    junk.write_bytes(b"\x00\x01 not a model")
    with pytest.raises(ValueError) as ei:
        load_any(str(junk), device="cpu")
    msg = str(ei.value)
    assert "not a zip" in msg and "keras h5" in msg and "config json" in msg


# -- init_pretrained -----------------------------------------------------------------

def test_init_pretrained_transplants_a_dl4j_zip_like_the_jax_package():
    g = np.load(os.path.join(FIX, "dl4j_cg_tiny_golden.npz"))
    src = load_any(CG_ZIP, device="cpu")
    fresh = init_pretrained(src.conf, weights=CG_ZIP, device="cpu")
    jsrc = jdl4j.import_dl4j_zip(CG_ZIP)
    jfresh = j_init_pretrained(jsrc.conf, weights=CG_ZIP)
    assert fresh.pretrained_summary == jfresh.pretrained_summary
    assert set(fresh.pretrained_summary["loaded"]) >= {"c1", "b1", "out"}
    np.testing.assert_allclose(fresh.output(g["x"]).numpy(), g["y"], **TOL)


def test_init_pretrained_skips_a_mismatched_head_and_reports_it(tmp_path, monkeypatch):
    src = load_any(CNN_ZIP, device="cpu")
    d = src.conf.to_dict()
    d["layers"][-1]["n_out"] = d["layers"][-1]["n_out"] + 2      # another head width
    conf = MultiLayerConfiguration.from_dict(d)
    models = tmp_path / "models"
    models.mkdir()
    save_network(src, str(models / "tiny.zip"))
    monkeypatch.setenv("DL4J_TPU_HOME", str(tmp_path))
    m = init_pretrained(conf, name="tiny", device="cpu")
    n_layers = len(m.params)
    assert m.pretrained_summary["skipped"] == [n_layers - 1]
    for i in m.pretrained_summary["loaded"]:
        for k, v in m.params[i].items():
            assert torch.equal(v, src.params[i][k])
    with pytest.raises(FileNotFoundError, match="No cached weights"):
        init_pretrained(conf, name="absent", device="cpu")
    with pytest.raises(ValueError, match="bare configuration"):
        cpath = tmp_path / "c.json"
        cpath.write_text(conf.to_json())
        init_pretrained(conf, weights=str(cpath), device="cpu")


# -- ModelRegistry.load and the serving CLI ---------------------------------------------

def test_registry_load_serves_an_imported_zip():
    g = np.load(os.path.join(FIX, "dl4j_cg_tiny_golden.npz"))
    reg = ModelRegistry(config=ServeConfig(max_batch=4, workers=1, max_wait_s=0.01),
                        device="cpu")
    try:
        reg.load("cg", CG_ZIP)
        meta = [d for d in reg.describe() if d.get("name", "cg") == "cg"]
        assert any(d.get("source") == CG_ZIP for d in meta)
        srv = InferenceServer(reg).start(port=0)
        try:
            status, body = _post(srv.port, "cg", {"inputs": g["x"].tolist()})
        finally:
            srv.stop(shutdown_registry=False)
        assert status == 200
        np.testing.assert_allclose(body["outputs"], g["y"], **TOL)
        # bundle= is taken (nn/aot.py); a missing sidecar restores nothing
        reg.load("cg2", CG_ZIP, bundle=CG_ZIP + ".missing.aotbundle")
        assert [d for d in reg.describe() if d.get("source") == CG_ZIP]
    finally:
        reg.shutdown()


def test_serve_cli_answers_predict_like_the_imported_model(tmp_path):
    """python -m deeplearning4j_tpu_torch.serve name=zip name=h5 --device cpu
    --port 0: both models answer :predict with the importer's outputs."""
    g = np.load(os.path.join(FIX, "dl4j_cnn_tiny_golden.npz"))
    k = np.load(os.path.join(FIX, "keras_lstm_io.npz"))
    keras_h5 = os.path.join(FIX, "keras_lstm.h5")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    proc = subprocess.Popen(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.serve", f"cnn={CNN_ZIP}",
         f"lstm={keras_h5}", "--device", "cpu", "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=str(tmp_path))
    try:
        port, lines, t0 = None, [], time.time()
        while port is None and time.time() - t0 < CLI_WAIT_S:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if line.startswith("serving "):
                port = int(line.rsplit(":", 1)[1])
        assert port is not None, "".join(lines)
        assert any("loading cnn" in l for l in lines) and any("loading lstm" in l for l in lines)
        status, body = _post(port, "cnn", {"inputs": g["x"].tolist()})
        assert status == 200
        np.testing.assert_allclose(body["outputs"], g["y"], **TOL)
        status, body = _post(port, "lstm", {"inputs": k["x"].tolist()})
        assert status == 200
        np.testing.assert_allclose(body["outputs"], k["y"], rtol=1e-4, atol=1e-5)
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stdout.close()


def test_serve_cli_refuses_a_spec_without_a_path():
    from deeplearning4j_tpu_torch.serve import __main__ as serve_cli

    with pytest.raises(SystemExit):
        serve_cli.main(["justaname", "--device", "cpu"])


# -- the trainer CLI's --dataset -----------------------------------------------------------

def _mlp_conf(path, n_in, n_out):
    from deeplearning4j_tpu_torch.nn.input_type import InputType
    from deeplearning4j_tpu_torch.nn.layers import Dense, OutputLayer

    conf = MultiLayerConfiguration(
        layers=(Dense(n_out=16, activation="tanh"),
                OutputLayer(n_out=n_out, activation="softmax", loss="mcxent")),
        input_type=InputType.feed_forward(n_in), updater={"type": "adam", "lr": 1e-2})
    with open(path, "w") as f:
        f.write(conf.to_json())
    return conf


def test_train_cli_dataset_iris(tmp_path, capsys):
    conf = str(tmp_path / "iris.json")
    _mlp_conf(conf, 4, 3)
    out = str(tmp_path / "iris.zip")
    m = train_cli.run([conf, "--dataset", "iris", "--epochs", "3", "--batch-size", "50",
                       "--output", out, "--device", "cpu", "--evaluate"])
    assert m.iteration == 9
    text = capsys.readouterr().out
    assert "dataset iris: 150 examples, synthetic=False" in text and "Accuracy:" in text
    back = restore_network(out, device="cpu")
    x = np.eye(4, dtype=np.float32)
    np.testing.assert_allclose(back.output(x).numpy(), m.output(x).numpy(), **TOL)


def test_train_cli_dataset_mnist_from_local_idx(tmp_path, monkeypatch, capsys):
    from deeplearning4j_tpu_torch import native

    monkeypatch.setenv("DL4J_TPU_DATA", str(tmp_path))
    rs = np.random.RandomState(0)
    n = 48
    imgs = rs.randint(0, 256, (n, 28, 28), dtype=np.uint8)
    lab = rs.randint(0, 10, n).astype(np.uint8)
    (tmp_path / "train-images-idx3-ubyte").write_bytes(
        struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
    (tmp_path / "train-labels-idx1-ubyte").write_bytes(struct.pack(">II", 2049, n) + lab.tobytes())
    conf = str(tmp_path / "mlp.json")
    from deeplearning4j_tpu_torch.nn.input_type import InputType
    from deeplearning4j_tpu_torch.nn.layers import Dense, OutputLayer

    c = MultiLayerConfiguration(
        layers=(Dense(n_out=8, activation="relu"),
                OutputLayer(n_out=10, activation="softmax", loss="mcxent")),
        input_type=InputType.convolutional(28, 28, 1), updater={"type": "sgd", "lr": 0.1})
    with open(conf, "w") as f:
        f.write(c.to_json())
    before = native.CALLS["parse_idx_images"]
    m = train_cli.run([conf, "--dataset", "mnist", "--batch-size", "16",
                       "--output", str(tmp_path / "m.zip"), "--device", "cpu"])
    assert m.iteration == 3
    assert native.CALLS["parse_idx_images"] == before + 1
    assert "dataset mnist: 48 examples, synthetic=False" in capsys.readouterr().out


# -- labels ---------------------------------------------------------------------------

def test_labels_match_the_jax_package(tmp_path, monkeypatch):
    voc, jvoc = labels.VOCLabels(), jlabels.VOCLabels()
    assert voc.labels == jvoc.labels
    p = np.random.RandomState(1).rand(2, len(voc)).astype(np.float32)
    assert voc.decode_predictions(p, top=3) == jvoc.decode_predictions(p, top=3)
    monkeypatch.setenv("DL4J_TPU_HOME", str(tmp_path))
    os.makedirs(tmp_path / "labels")
    names = [f"class_{i}" for i in range(1000)]
    (tmp_path / "labels" / "imagenet_class_index.json").write_text(
        json.dumps({str(i): [f"n{i:08d}", n] for i, n in enumerate(names)}))
    try:
        want = jlabels.ImageNetLabels()
    except FileNotFoundError:
        pytest.fail("the JAX package did not read the written ImageNet labels")
    got = labels.ImageNetLabels()
    assert got.labels == want.labels
