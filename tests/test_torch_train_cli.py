"""The trainer CLI: from one JAX-written f32 initial zip and one ``.npz``,
``python -m deeplearning4j_tpu.train`` and the port's
``python -m deeplearning4j_tpu_torch.train --device cpu`` write zips whose
params agree; plus the port CLI's own flags."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JNetwork
from deeplearning4j_tpu.train import __main__ as jcli
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu_torch.train import __main__ as cli
from deeplearning4j_tpu_torch.utils import serialization as ser
from deeplearning4j_tpu_torch.utils.tree import tree_leaves

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(vocab_size=32, max_len=8, d_model=16, n_heads=2, n_blocks=2)
# f32, the same steps in both packages; summation order differs
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


@pytest.fixture
def inputs(tmp_path):
    """A JAX-written initial zip and a 10-row token dataset."""
    conf = jzoo.TransformerLM(dtype="float32", seed=9,
                              updater={"type": "sgd", "lr": 0.1}, **SMALL)
    init = tmp_path / "init.zip"
    jser.save_network(JNetwork(conf).init(), str(init))
    x = np.random.RandomState(1).randint(0, SMALL["vocab_size"], (10, SMALL["max_len"]))
    data = tmp_path / "d.npz"
    np.savez(data, x=x, y=np.roll(x, -1, axis=1))
    conf_json = tmp_path / "conf.json"
    conf_json.write_text(conf.to_json())
    return init, data, conf_json


def test_both_clis_train_the_same_params(inputs, tmp_path, capsys):
    init, data, _ = inputs
    args = ["--data", str(data), "--epochs", "2", "--batch-size", "4",
            "--listener-frequency", "1"]
    jout, pout = tmp_path / "jax_out.zip", tmp_path / "port_out.zip"
    assert jcli.main([str(init), *args, "--output", str(jout)]) == 0
    assert cli.main([str(init), *args, "--output", str(pout), "--device", "cpu"]) == 0
    assert f"saved {pout}" in capsys.readouterr().out
    jm = jser.restore_network(str(jout))
    m = ser.restore_network(str(pout), device="cpu")
    assert (m.iteration, m.epoch) == (jm.iteration, jm.epoch) == (6, 2)
    got, want = tree_leaves(m.params), jax.tree_util.tree_leaves(jm.params)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32)


def test_a_config_json_trains_and_evaluates(inputs, tmp_path, capsys):
    _, data, conf_json = inputs
    out = tmp_path / "o.zip"
    m = cli.run([str(conf_json), "--data", str(data), "--epochs", "1",
                 "--batch-size", "8", "--output", str(out), "--evaluate",
                 "--device", "cpu"])
    assert m.iteration == 2 and out.exists()
    assert "Accuracy:" in capsys.readouterr().out


@pytest.mark.parametrize("flag,slice_name", [(["--data-parallel"], "parallel slice")])
def test_unported_flags_exit_naming_their_slice(inputs, flag, slice_name, tmp_path):
    # the parallel slice ported --data-parallel: on a world of one it trains
    # what the CLI trains without the flag, bit for bit, and leaves no group
    init, data, _ = inputs
    base = [str(init), "--data", str(data), "--batch-size", "4", "--device", "cpu"]
    a = cli.run(base + ["--output", str(tmp_path / "a.zip")])
    b = cli.run(base + [*flag, "--output", str(tmp_path / "b.zip")])
    assert (tmp_path / "b.zip").exists() and a.iteration == b.iteration
    for pa, pb in zip(tree_leaves(a.params), tree_leaves(b.params)):
        np.testing.assert_array_equal(pa.numpy(), pb.numpy())
    assert not torch.distributed.is_initialized()


def test_a_dataset_without_x_and_y_exits(inputs, tmp_path):
    init, _, _ = inputs
    bad = tmp_path / "bad.npz"
    np.savez(bad, features=np.zeros(3))
    with pytest.raises(SystemExit, match="'x' and 'y'"):
        cli.main([str(init), "--data", str(bad), "--device", "cpu"])


def test_without_a_gpu_the_default_device_raises(inputs, tmp_path):
    # entry points run on the card unless the caller asks for the CPU
    init, data, _ = inputs
    env = {k: v for k, v in os.environ.items() if not k.startswith("DL4J_TPU_")}
    env.update(PYTHONPATH=str(REPO), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.train", str(init),
         "--data", str(data), "--output", str(tmp_path / "x.zip")],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr
    assert not (tmp_path / "x.zip").exists()
