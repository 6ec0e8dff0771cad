"""Checkpoint interop: the port reads and writes the JAX package's zip.

An f32 zip written by either package restores in the other (and one more
step agrees); a JAX-written bf16 zip — which the JAX package itself cannot
restore, its ``jnp.asarray`` rejects the stored ``|V2`` records — is read
bit-exactly; a port-written bf16 zip's npz leaves equal the JAX-written
ones byte for byte."""

import io
import json
import os
import zipfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JNetwork
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu_torch.interop import params_from_numpy
from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration, MultiLayerNetwork
from deeplearning4j_tpu_torch.utils import serialization as ser
from deeplearning4j_tpu_torch.utils.guesser import load_any
from deeplearning4j_tpu_torch.utils.tree import tree_leaves

SMALL = dict(vocab_size=32, max_len=8, d_model=16, n_heads=2, n_blocks=1)
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


def _data(n=4, seed=0):
    x = np.random.RandomState(seed).randint(0, SMALL["vocab_size"], (n, SMALL["max_len"]))
    return x, np.roll(x, -1, axis=1)


def _jax_trained(dtype="float32", updater=None):
    jm = JNetwork(jzoo.TransformerLM(dtype=dtype, seed=5,
                                     updater=updater or {"type": "adam", "lr": 1e-2},
                                     **SMALL)).init()
    jm.fit(_data(), epochs=1)
    return jm


def _port_like(jm, dtype):
    m = MultiLayerNetwork(MultiLayerConfiguration.from_json(jm.conf.to_json()),
                          device="cpu").init()
    return params_from_numpy(m, jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), jm.params))


def _leaf_npy(path, entry):
    """{leaf name: raw .npy bytes} of one npz entry of a checkpoint zip."""
    with zipfile.ZipFile(path) as zf:
        inner = zipfile.ZipFile(io.BytesIO(zf.read(entry)))
        return {n: inner.read(n) for n in inner.namelist()}


def _assert_trees_close(got, want, **tol):
    got, want = tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b.astype(jnp.float32)), **tol)


def test_a_jax_f32_zip_restores_and_steps_alike(tmp_path):
    jm = _jax_trained()
    path = tmp_path / "jax.zip"
    jser.save_network(jm, str(path))
    m = ser.restore_network(str(path), device="cpu")
    assert (m.iteration, m.epoch) == (jm.iteration, jm.epoch) == (1, 1)
    _assert_trees_close(m.params, jm.params, rtol=0, atol=0)
    _assert_trees_close(m.opt_state, jm.opt_state, rtol=0, atol=0)
    x, y = _data(seed=1)
    jm.fit((x, y), epochs=1)
    m.fit((x, y), epochs=1)
    C = SMALL["d_model"]
    for a, b in zip(tree_leaves(m.params), jax.tree_util.tree_leaves(jm.params)):
        a, b = a.numpy(), np.asarray(b)
        if a.shape == (3 * C,):   # bqkv: its key third is Adam-amplified noise
            a, b = np.concatenate([a[:C], a[2 * C:]]), np.concatenate([b[:C], b[2 * C:]])
        np.testing.assert_allclose(a, b, **F32)


def test_a_port_f32_zip_restores_in_the_jax_package(tmp_path):
    m = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jzoo.TransformerLM(dtype="float32", updater="adam", **SMALL).to_json()),
        device="cpu").init()
    m.fit(_data(), epochs=2)
    path = tmp_path / "port.zip"
    ser.save_network(m, str(path))
    jm = jser.restore_network(str(path))
    assert (jm.iteration, jm.epoch) == (2, 2)
    _assert_trees_close(m.params, jm.params, rtol=0, atol=0)
    _assert_trees_close(m.opt_state, jm.opt_state, rtol=0, atol=0)
    with zipfile.ZipFile(path) as zf:
        assert json.loads(zf.read("meta.json"))["model_class"] == "MultiLayerNetwork"


def test_a_jax_bf16_zip_is_read_bit_exactly(tmp_path):
    jm = _jax_trained("bfloat16")
    path = tmp_path / "jax_bf16.zip"
    jser.save_network(jm, str(path))
    with pytest.raises(TypeError):          # the reference fault
        jser.restore_network(str(path))
    m = ser.restore_network(str(path), device="cpu")
    got, want = tree_leaves(m.params), jax.tree_util.tree_leaves(jm.params)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                      np.asarray(b).view(np.int16))
    _assert_trees_close(m.opt_state, jm.opt_state, rtol=0, atol=0)   # f32 moments


def test_a_port_bf16_zip_matches_the_jax_zip_byte_for_byte(tmp_path):
    jm = _jax_trained("bfloat16")
    m = _port_like(jm, "bfloat16")
    m.opt_state = ser._restore_tree_like(
        m.init_opt_state(), [np.asarray(x) for x in jax.tree_util.tree_leaves(jm.opt_state)])
    m.iteration, m.epoch = jm.iteration, jm.epoch
    jpath, ppath = tmp_path / "jax.zip", tmp_path / "port.zip"
    jser.save_network(jm, str(jpath))
    ser.save_network(m, str(ppath))
    for entry in ("coefficients.npz", "updaterState.npz", "state.npz"):
        want, got = _leaf_npy(jpath, entry), _leaf_npy(ppath, entry)
        assert got.keys() == want.keys()
        for name in want:
            assert got[name] == want[name], f"{entry}/{name}"


def test_save_to_a_file_object_and_the_optional_entries():
    m = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jzoo.TransformerLM(dtype="float32", **SMALL).to_json()), device="cpu").init()
    buf = io.BytesIO()
    ser.save_network(m, buf, save_updater=False, normalizer={"mean": [0.5]})
    buf.seek(0)
    assert ser.restore_normalizer(buf) == {"mean": [0.5]}
    buf.seek(0)
    with zipfile.ZipFile(buf) as zf:
        assert "updaterState.npz" not in zf.namelist()
    buf.seek(0)
    r = ser.restore_network(buf, device="cpu")
    for a, b in zip(tree_leaves(r.params), tree_leaves(m.params)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_optimizer_state_is_built_at_the_first_update_or_restore(tmp_path):
    m = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jzoo.TransformerLM(dtype="float32", updater="adam", **SMALL).to_json()),
        device="cpu").init()
    m.output(_data()[0])
    assert m.opt_state is None                    # a model that serves holds no moments
    fresh = tmp_path / "fresh.zip"
    ser.save_network(m, str(fresh))
    with zipfile.ZipFile(fresh) as zf:
        assert "updaterState.npz" not in zf.namelist()
    _assert_trees_close(m.params, jser.restore_network(str(fresh)).params, rtol=0, atol=0)
    m.fit(_data(), epochs=1)
    assert set(m.opt_state[-1]) == {"m", "v"}
    trained = tmp_path / "trained.zip"
    ser.save_network(m, str(trained))
    assert ser.restore_network(str(trained), load_updater=False, device="cpu").opt_state is None
    r = ser.restore_network(str(trained), device="cpu")
    for a, b in zip(tree_leaves(r.opt_state), tree_leaves(m.opt_state)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_a_mismatched_checkpoint_raises(tmp_path):
    small = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jzoo.TransformerLM(dtype="float32", **SMALL).to_json()), device="cpu").init()
    path = tmp_path / "m.zip"
    ser.save_network(small, str(path))
    bigger = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jzoo.TransformerLM(dtype="float32", **dict(SMALL, n_blocks=2)).to_json()),
        device="cpu").init()
    with pytest.raises(ValueError, match="mismatch"):
        ser.apply_snapshot(bigger, ser.read_snapshot(str(path)))


def test_load_any_reads_a_zip_and_a_config_json(tmp_path):
    conf = jzoo.TransformerLM(dtype="float32", **SMALL)
    cpath = tmp_path / "conf.json"
    cpath.write_text(conf.to_json())
    got = load_any(str(cpath), device="cpu")
    assert isinstance(got, MultiLayerConfiguration) and got.to_dict() == conf.to_dict()
    zpath = tmp_path / "m.zip"
    jser.save_network(JNetwork(conf).init(), str(zpath))
    assert isinstance(load_any(str(zpath), device="cpu"), MultiLayerNetwork)
    bad = tmp_path / "bad.json"
    bad.write_text("{\"format\": \"x\"}")
    with pytest.raises(ValueError, match="no loader succeeded"):
        load_any(str(bad))
