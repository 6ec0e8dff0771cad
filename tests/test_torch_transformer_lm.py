"""Whole-model parity: the port's TransformerLM ``output`` against the JAX
package's for the same numpy weights (``params_from_numpy``), f32 and
bf16, unpadded and bucket-padded, plus the entry points' device rule."""

import dataclasses

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.layers import TransformerBlock as JTransformerBlock
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JNetwork
from deeplearning4j_tpu_torch import serve
from deeplearning4j_tpu_torch.interop import params_from_numpy, params_to_numpy
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration, MultiLayerNetwork
from deeplearning4j_tpu_torch.utils import bucketing

SMALL = dict(vocab_size=64, max_len=16, d_model=32, n_heads=4, n_blocks=2)
F32 = dict(rtol=1e-4, atol=1e-5)


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


def _pair(dtype, flash=False, seed=3):
    """(JAX network, port network) with the same weights; ``flash`` makes
    the JAX blocks take the Pallas kernel (interpret mode on the CPU)."""
    jconf = jzoo.TransformerLM(dtype=dtype, seed=seed, **SMALL)
    if flash:
        jconf.layers = tuple(
            dataclasses.replace(l, use_flash=True)
            if isinstance(l, JTransformerBlock) else l for l in jconf.layers)
    jm = JNetwork(jconf).init()
    m = MultiLayerNetwork(MultiLayerConfiguration.from_json(jconf.to_json()),
                          device="cpu")
    params_from_numpy(m, jax.tree_util.tree_map(np.asarray, jm.params))
    return jm, m


def _ids(B, T=16, seed=0):
    return np.random.RandomState(seed).randint(0, SMALL["vocab_size"], (B, T))


def test_f32_output_matches_the_jax_default_path():
    jm, m = _pair("float32")
    x = _ids(3)
    got = m.output(x)
    assert got.shape == (3, 16, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.output(x)), **F32)


def test_f32_feature_mask_matches():
    jm, m = _pair("float32", seed=4)
    x = _ids(2, seed=1)
    fm = np.ones((2, 16), np.float32)
    fm[1, 11:] = 0.0
    got = m.output(x, fmask=fm).numpy()
    want = np.asarray(jm.output(x, fmask=fm))
    w = fm[:, :, None]   # padded positions: unspecified attention, masked out
    np.testing.assert_allclose(got * w, want * w, **F32)


def test_bf16_output_matches_the_jax_flash_path():
    jm, m = _pair("bfloat16", flash=True)
    x = _ids(2, seed=2)
    got = m.output(x)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jm.output(x).astype(jnp.float32))
    # two blocks of bf16 math that round at different places in torch and
    # XLA (the TPU kernel also rounds p to bf16): probabilities of order
    # 1/64 agree to a few bf16 ulps of the largest ones
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=2e-3)
    np.testing.assert_allclose(got.float().sum(-1).numpy(), 1.0, atol=2e-2)


def test_padded_batch_matches_single_rows():
    _, m = _pair("float32")
    x = _ids(3, seed=5)
    bucketing.telemetry().reset()
    batched = m.output(x).numpy()
    assert bucketing.telemetry().bucket_hits == {("mln.output", 4): 1}
    singles = np.concatenate([m.output(x[i:i + 1]).numpy() for i in range(3)])
    np.testing.assert_allclose(batched, singles, rtol=1e-6, atol=1e-7)


def test_feed_forward_matches_every_layer():
    jm, m = _pair("float32", seed=5)
    x = _ids(2, seed=3)
    got = m.feed_forward(x)
    want = jm.feed_forward(x)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)


def test_predict_is_the_argmax():
    _, m = _pair("float32")
    x = _ids(2, seed=6)
    np.testing.assert_array_equal(m.predict(x), m.output(x).argmax(-1).numpy())


def test_params_round_trip_through_numpy():
    jm, m = _pair("bfloat16")
    tree = params_to_numpy(m)
    assert tree[2]["attn"]["Wqkv"].shape == (32, 96)
    assert tree[2]["attn"]["Wqkv"].dtype == np.float32
    want = jax.tree_util.tree_map(lambda a: np.asarray(a.astype(jnp.float32)),
                                  jm.params)
    for got_l, want_l in zip(tree, want):
        jax.tree_util.tree_map(np.testing.assert_array_equal, got_l, want_l)
    m2 = params_from_numpy(
        MultiLayerNetwork(m.conf, device="cpu"), tree)
    x = _ids(1, seed=7)
    assert torch.equal(m2.output(x), m.output(x))


def test_params_from_numpy_rejects_a_mismatched_tree():
    _, m = _pair("float32")
    tree = list(params_to_numpy(m))
    tree[0] = {"W": np.zeros((3, 3), np.float32)}
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(m, tree)


def test_entry_points_default_to_the_gpu_and_never_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conf = zoo.TransformerLM(**SMALL)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiLayerNetwork(conf)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.ModelRegistry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.InferenceServer()
    with pytest.raises(RuntimeError, match="CUDA"):
        MultiLayerNetwork(conf, device="cuda")
    assert MultiLayerNetwork(conf, device="cpu").device.type == "cpu"


def test_init_draws_seeded_params_of_the_jax_layout():
    conf = zoo.TransformerLM(**SMALL)
    a = MultiLayerNetwork(conf, device="cpu").init()
    b = MultiLayerNetwork(conf, device="cpu").init()
    assert torch.equal(a.params[2]["Wi"], b.params[2]["Wi"])
    assert a.params[2]["Wi"].dtype == torch.bfloat16
    jm = JNetwork(jzoo.TransformerLM(**SMALL)).init()
    assert a.num_params() == sum(int(np.prod(p.shape)) for p in
                                 jax.tree_util.tree_leaves(jm.params))
