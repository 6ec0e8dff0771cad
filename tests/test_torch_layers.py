"""Per-layer parity of the PyTorch port against the JAX package: the same
numpy params and inputs through each ported layer's ``apply``."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.nn.input_type import InputType as JInputType
from deeplearning4j_tpu.nn.layers import attention as jatt
from deeplearning4j_tpu.nn.layers import core as jcore
from deeplearning4j_tpu.nn.layers import normalization as jnorm
from deeplearning4j_tpu.nn.layers import recurrent as jrec
from deeplearning4j_tpu_torch.nn import activations
from deeplearning4j_tpu_torch.nn.layers import (
    EmbeddingSequence, LayerNorm, MultiHeadAttention, PositionalEmbedding,
    RnnOutputLayer, TransformerBlock, layer_norm)

F32 = dict(rtol=1e-4, atol=1e-5)          # a layer's f32 forward
ATT = dict(rtol=1e-5, atol=2e-5)          # f32 attention core


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _np_tree(p):
    return {k: _np_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in p.items()}


def _torch_tree(p, dtype=torch.float32):
    return {k: _torch_tree(v, dtype) if isinstance(v, dict)
            else torch.from_numpy(np.array(v, np.float32)).to(dtype)
            for k, v in p.items()}


def _jax_init(jlayer, size, T=8):
    params = jlayer.init(jax.random.PRNGKey(0), JInputType.recurrent(size, T),
                         jnp.float32)
    return params, _torch_tree(_np_tree(params))


def _x(B=2, T=8, C=16, seed=0):
    return np.random.RandomState(seed).randn(B, T, C).astype(np.float32)


def test_embedding_sequence():
    jl = jcore.EmbeddingSequence(n_in=20, n_out=6)
    jp, tp = _jax_init(jl, 20)
    ids = np.random.RandomState(0).randint(0, 20, (3, 5))
    want = jl.apply(jp, {}, jnp.asarray(ids))[0]
    got = EmbeddingSequence(n_in=20, n_out=6).apply(tp, {}, torch.from_numpy(ids))[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # ids from the host are range-checked before the copy (the model's input
    # path calls this); apply itself gathers as jnp.take does, with no host
    # read: an id past the vocab gives a row of NaN there, as in the reference
    with pytest.raises(ValueError, match=r"\[0, 20\)"):
        EmbeddingSequence.check_host_ids(torch.tensor([[3, 20]]), 20)
    bad = torch.tensor([[3, 20]])
    got = EmbeddingSequence(n_in=20, n_out=6).apply(tp, {}, bad)[0]
    want = jl.apply(jp, {}, jnp.asarray(bad.numpy()))[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert np.isnan(got[0, 1].numpy()).all()


def test_positional_embedding():
    jl = jatt.PositionalEmbedding(max_len=12)
    jp, tp = _jax_init(jl, 16)
    x = _x(T=7)
    want = jl.apply(jp, {}, jnp.asarray(x))[0]
    got = PositionalEmbedding(max_len=12).apply(tp, {}, torch.from_numpy(x))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm(dtype):
    rs = np.random.RandomState(1)
    x = (rs.randn(3, 5, 16) * 3 + 1).astype(np.float32)
    g = (1 + 0.1 * rs.randn(16)).astype(np.float32)
    b = (0.1 * rs.randn(16)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = jnorm.layer_norm(*(jnp.asarray(a, jdt) for a in (x, g, b)))
    got = layer_norm(*(torch.from_numpy(a).to(tdt) for a in (x, g, b)))
    assert got.dtype == tdt
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, **F32)
        return
    # bf16: stats in f32, the normalised value rounded to bf16 BEFORE the
    # affine; XLA may keep y*gamma in f32 before adding beta where torch
    # rounds twice, so allow one bf16 ulp of outputs of order 1-4 (2**-6)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=2 ** -6)
    # torch's fused layer_norm applies the affine in f32: another function
    fused = F.layer_norm(*(torch.from_numpy(a).to(tdt) for a in (x,)), (16,),
                         torch.from_numpy(g).to(tdt), torch.from_numpy(b).to(tdt))
    assert not torch.equal(fused, got)


def test_layer_norm_layer_without_affine():
    x = _x()
    want = jnorm.LayerNorm(use_gamma_beta=False).apply({}, {}, jnp.asarray(x))[0]
    got = LayerNorm(use_gamma_beta=False).apply({}, {}, torch.from_numpy(x))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    got = activations.get("gelu")(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.gelu(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    exact = F.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - got).max() > 1e-4   # torch's default is erf


@pytest.mark.parametrize("name", ["identity", "relu", "tanh", "softmax"])
def test_other_activations(name):
    from deeplearning4j_tpu.nn import activations as jact

    x = _x(seed=4)
    np.testing.assert_allclose(activations.get(name)(torch.from_numpy(x)).numpy(),
                               np.asarray(jact.get(name)(jnp.asarray(x))), **F32)


@pytest.mark.parametrize("use_flash", ["auto", False])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_multi_head_attention(use_flash, causal, masked):
    kw = dict(n_heads=4, causal=causal, use_flash=use_flash)
    jl = jatt.MultiHeadAttention(**kw)
    jp, tp = _jax_init(jl, 16)
    x = _x(seed=2)
    m = None
    if masked:
        m = np.ones((2, 8), np.float32)
        m[1, 5:] = 0.0
    want = jl.apply(jp, {}, jnp.asarray(x),
                    mask=jnp.asarray(m) if masked else None)[0]
    got = MultiHeadAttention(**kw).apply(
        tp, {}, torch.from_numpy(x),
        mask=torch.from_numpy(m) if masked else None)[0]
    w = m[:, :, None] if masked else 1.0   # padded query rows: unspecified
    np.testing.assert_allclose(got.numpy() * w, np.asarray(want) * w, **ATT)


def test_transformer_block():
    jl = jatt.TransformerBlock(n_heads=2, ffn_mult=3)
    jp, tp = _jax_init(jl, 16)
    x = _x(seed=3)
    want = jl.apply(jp, {}, jnp.asarray(x))[0]
    got = TransformerBlock(n_heads=2, ffn_mult=3).apply(tp, {}, torch.from_numpy(x))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_rnn_output_layer_with_mask():
    jl = jrec.RnnOutputLayer(n_in=16, n_out=5, activation="softmax")
    jp, tp = _jax_init(jl, 16)
    x = _x(seed=5)
    m = np.ones((2, 8), np.float32)
    m[0, 6:] = 0.0
    want = jl.apply(jp, {}, jnp.asarray(x), mask=jnp.asarray(m))[0]
    got = RnnOutputLayer(n_in=16, n_out=5, activation="softmax").apply(
        tp, {}, torch.from_numpy(x), mask=torch.from_numpy(m))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_param_layouts_match_the_jax_package():
    for jl, tl in [
        (jatt.TransformerBlock(n_heads=2), TransformerBlock(n_heads=2)),
        (jcore.EmbeddingSequence(n_in=9, n_out=16), EmbeddingSequence(n_in=9, n_out=16)),
        (jrec.RnnOutputLayer(n_in=16, n_out=3), RnnOutputLayer(n_in=16, n_out=3)),
        (jatt.PositionalEmbedding(max_len=8), PositionalEmbedding(max_len=8)),
    ]:
        jp = _np_tree(jl.init(jax.random.PRNGKey(0), JInputType.recurrent(16, 8),
                              jnp.float32))
        g = torch.Generator().manual_seed(0)
        from deeplearning4j_tpu_torch.nn.input_type import InputType

        tp = tl.init(g, InputType.recurrent(16, 8), torch.float32)
        shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
        assert _shape_tree(tp) == shapes


def _shape_tree(p):
    return {k: _shape_tree(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in p.items()}
