"""Every registered loss of the port against ``deeplearning4j_tpu.nn.losses``:
the per-example scores and the average from pre-activation output, dense
labels on rank-2 and rank-3 output, sparse integer labels on the fused
softmax+mcxent head, with no mask, a [B] example mask and a [B, T] time
mask, with and without weights — the same numpy inputs into both."""

import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.nn import losses as jlosses
from deeplearning4j_tpu_torch.nn import losses

# f32 elementwise math and sums of a few terms: rounding only
TOL = dict(rtol=1e-5, atol=1e-6)
B, T, C = 3, 4, 5

# name -> (activation, label kind); every registered name and alias
CASES = {
    "mse": ("identity", "real"),
    "l2": ("identity", "real"),
    "mae": ("identity", "real"),
    "l1": ("identity", "real"),
    "mcxent": ("softmax", "onehot"),
    "negativeloglikelihood": ("sigmoid", "onehot"),
    "xent": ("sigmoid", "binary"),
    "hinge": ("identity", "sign"),
    "squared_hinge": ("identity", "sign"),
    "squaredhinge": ("tanh", "sign"),
    "kl_divergence": ("softmax", "prob"),
    "kld": ("softmax", "prob"),
    "reconstruction_crossentropy": ("sigmoid", "prob"),
    "poisson": ("softmax", "real_pos"),
    "cosine_proximity": ("identity", "real"),
    "msle": ("sigmoid", "real_pos"),
    "mape": ("identity", "real"),
    "wasserstein": ("identity", "real"),
}
# (output rank, mask): a [B, T] time mask needs rank-3 output
LAYOUTS = [(2, "none"), (2, "example"), (3, "none"), (3, "example"), (3, "time")]


def test_the_same_names_are_registered():
    assert losses.names() == jlosses.names() == sorted(CASES)


def _labels(kind, shape, rs):
    if kind == "real":
        return rs.randn(*shape).astype(np.float32)
    if kind == "real_pos":
        return rs.rand(*shape).astype(np.float32) * 2.0
    if kind == "sign":
        return np.where(rs.rand(*shape) > 0.5, 1.0, -1.0).astype(np.float32)
    if kind == "binary":
        return (rs.rand(*shape) > 0.5).astype(np.float32)
    if kind == "prob":
        e = np.exp(rs.randn(*shape))
        return (e / e.sum(-1, keepdims=True)).astype(np.float32)
    idx = rs.randint(0, shape[-1], shape[:-1])
    return np.eye(shape[-1], dtype=np.float32)[idx]


def _mask(kind, rs):
    if kind == "none":
        return None
    if kind == "example":
        return (rs.rand(B) > 0.3).astype(np.float32) * 1.5
    m = (rs.rand(B, T) > 0.3).astype(np.float32)
    m[0, 0] = 1.0
    return m


def _both(loss, labels, preact, activation, mask, weights):
    got = []
    for fn in (losses.per_example_scores, losses.average_score):
        got.append(fn(loss, torch.from_numpy(labels), torch.from_numpy(preact),
                      activation,
                      torch.from_numpy(mask) if mask is not None else None,
                      weights).numpy())
    want = []
    for fn in (jlosses.per_example_scores, jlosses.average_score):
        want.append(np.asarray(fn(loss, jnp.asarray(labels), jnp.asarray(preact),
                                  activation,
                                  jnp.asarray(mask) if mask is not None else None,
                                  weights)))
    return got, want


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("rank,mask_kind", LAYOUTS)
@pytest.mark.parametrize("weighted", [False, True])
def test_dense_labels_match(name, rank, mask_kind, weighted):
    activation, kind = CASES[name]
    rs = np.random.RandomState(zlib.crc32(f"{name}{rank}{mask_kind}{weighted}".encode()))
    shape = (B, C) if rank == 2 else (B, T, C)
    preact = rs.randn(*shape).astype(np.float32)
    if kind == "prob" and activation == "sigmoid":
        preact = preact * 0.5
    labels = _labels(kind, shape, rs)
    mask = _mask(mask_kind, rs)
    weights = (rs.rand(C).astype(np.float32) + 0.5).tolist() if weighted else None
    (got_pe, got_avg), (want_pe, want_avg) = _both(name, labels, preact, activation,
                                                   mask, weights)
    assert got_pe.shape == (B,)
    np.testing.assert_allclose(got_pe, want_pe, **TOL)
    np.testing.assert_allclose(got_avg, want_avg, **TOL)


@pytest.mark.parametrize("name", ["mcxent", "negativeloglikelihood"])
@pytest.mark.parametrize("rank,mask_kind", LAYOUTS)
@pytest.mark.parametrize("weighted", [False, True])
def test_sparse_integer_labels_match(name, rank, mask_kind, weighted):
    rs = np.random.RandomState(7 + rank)
    shape = (B, C) if rank == 2 else (B, T, C)
    preact = rs.randn(*shape).astype(np.float32) * 2.0
    labels = rs.randint(0, C, shape[:-1]).astype(np.int64)
    mask = _mask(mask_kind, rs)
    weights = (rs.rand(C).astype(np.float32) + 0.5).tolist() if weighted else None
    (got_pe, got_avg), (want_pe, want_avg) = _both(name, labels, preact, "softmax",
                                                   mask, weights)
    np.testing.assert_allclose(got_pe, want_pe, **TOL)
    np.testing.assert_allclose(got_avg, want_avg, **TOL)
    # sparse and one-hot labels are the same loss
    onehot = np.eye(C, dtype=np.float32)[labels]
    (dense_pe, _), _ = _both(name, onehot, preact, "softmax", mask, weights)
    np.testing.assert_allclose(got_pe, dense_pe, **TOL)


@pytest.mark.parametrize("name,activation", [("mse", "identity"), ("xent", "sigmoid"),
                                             ("mcxent", "sigmoid")])
def test_sparse_labels_outside_the_softmax_mcxent_head_raise(name, activation):
    labels = torch.zeros(B, T, dtype=torch.int64)
    with pytest.raises(ValueError, match="sparse"):
        losses.per_example_scores(name, labels, torch.zeros(B, T, C), activation)


def test_bf16_sparse_head_keeps_the_model_dtype():
    rs = np.random.RandomState(3)
    preact = torch.from_numpy(rs.randn(B, T, C).astype(np.float32)).bfloat16()
    labels = torch.from_numpy(rs.randint(0, C, (B, T)))
    got = losses.average_score("mcxent", labels, preact, "softmax")
    want = jlosses.average_score("mcxent", jnp.asarray(labels.numpy()),
                                 jnp.asarray(preact.float().numpy(), jnp.bfloat16),
                                 "softmax")
    assert got.dtype == torch.bfloat16
    # one bf16 rounding of the final sum, in either package
    np.testing.assert_allclose(got.float().item(), float(want.astype(jnp.float32)),
                               rtol=2 ** -7)


def test_unknown_loss_names_the_known_ones():
    with pytest.raises(ValueError, match="mcxent"):
        losses.get("nope")
