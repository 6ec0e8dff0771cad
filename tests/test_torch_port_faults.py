"""Repairs of the port's faults against the reference, on the CPU: the
reference's ``output(x, train, fmask)`` and ``feed_forward(x, train)``
signatures, the bit-exact bf16 copy of a served output to the host, the
embedding's ``jnp.take`` semantics without a read back to the host, and a
layer norm whose rows do not depend on the batch they ride in."""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JNetwork
from deeplearning4j_tpu_torch.interop import params_from_numpy
from deeplearning4j_tpu_torch.nn.layers.core import EmbeddingSequence
from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration, MultiLayerNetwork
from deeplearning4j_tpu_torch.serve.scheduler import _HostBuffer, _to_host

SMALL = dict(vocab_size=64, max_len=16, d_model=32, n_heads=4, n_blocks=2)
F32 = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _pair(seed=3):
    jm = JNetwork(jzoo.TransformerLM(dtype="float32", seed=seed, **SMALL)).init()
    m = MultiLayerNetwork(MultiLayerConfiguration.from_json(jm.conf.to_json()),
                          device="cpu")
    params_from_numpy(m, jax.tree_util.tree_map(np.asarray, jm.params))
    return jm, m


def _ids(B, seed=0):
    return np.random.RandomState(seed).randint(0, SMALL["vocab_size"], (B, 16))


# -- output(x, train, fmask) and feed_forward(x, train) ------------------------

def test_output_takes_train_positionally_as_the_reference_does():
    jm, m = _pair()
    x = _ids(3)
    got = m.output(x, False)
    torch.testing.assert_close(got, m.output(x), rtol=0, atol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.output(x, False)), **F32)
    # train is ignored by both; the mask is the third argument
    np.testing.assert_allclose(m.output(x, True).numpy(), np.asarray(jm.output(x, True)),
                               **F32)
    fm = np.ones((3, 16), np.float32)
    fm[1, 9:] = 0.0
    np.testing.assert_allclose(m.output(x, False, fm).numpy(),
                               np.asarray(jm.output(x, False, fm)), **F32)


@pytest.mark.parametrize("train", [False, True])
def test_feed_forward_takes_train_positionally(train):
    # TransformerLM has no dropout, so train mode changes nothing here and
    # both packages' activations agree layer by layer
    jm, m = _pair(seed=5)
    x = _ids(2, seed=3)
    got = m.feed_forward(x, train)
    want = jm.feed_forward(x, train)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)


# -- the served output's copy to the host --------------------------------------

@pytest.mark.parametrize("shape", [(65536,), (4, 128, 128), (2, 3, 0)])
@pytest.mark.parametrize("buffered", [False, True])
def test_to_host_widens_bf16_bit_for_bit(shape, buffered):
    n = int(np.prod(shape))
    # every bf16 bit pattern (NaNs with their payloads, +-inf, subnormals,
    # -0), cycled over the shape
    bits = (torch.arange(n, dtype=torch.int32) - 32768).to(torch.int16)
    out = bits.view(torch.bfloat16).reshape(shape)
    got = _to_host(out, _HostBuffer() if buffered else None)
    want = out.float().numpy()
    assert got.dtype == np.float32 and got.shape == tuple(shape)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    u16 = bits.numpy().view(np.uint16).reshape(shape)
    np.testing.assert_array_equal(got.view(np.uint32), u16.astype(np.uint32) << 16)
    if n == 65536:
        assert np.isnan(got).sum() == 254 and np.isinf(got).sum() == 2


def test_host_buffer_gives_each_thread_its_own_storage():
    buf = _HostBuffer()
    mine = buf.int16(1000)
    assert buf.int16(500).data_ptr() == mine.data_ptr()   # reused, not regrown
    theirs = []
    t = threading.Thread(target=lambda: theirs.append(buf.int16(1000)))
    t.start()
    t.join()
    assert theirs[0].data_ptr() != mine.data_ptr()


def test_to_host_from_two_threads_sharing_a_buffer():
    """The serving dispatchers of one model share one ``_HostBuffer``: each
    thread's result must be its own output's, however their copies and
    widenings interleave (torch releases the GIL in both)."""
    buf = _HostBuffer()
    outs = [torch.full((1 << 18,), float(v), dtype=torch.bfloat16) for v in (1.5, -3.0)]
    bad = []
    start = threading.Barrier(2)

    def run(out):
        want = out.float().numpy()
        start.wait()
        for _ in range(100):
            if not np.array_equal(_to_host(out, buf), want):
                bad.append(float(want[0]))

    threads = [threading.Thread(target=run, args=(o,)) for o in outs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not bad, f"{len(bad)} results carried the other thread's output"


def test_to_host_leaves_other_dtypes_as_they_are():
    x = torch.randn(3, 5)
    np.testing.assert_array_equal(_to_host(x), x.numpy())
    np.testing.assert_array_equal(_to_host([1, 2]), np.array([1, 2]))


# -- the embedding: jnp.take's semantics, no host read --------------------------

@pytest.mark.parametrize("kind", ["in_range", "negative", "out_of_range", "mixed"])
def test_embedding_apply_matches_jnp_take(kind):
    V, C = 11, 6
    W = np.random.RandomState(1).randn(V, C).astype(np.float32)
    ids = {"in_range": [[0, 3, 10, 5]],
           "negative": [[-1, -11, -5, -3]],
           "out_of_range": [[11, 40, -12, -100]],
           "mixed": [[-11, 0, 10, 11], [-12, 7, -1, 3]]}[kind]
    idx = np.asarray(ids, np.int32)
    want = np.asarray(jnp.take(jnp.asarray(W), jnp.asarray(idx), axis=0))
    layer = EmbeddingSequence(n_in=V, n_out=C)
    got, _ = layer.apply({"W": torch.from_numpy(W)}, (), torch.from_numpy(idx))
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
    np.testing.assert_array_equal(got.numpy(), want)
    # [B, T, 1] ids take the same rows
    got3, _ = layer.apply({"W": torch.from_numpy(W)}, (), torch.from_numpy(idx)[..., None])
    np.testing.assert_array_equal(got3.numpy(), want)


def test_embedding_apply_reads_nothing_back(monkeypatch):
    """The gather computes without converting a tensor to a Python bool or
    number, so no device sync (and a CUDA graph may capture it)."""
    def boom(*a, **k):
        raise AssertionError("the embedding read a tensor back to the host")

    layer = EmbeddingSequence(n_in=7, n_out=3)
    W = torch.randn(7, 3)
    idx = torch.tensor([[0, 6, -7, 9]])
    monkeypatch.setattr(torch.Tensor, "__bool__", boom)
    monkeypatch.setattr(torch.Tensor, "item", boom)
    got, _ = layer.apply({"W": W}, (), idx)
    monkeypatch.undo()
    assert torch.isnan(got[0, 3]).all() and torch.equal(got[0, 2], W[0])


@pytest.mark.parametrize("bad", [[64, 1], [-1, 2]])
def test_host_ids_outside_the_vocab_raise_before_the_copy(bad):
    _, m = _pair()
    x = _ids(2)
    x[1, :2] = bad
    with pytest.raises(ValueError, match=r"embedding ids must lie in \[0, 64\)"):
        m.output(x)
    with pytest.raises(ValueError, match="embedding ids"):
        m.output(torch.from_numpy(x))
    with pytest.raises(ValueError, match="embedding ids"):
        m.feed_forward(x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_norm_rows_do_not_depend_on_the_batch(dtype):
    from deeplearning4j_tpu_torch.nn.layers.normalization import layer_norm

    g = torch.Generator().manual_seed(8)
    x = (torch.randn(8, 3, 256, generator=g) * 3 + 1).to(dtype)
    gam, bet = (torch.randn(256, generator=g).to(dtype) for _ in range(2))
    full = layer_norm(x, gam, bet)
    for b in (1, 3):
        for r in range(0, 8 - b + 1, b):
            assert torch.equal(layer_norm(x[r:r + b], gam, bet), full[r:r + b])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_the_jax_package(dtype):
    from deeplearning4j_tpu.nn.layers.normalization import layer_norm as jlayer_norm
    from deeplearning4j_tpu_torch.nn.layers.normalization import layer_norm

    rs = np.random.RandomState(9)
    x, gam, bet = (rs.randn(*s).astype(np.float32) for s in ((4, 5, 64), (64,), (64,)))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = np.asarray(jlayer_norm(*(jnp.asarray(a, jdt) for a in (x, gam, bet))).astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = layer_norm(*(torch.from_numpy(a).to(tdt) for a in (x, gam, bet))).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32)
    else:   # one bf16 ulp where the normalised value rounds the other way
        assert np.abs(got - want).max() <= 2 ** -7 * (np.abs(want).max() + 1)
