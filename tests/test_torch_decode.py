"""Decode engine parity: ``ops.flash_attention.decode_attention`` and
``nn.decode.DecodeProgram`` against the JAX package's on the same numpy
weights and prompts (a tiny f32 TransformerLM: vocab 29, max_len 64,
d_model 32, 4 heads, 2 blocks, as tests/test_generate.py), the
prefill/decode split against the port's own full forward, paged against
contiguous bit for bit, the layer-plan refusals, the capacity and the
signature grid.

Tolerances: f32 logits rtol 1e-4 / atol 1e-5 (the same products summed
in other orders by XLA and torch); bf16 attention outputs atol 2e-2 on
values of order 1 (a few bf16 ulps: XLA rounds the softmax's exp to bf16,
torch accumulates it in f32)."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.decode import DecodeProgram as JDecodeProgram
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JNetwork
from deeplearning4j_tpu.ops.flash_attention import decode_attention as jdecode_attention
from deeplearning4j_tpu_torch.interop import params_from_numpy
from deeplearning4j_tpu_torch.nn.decode import DecodeProgram
from deeplearning4j_tpu_torch.nn.input_type import InputType
from deeplearning4j_tpu_torch.nn.layers import Dense, OutputLayer
from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration, MultiLayerNetwork
from deeplearning4j_tpu_torch.ops.flash_attention import decode_attention

VOCAB = 29
MAX_LEN = 64
TINY = dict(vocab_size=VOCAB, max_len=MAX_LEN, d_model=32, n_heads=4, n_blocks=2)
F32 = dict(rtol=1e-4, atol=1e-5)
BF16_ATOL = 2e-2


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


_PAIRS = {}


def _pair(seed=7):
    """(JAX network, port network) with the same f32 weights."""
    if seed not in _PAIRS:
        jconf = jzoo.TransformerLM(dtype="float32", **TINY)
        jm = JNetwork(jconf).init(seed=seed)
        m = MultiLayerNetwork(MultiLayerConfiguration.from_json(jconf.to_json()),
                              device="cpu")
        params_from_numpy(m, jax.tree_util.tree_map(np.asarray, jm.params))
        _PAIRS[seed] = (jm, m)
    return _PAIRS[seed]


def _prompt(n, seed=0):
    return np.random.RandomState(seed).randint(0, VOCAB, size=n).tolist()


def _run(prog, prompt, n_gen, as_numpy):
    """Drive a DecodeProgram of either package by hand: chunked prefill,
    then one-token steps. Returns (greedy ids, [n_gen, V] logits)."""
    ladder = prog.ladder
    if prog.paged:
        npb = ladder.bucket(prog.max_pages)
        table = np.zeros((1, npb), np.int32)
        table[0, :prog.max_pages] = range(1, prog.max_pages + 1)
    else:
        table = np.zeros((1,), np.int32)
    cached, fed, out, logits = 0, 0, [], []
    while fed < len(prompt):
        chunk = prompt[fed:fed + prog.prefill_chunk]
        tc = ladder.bucket(len(chunk)) if len(chunk) > 1 else 1
        tokens = np.zeros((1, tc), np.int32)
        tokens[0, :len(chunk)] = chunk
        lg, ids = prog.dispatch(table, [cached], tokens, [len(chunk)])
        cached += len(chunk)
        fed += len(chunk)
    for i in range(n_gen):
        if i:
            lg, ids = prog.dispatch(table, [cached], [[out[-1]]], [1])
            cached += 1
        out.append(int(ids[0]))
        logits.append(as_numpy(lg))
    return out, np.concatenate(logits)


def _full_logits(m, toks):
    """The port's full forward over ``toks``: the logits head's
    preactivation at every position, [T, V] f32."""
    with torch.inference_mode():
        a = m._forward(m.params, m.state, np.asarray(toks)[None], train=False,
                       upto=len(m.layers) - 1)[0]
        return m.layers[-1].preactivation(m.params[-1], a)[0].float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_matches_jax(dtype):
    rs = np.random.RandomState(1)
    B, Tc, K, H, D = 3, 5, 24, 2, 8
    q, k, v = (rs.randn(B, n, H, D).astype(np.float32) for n in (Tc, K, K))
    pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11], [19, 20, 21, 22, 23]], np.int32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = np.asarray(jdecode_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                        jnp.asarray(pos)).astype(jnp.float32))
    got = decode_attention(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                           torch.from_numpy(pos).long())
    assert got.dtype == tdt and got.shape == (B, Tc, H, D)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, **F32)
    else:
        assert np.abs(got.float().numpy() - want).max() <= BF16_ATOL


def test_decode_attention_masks_by_position():
    # garbage (finite) past each row's position gets an exact-zero weight
    rs = np.random.RandomState(2)
    q, k, v = (torch.from_numpy(rs.randn(1, 1, 2, 8).astype(np.float32)),
               torch.from_numpy(rs.randn(1, 16, 2, 8).astype(np.float32)),
               torch.from_numpy(rs.randn(1, 16, 2, 8).astype(np.float32)))
    pos = torch.tensor([[5]])
    a = decode_attention(q, k, v, pos)
    k2, v2 = k.clone(), v.clone()
    k2[:, 6:] = 1e4
    v2[:, 6:] = -1e4
    assert torch.equal(a, decode_attention(q, k2, v2, pos))


@pytest.mark.parametrize("paged,prompt_len,chunk", [(True, 19, 8), (True, 5, 16),
                                                    (False, 23, 8)])
def test_program_matches_jax_program(paged, prompt_len, chunk):
    jm, m = _pair()
    kw = dict(page_tokens=8, max_batch=4, prefill_chunk=chunk, paged=paged)
    prompt = _prompt(prompt_len, seed=prompt_len)
    jids, jlog = _run(JDecodeProgram(jm, **kw), prompt, 6, np.asarray)
    ids, log = _run(DecodeProgram(m, **kw), prompt, 6, lambda t: t.numpy())
    assert ids == jids
    np.testing.assert_allclose(log, jlog, **F32)


def test_prefill_decode_split_matches_full_forward():
    _, m = _pair()
    prog = DecodeProgram(m, page_tokens=8, max_batch=4, prefill_chunk=8)
    prompt = _prompt(19, seed=3)   # spans 3 prefill chunks
    ids, logits = _run(prog, prompt, 6, lambda t: t.numpy())
    full = _full_logits(m, prompt + ids[:-1])
    np.testing.assert_allclose(logits, full[len(prompt) - 1:], **F32)
    assert ids == [int(i) for i in full[len(prompt) - 1:].argmax(-1)]


def test_paged_equals_contiguous_bit_for_bit():
    _, m = _pair()
    kw = dict(page_tokens=8, max_batch=4, prefill_chunk=16)
    paged = DecodeProgram(m, paged=True, **kw)
    contig = DecodeProgram(m, paged=False, **kw)
    for n, seed in ((5, 0), (12, 1), (23, 2)):
        p = _prompt(n, seed=seed)
        a_ids, a_log = _run(paged, p, 5, lambda t: t.numpy())
        b_ids, b_log = _run(contig, p, 5, lambda t: t.numpy())
        assert a_ids == b_ids
        assert np.array_equal(a_log, b_log)


def test_pools_are_zero_filled_and_warm_covers_the_grid():
    _, m = _pair()
    prog = DecodeProgram(m, page_tokens=8, max_batch=2, prefill_chunk=16)
    assert all(int(t.count_nonzero()) == 0 for p in prog.pools for t in p.values())
    H, D = 4, 8
    assert prog.pools[0]["k"].shape == (1 + 2 * 8, 8, H, D)
    assert prog.pool_bytes() == 2 * 2 * (1 + 2 * 8) * 8 * H * D * 4
    n = prog.warm()
    assert n == len(prog.signature_grid()) and prog.warmed == set(prog.signature_grid())
    _run(prog, _prompt(13, seed=5), 4, lambda t: t.numpy())
    assert prog.shapes_seen and prog.off_grid_dispatches == 0
    assert prog.shapes_seen <= prog.warmed
    # a shape the warm pass never ran is counted
    prog.dispatch(np.zeros((3, 1), np.int64), [0, 0, 0], [[1], [1], [1]], [1, 1, 1])
    assert prog.off_grid_dispatches == 1


def test_rejects_models_without_decode_path():
    conf = MultiLayerConfiguration(
        layers=(Dense(n_out=8, activation="tanh"),
                OutputLayer(n_out=2, activation="softmax")),
        input_type=InputType.feed_forward(4),
        updater={"type": "sgd", "lr": 0.1},
    )
    with pytest.raises(ValueError, match="no decode path"):
        DecodeProgram(MultiLayerNetwork(conf, device="cpu").init())


def test_rejects_an_moe_model_and_a_model_without_blocks():
    from deeplearning4j_tpu_torch.models import zoo

    moe = MultiLayerNetwork(zoo.TransformerLM(moe_experts=2, dtype="float32", **TINY),
                            device="cpu").init()
    with pytest.raises(ValueError, match="MixtureOfExperts.*no decode path"):
        DecodeProgram(moe)
    conf = MultiLayerConfiguration.from_json(
        zoo.TransformerLM(n_blocks=0, dtype="float32",
                          **{k: v for k, v in TINY.items() if k != "n_blocks"}).to_json())
    with pytest.raises(ValueError, match="no TransformerBlock"):
        DecodeProgram(MultiLayerNetwork(conf, device="cpu").init())


def test_capacity_from_positional_embedding():
    _, m = _pair()
    prog = DecodeProgram(m, page_tokens=8, max_batch=2, prefill_chunk=8)
    assert prog.capacity == MAX_LEN
    assert prog.max_pages == MAX_LEN // 8
    assert DecodeProgram(m, page_tokens=24, capacity=50).max_pages == 3


@pytest.mark.parametrize("kw", [
    dict(page_tokens=8, max_batch=4, prefill_chunk=16, paged=True),
    dict(page_tokens=8, max_batch=4, prefill_chunk=16, paged=False),
    dict(page_tokens=64, max_batch=8, prefill_chunk=64, paged=True),
    dict(page_tokens=5, max_batch=3, prefill_chunk=7, paged=True, capacity=40),
])
def test_signature_grid_equals_jax(kw):
    jm, m = _pair()
    assert DecodeProgram(m, **kw).signature_grid() == JDecodeProgram(jm, **kw).signature_grid()
