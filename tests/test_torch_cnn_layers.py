"""Per-layer parity of the port's classic layers against the JAX package:
the 35 layer types of ``nn/layers/{core, convolution, pooling,
normalization}.py`` ported with LeNet-5 and SimpleCNN, and the 7
preprocessors. Each case builds the layer in both packages from one JSON
dict (so the JSON is read both ways), compares output types, takes the
JAX package's params (and state), perturbed from a numpy seed so that
zero-initialised ones count, and holds the port's f32 ``apply`` to the JAX
layer's. Gradients with respect to params and input follow for the layers
with weights or windows; BatchNorm's train mode compares outputs and new
state, with and without example weights."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeplearning4j_tpu.nn.layers  # noqa: F401  (registers the JAX tags)
from deeplearning4j_tpu.nn import preprocessors as jpp
from deeplearning4j_tpu.nn.config import LayerConfig as JLayerConfig
from deeplearning4j_tpu.nn.input_type import InputType as JInputType
import deeplearning4j_tpu_torch.nn.layers  # noqa: F401  (registers the port's tags)
from deeplearning4j_tpu_torch.nn import preprocessors as pp
from deeplearning4j_tpu_torch.nn.config import LayerConfig
from deeplearning4j_tpu_torch.nn.input_type import InputType

F32 = dict(rtol=1e-4, atol=1e-5)   # one layer's f32 forward, sums regrouped


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


def conv(h, w, c):
    return {"kind": "conv", "height": h, "width": w, "channels": c}


def rec(f, t):
    return {"kind": "recurrent", "size": f, "timesteps": t}


def ff(n):
    return {"kind": "ff", "size": n}


def flat(h, w, c):
    return {"kind": "conv_flat", "size": h * w * c, "height": h, "width": w, "channels": c}


# (JSON tag, fields, input type, masked) — every new layer type and every
# preprocessor at least once; SAME at stride 1 and 2 on odd sizes,
# truncate with padding, dilation, masks on the 1-D layers
CASES = [
    # core
    ("dense", {"n_out": 5, "activation": "tanh"}, ff(7), False),
    ("dense", {"n_out": 4, "activation": "relu"}, rec(6, 5), False),
    ("output", {"n_out": 4, "activation": "softmax", "loss": "mcxent"}, ff(6), False),
    ("loss", {"activation": "softmax", "loss": "mcxent"}, ff(5), False),
    ("activation", {"activation": "sigmoid"}, conv(4, 5, 3), False),
    ("leaky_relu_layer", {"alpha": 0.2}, ff(9), False),
    ("elu_layer", {"alpha": 0.7}, rec(4, 5), False),
    ("thresholded_relu_layer", {"theta": 0.3}, ff(9), False),
    ("prelu", {}, conv(5, 4, 3), False),
    ("permute", {"dims": [2, 1]}, rec(6, 4), False),
    ("permute", {"dims": [3, 1, 2]}, conv(4, 5, 3), False),
    ("repeat_vector", {"n": 3}, ff(5), False),
    ("dropout", {"dropout": 0.3}, ff(8), False),
    ("spatial_dropout", {"dropout": 0.4}, conv(4, 4, 3), False),
    ("gaussian_noise", {"stddev": 0.2}, ff(8), False),
    ("gaussian_dropout", {"rate": 0.3}, rec(5, 3), False),
    ("alpha_dropout", {"dropout": 0.2}, ff(8), False),
    ("embedding", {"n_in": 9, "n_out": 4, "has_bias": True, "activation": "tanh"},
     ff(1), False),
    ("autoencoder", {"n_out": 4}, ff(6), False),
    # convolution
    ("conv2d", {"n_out": 4, "kernel": [3, 3], "convolution_mode": "same"}, conv(9, 9, 3), False),
    ("conv2d", {"n_out": 4, "kernel": [3, 3], "stride": [2, 2], "convolution_mode": "same",
                "activation": "relu"}, conv(9, 11, 2), False),
    ("conv2d", {"n_out": 3, "kernel": [4, 2], "stride": [2, 3], "convolution_mode": "same"},
     conv(11, 10, 2), False),
    ("conv2d", {"n_out": 3, "kernel": [3, 3], "stride": [2, 2], "padding": [1, 2]},
     conv(9, 8, 2), False),
    ("conv2d", {"n_out": 3, "kernel": [3, 3], "dilation": [2, 2]}, conv(9, 10, 2), False),
    ("conv2d", {"n_out": 3, "kernel": [3, 2], "dilation": [2, 3], "stride": [2, 1],
                "convolution_mode": "same"}, conv(9, 10, 2), False),
    ("conv2d", {"n_out": 3, "kernel": [3, 3], "stride": [2, 2], "padding": [1, 1],
                "convolution_mode": "strict"}, conv(9, 9, 2), False),
    ("deconv2d", {"n_out": 3, "kernel": [3, 3], "stride": [2, 2], "padding": [1, 1]},
     conv(5, 4, 2), False),
    ("deconv2d", {"n_out": 3, "kernel": [3, 3], "stride": [2, 2],
                  "convolution_mode": "same"}, conv(5, 4, 2), False),
    ("deconv2d", {"n_out": 2, "kernel": [4, 2], "stride": [3, 2],
                  "convolution_mode": "same"}, conv(4, 5, 2), False),
    ("deconv2d", {"n_out": 2, "kernel": [2, 3], "stride": [1, 1]}, conv(4, 5, 3), False),
    ("depthwise_conv2d", {"kernel": [3, 3], "depth_multiplier": 2, "stride": [2, 2],
                          "convolution_mode": "same"}, conv(9, 9, 3), False),
    ("depthwise_conv2d", {"kernel": [2, 3], "depth_multiplier": 1, "padding": [1, 0]},
     conv(6, 7, 4), False),
    ("separable_conv2d", {"n_out": 5, "kernel": [3, 3], "depth_multiplier": 2,
                          "convolution_mode": "same"}, conv(7, 9, 3), False),
    ("separable_conv2d", {"n_out": 4, "kernel": [3, 3], "stride": [2, 2],
                          "padding": [1, 1]}, conv(9, 8, 2), False),
    ("conv1d", {"n_out": 4, "kernel": 3, "stride": 2, "convolution_mode": "same"},
     rec(5, 9), True),
    ("conv1d", {"n_out": 3, "kernel": 3, "padding": 1, "dilation": 2}, rec(4, 11), True),
    ("subsampling2d", {"pooling": "max"}, conv(9, 9, 3), False),
    ("subsampling2d", {"pooling": "avg", "kernel": [3, 3], "stride": [2, 2],
                       "convolution_mode": "same"}, conv(9, 9, 3), False),
    ("subsampling2d", {"pooling": "sum", "kernel": [2, 2], "stride": [2, 2],
                       "convolution_mode": "same"}, conv(7, 7, 2), False),
    ("subsampling2d", {"pooling": "pnorm", "pnorm": 3, "kernel": [3, 2], "stride": [1, 2],
                       "padding": [1, 1]}, conv(8, 7, 2), False),
    ("subsampling2d", {"pooling": "max", "kernel": [2, 2], "stride": [2, 2],
                       "convolution_mode": "same"}, conv(7, 7, 2), False),
    ("subsampling1d", {"pooling": "max", "kernel": 3, "stride": 2,
                       "convolution_mode": "same"}, rec(4, 9), True),
    ("subsampling1d", {"pooling": "avg", "kernel": 2, "stride": 1, "padding": 1},
     rec(4, 7), True),
    ("subsampling1d", {"pooling": "sum"}, rec(3, 8), False),
    ("subsampling1d", {"pooling": "pnorm", "pnorm": 2, "kernel": 3, "stride": 3},
     rec(3, 9), False),
    ("upsampling2d", {"size": [2, 3]}, conv(3, 4, 2), False),
    ("upsampling1d", {"size": 2}, rec(3, 5), True),
    ("zero_padding1d", {"padding": [1, 2]}, rec(3, 5), True),
    ("cropping1d", {"crop": [1, 2]}, rec(3, 8), True),
    ("zero_padding2d", {"padding": [1, 2, 0, 1]}, conv(4, 5, 2), False),
    ("zero_padding2d", {"padding": [1, 2]}, conv(4, 5, 2), False),
    ("cropping2d", {"crop": [1, 0, 2, 1]}, conv(6, 7, 2), False),
    ("space_to_depth", {"block": 2}, conv(8, 6, 3), False),
    ("depth_to_space", {"block": 2}, conv(3, 4, 8), False),
    # pooling
    ("global_pooling", {"pooling": "max"}, conv(5, 6, 3), False),
    ("global_pooling", {"pooling": "avg"}, rec(4, 7), True),
    ("global_pooling", {"pooling": "sum"}, rec(4, 7), True),
    ("global_pooling", {"pooling": "pnorm", "pnorm": 3}, conv(5, 4, 3), False),
    ("global_pooling", {"pooling": "max"}, rec(4, 7), True),
    ("global_pooling", {"pooling": "pnorm"}, rec(4, 6), True),
    # normalization
    ("batch_norm", {}, conv(5, 6, 4), False),
    ("batch_norm", {"use_gamma_beta": False, "eps": 1e-3}, ff(6), False),
    ("lrn", {}, conv(4, 5, 7), False),
    ("lrn", {"k": 1.0, "n": 4, "alpha": 0.1, "beta": 0.5}, conv(3, 3, 6), False),
    # preprocessors
    ("pp_cnn_to_ff", {}, conv(3, 4, 2), False),
    ("pp_ff_to_cnn", {"height": 3, "width": 2, "channels": 2}, ff(12), False),
    ("pp_rnn_to_ff", {}, rec(5, 4), True),
    ("pp_ff_to_rnn", {"timesteps": 3}, ff(5), False),
    ("pp_cnn_to_rnn", {}, conv(4, 3, 2), False),
    ("pp_rnn_to_cnn", {"height": 2, "width": 3, "channels": 2}, rec(4, 3), False),
    ("reshape", {"shape": [3, 4]}, ff(12), False),
]

NEW_TYPES = {
    "dense", "output", "loss", "activation", "leaky_relu_layer", "elu_layer",
    "thresholded_relu_layer", "prelu", "permute", "repeat_vector", "dropout",
    "spatial_dropout", "gaussian_noise", "gaussian_dropout", "alpha_dropout", "embedding",
    "autoencoder", "conv2d", "deconv2d", "depthwise_conv2d", "separable_conv2d", "conv1d",
    "subsampling1d", "subsampling2d", "upsampling1d", "upsampling2d", "zero_padding1d",
    "cropping1d", "zero_padding2d", "cropping2d", "space_to_depth", "depth_to_space",
    "global_pooling", "batch_norm", "lrn"}
PREPROCESSORS = {"pp_cnn_to_ff", "pp_ff_to_cnn", "pp_rnn_to_ff", "pp_ff_to_rnn",
                 "pp_cnn_to_rnn", "pp_rnn_to_cnn", "reshape"}


def _id(case):
    tag, fields, it, masked = case
    extra = "-".join(f"{k}={v}" for k, v in sorted(fields.items())
                     if k not in ("activation", "loss"))
    return f"{tag}[{it['kind']}{'-masked' if masked else ''}{'-' + extra if extra else ''}]"


def test_the_cases_cover_every_new_type_and_preprocessor():
    tags = {c[0] for c in CASES}
    assert len(NEW_TYPES) == 35 and len(PREPROCESSORS) == 7
    assert tags == NEW_TYPES | PREPROCESSORS


def _pair(tag, fields):
    d = {"@type": tag, **fields}
    jl = JLayerConfig.from_dict(json.loads(json.dumps(d)))
    tl = LayerConfig.from_dict(json.loads(json.dumps(d)))
    return jl, tl


def _input(it: dict, seed: int, B: int = 3):
    t = InputType.from_dict(it)
    shape = t.batch_shape(B)
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _perturbed(tree, seed):
    """Every leaf replaced by seeded normal values of its shape (positive
    for a running variance), so that zero- or one-initialised params
    count."""
    rs = np.random.RandomState(seed)
    out = {}
    for k in sorted(tree):
        v = np.asarray(tree[k])
        if isinstance(tree[k], dict):
            out[k] = _perturbed(tree[k], seed + 1)
        elif k == "var":
            out[k] = rs.uniform(0.5, 1.5, v.shape).astype(np.float32)
        else:
            out[k] = (0.5 * rs.randn(*v.shape)).astype(np.float32)
    return out


def _mask(it: dict, seed: int, B: int = 3):
    T = it["timesteps"]
    lens = np.random.RandomState(seed + 7).randint(1, T + 1, (B,))
    lens[0] = T
    return (np.arange(T)[None] < lens[:, None]).astype(np.float32)


def _setup(case, seed=0):
    tag, fields, it, masked = case
    jl, tl = _pair(tag, fields)
    jit, tit = JInputType.from_dict(it), InputType.from_dict(it)
    jp = jl.init(jax.random.PRNGKey(seed), jit, jnp.float32)
    p = _perturbed(jax.tree_util.tree_map(np.asarray, jp), seed)
    js = jl.init_state(jit)
    s = _perturbed(jax.tree_util.tree_map(np.asarray, js), seed + 11) if js else {}
    if tag == "embedding":
        x = np.random.RandomState(seed).randint(0, fields["n_in"], (5, 1))
    else:
        x = _input(it, seed)
    m = _mask(it, seed) if masked else None
    return jl, tl, jit, tit, p, s, x, m


def _t(tree):
    return {k: _t(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
            for k, v in tree.items()}


def _j(tree):
    return {k: _j(v) if isinstance(v, dict) else jnp.asarray(v) for k, v in tree.items()}


def _apply_both(jl, tl, p, s, x, m, train=False, **kw):
    jy, js = jl.apply(_j(p), _j(s), jnp.asarray(x), train=train, rng=None,
                      mask=None if m is None else jnp.asarray(m),
                      **{k: jnp.asarray(v) for k, v in kw.items()})
    ty, ts = tl.apply(_t(p), _t(s), torch.from_numpy(np.array(x)), train=train, rng=None,
                      mask=None if m is None else torch.from_numpy(m),
                      **{k: torch.from_numpy(v) for k, v in kw.items()})
    return (np.asarray(jy), jax.tree_util.tree_map(np.asarray, js)), (ty, ts)


@pytest.mark.parametrize("case", CASES, ids=[_id(c) for c in CASES])
def test_json_reads_and_writes_both_ways(case):
    tag, fields, _, _ = case
    jl, tl = _pair(tag, fields)
    d = jl.to_dict()
    assert tl.to_dict() == d
    assert LayerConfig.from_json(tl.to_json()) == tl
    assert JLayerConfig.from_json(tl.to_json()).to_dict() == d


@pytest.mark.parametrize("case", CASES, ids=[_id(c) for c in CASES])
def test_forward_matches_jax(case):
    jl, tl, jit, tit, p, s, x, m = _setup(case)
    assert tl.output_type(tit).to_dict() == jl.output_type(jit).to_dict()
    (jy, _), (ty, ts) = _apply_both(jl, tl, p, s, x, m)
    assert tuple(ty.shape) == jy.shape
    if case[3]:   # masked time steps: the pooled rows are compared where defined
        assert np.isfinite(jy).all()
    np.testing.assert_allclose(ty.numpy(), jy, **F32)
    want = jl.output_type(jit).batch_shape(x.shape[0])
    if case[0] not in ("pp_rnn_to_ff", "pp_ff_to_rnn", "embedding"):
        assert tuple(ty.shape) == want
    if m is not None:
        jm = jl.propagate_mask(jnp.asarray(m), jit)
        tm = tl.propagate_mask(torch.from_numpy(m), tit)
        assert (jm is None) == (tm is None)
        if jm is not None:
            np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


STRICT = [
    ({"n_out": 2, "kernel": [3, 3], "stride": [2, 2], "convolution_mode": "strict"},
     conv(8, 9, 2)),
    ({"n_out": 2, "kernel": [2, 2], "stride": [4, 4], "padding": [1, 1],
      "convolution_mode": "strict"}, conv(9, 9, 2)),
]


@pytest.mark.parametrize("fields,it", STRICT)
@pytest.mark.parametrize("tag", ["conv2d", "subsampling2d"])
def test_strict_mode_raises_where_the_jax_package_raises(tag, fields, it):
    if tag == "subsampling2d":
        fields = {k: v for k, v in fields.items() if k != "n_out"}
    jl, tl = _pair(tag, fields)
    with pytest.raises(ValueError, match="Strict"):
        jl.output_type(JInputType.from_dict(it))
    with pytest.raises(ValueError, match="Strict"):
        tl.output_type(InputType.from_dict(it))


def test_embedding_ids_of_rank_one_and_out_of_range():
    jl, tl = _pair("embedding", {"n_in": 9, "n_out": 4})
    p = _perturbed(jax.tree_util.tree_map(
        np.asarray, jl.init(jax.random.PRNGKey(0), JInputType.feed_forward(1), jnp.float32)), 0)
    for ids in (np.array([0, 3, 8, -2]), np.array([[1], [9], [-10], [2]])):
        want = np.asarray(jl.apply(_j(p), {}, jnp.asarray(ids))[0])
        got = tl.apply(_t(p), {}, torch.from_numpy(ids))[0].numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, **F32)
    with pytest.raises(ValueError, match=r"\[0, 9\)"):
        tl.check_host_ids(torch.tensor([3, 9]), 9)


# -- gradients ----------------------------------------------------------------

GRAD_CASES = [c for c in CASES if c[0] in (
    "conv2d", "deconv2d", "depthwise_conv2d", "separable_conv2d", "conv1d",
    "subsampling2d", "lrn", "dense", "output")]


def _grads_both(jl, tl, p, s, x, m, train=False, ex_weight=None):
    """d(sum(y * r)) / d(params, x) in both packages, r a seeded cotangent."""
    kw_j = {} if ex_weight is None else {"ex_weight": jnp.asarray(ex_weight)}
    kw_t = {} if ex_weight is None else {"ex_weight": torch.from_numpy(ex_weight)}
    jm = None if m is None else jnp.asarray(m)
    y0 = jl.apply(_j(p), _j(s), jnp.asarray(x), train=train, mask=jm, **kw_j)[0]
    r = np.random.RandomState(5).randn(*y0.shape).astype(np.float32)

    def jf(pp, xx):
        return jnp.sum(jl.apply(pp, _j(s), xx, train=train, mask=jm, **kw_j)[0] * r)

    jgp, jgx = jax.grad(jf, argnums=(0, 1))(_j(p), jnp.asarray(x))
    tp = {k: v.requires_grad_(True) for k, v in _t(p).items()}
    tx = torch.from_numpy(np.array(x)).requires_grad_(True)
    y = tl.apply(tp, _t(s), tx, train=train,
                 mask=None if m is None else torch.from_numpy(m), **kw_t)[0]
    (y * torch.from_numpy(r)).sum().backward()
    return (jax.tree_util.tree_map(np.asarray, jgp), np.asarray(jgx)), (
        {k: v.grad.numpy() for k, v in tp.items()}, tx.grad.numpy())


def _close_grads(got, want):
    (gp, gx), (wp, wx) = got, want
    assert gp.keys() == wp.keys()
    for k in wp:
        np.testing.assert_allclose(gp[k], wp[k], err_msg=k, rtol=1e-4,
                                   atol=1e-5 * max(1.0, np.abs(wp[k]).max()))
    np.testing.assert_allclose(gx, wx, rtol=1e-4, atol=1e-5 * max(1.0, np.abs(wx).max()))


@pytest.mark.parametrize("case", GRAD_CASES, ids=[_id(c) for c in GRAD_CASES])
def test_gradients_match_jax(case):
    jl, tl, _, _, p, s, x, m = _setup(case, seed=2)
    if case[0] == "output":   # the loss head: the score's gradient too
        y = np.eye(4, dtype=np.float32)[np.random.RandomState(3).randint(0, 4, len(x))]
        jg = jax.grad(lambda pp, xx: jl.score(pp, xx, jnp.asarray(y)), argnums=(0, 1))(
            _j(p), jnp.asarray(x))
        tp = {k: v.requires_grad_(True) for k, v in _t(p).items()}
        tx = torch.from_numpy(x).requires_grad_(True)
        tl.score(tp, tx, torch.from_numpy(y)).backward()
        _close_grads(({k: v.grad.numpy() for k, v in tp.items()}, tx.grad.numpy()),
                     (jax.tree_util.tree_map(np.asarray, jg[0]), np.asarray(jg[1])))
    want, got = _grads_both(jl, tl, p, s, x, m)
    _close_grads(got, want)


# -- BatchNorm: train mode, example weights, carried state ----------------------

BN_CASES = [
    ({}, conv(5, 6, 4)),
    ({"decay": 0.8}, ff(6)),
    ({"use_gamma_beta": False}, conv(4, 3, 3)),
]


@pytest.mark.parametrize("fields,it", BN_CASES)
@pytest.mark.parametrize("weighted", [False, True])
def test_batch_norm_train_mode_outputs_state_and_gradients(fields, it, weighted):
    case = ("batch_norm", fields, it, False)
    jl, tl, jit, tit, p, s, x, m = _setup(case, seed=4)
    x = x * 3.0 + 1.5   # channels with |mean| > std
    ew = None
    if weighted:   # the fit loop's padded tail: the last row weighted out
        ew = np.ones(len(x), np.float32)
        ew[-1] = 0.0
        x[-1] = 100.0   # whatever a padded row holds must not reach the stats
    kw = {} if ew is None else {"ex_weight": ew}
    (jy, js), (ty, ts) = _apply_both(jl, tl, p, s, x, m, train=True, **kw)
    rows = slice(0, len(x) - 1) if weighted else slice(None)
    np.testing.assert_allclose(ty.numpy()[rows], jy[rows], **F32)
    assert ts.keys() == js.keys() == {"mean", "var"}
    for k in ("mean", "var"):
        assert ts[k].dtype == torch.float32
        np.testing.assert_allclose(ts[k].numpy(), js[k], rtol=1e-5, atol=1e-6)
    if weighted:   # the statistics equal those of the unpadded rows alone
        (_, js2), _ = _apply_both(jl, tl, p, s, x[:-1], m, train=True)
        for k in ("mean", "var"):
            np.testing.assert_allclose(ts[k].numpy(), js2[k], rtol=1e-5, atol=1e-6)
    want, got = _grads_both(jl, tl, p, s, x, m, train=True, ex_weight=ew)
    _close_grads(got, want)


def test_batch_norm_eval_reads_the_carried_state():
    case = ("batch_norm", {}, conv(4, 4, 3), False)
    jl, tl, jit, tit, p, s, x, m = _setup(case, seed=6)
    (jy, js), (ty, ts) = _apply_both(jl, tl, p, s, x, m, train=False)
    np.testing.assert_allclose(ty.numpy(), jy, **F32)
    assert all(torch.equal(ts[k], torch.from_numpy(s[k])) for k in s)
    want, got = _grads_both(jl, tl, p, s, x, m)
    _close_grads(got, want)


def test_batch_norm_bf16_keeps_f32_statistics():
    tl = LayerConfig.from_dict({"@type": "batch_norm"})
    it = InputType.convolutional(4, 4, 3)
    x = torch.from_numpy(_input(conv(4, 4, 3), 8) * 4 + 2).to(torch.bfloat16)
    p = tl.init(torch.Generator().manual_seed(0), it, torch.bfloat16)
    y, st = tl.apply(p, tl.init_state(it), x, train=True)
    assert y.dtype == torch.bfloat16
    assert st["mean"].dtype == st["var"].dtype == torch.float32
    xf = x.float()
    np.testing.assert_allclose(st["mean"].numpy(), 0.1 * xf.mean((0, 1, 2)).numpy(),
                               rtol=1e-5, atol=1e-6)


# -- train-mode noise, on the port alone ----------------------------------------

@pytest.mark.parametrize("tag,fields", [("dropout", {"dropout": 0.3}),
                                        ("spatial_dropout", {"dropout": 0.4}),
                                        ("alpha_dropout", {"dropout": 0.2}),
                                        ("gaussian_dropout", {"rate": 0.3}),
                                        ("gaussian_noise", {"stddev": 0.5})])
def test_train_mode_noise_on_the_port(tag, fields):
    """The share dropped, the mean kept (inverted scaling), a fixed seed
    repeating, and identity in eval mode."""
    tl = LayerConfig.from_dict({"@type": tag, **fields})
    assert tl.uses_rng()
    x = torch.full((400, 6, 50), 2.0)
    y1 = tl.apply({}, {}, x, train=True, rng=torch.Generator().manual_seed(3))[0]
    y2 = tl.apply({}, {}, x, train=True, rng=torch.Generator().manual_seed(3))[0]
    assert torch.equal(y1, y2)
    assert torch.equal(tl.apply({}, {}, x, train=False)[0], x)
    with pytest.raises(ValueError, match="rng"):
        tl.apply({}, {}, x, train=True, rng=None)
    if tag in ("dropout", "spatial_dropout"):
        p = fields["dropout"]
        zero = (y1 == 0).float()
        assert abs(zero.mean().item() - p) < 0.02
        assert abs(y1.mean().item() - 2.0) < 0.05
        if tag == "spatial_dropout":   # whole channels: one draw per [batch, channel]
            assert torch.equal(zero.amin(1), zero.amax(1))
    elif tag == "alpha_dropout":
        # SELU-preserving: for unit-variance zero-mean input, mean ~0, var ~1
        z = torch.randn(400, 6, 50, generator=torch.Generator().manual_seed(1))
        yz = tl.apply({}, {}, z, train=True, rng=torch.Generator().manual_seed(4))[0]
        assert abs(yz.mean().item()) < 0.03 and abs(yz.var().item() - 1.0) < 0.05
    else:
        assert abs(y1.mean().item() - 2.0) < 0.05
        assert y1.std().item() > 0.1


# -- preprocessor inference -----------------------------------------------------

INFER = [
    (conv(6, 6, 3), "dense", {"n_out": 4}),
    (conv(6, 6, 3), "conv2d", {"n_out": 2}),
    (flat(6, 6, 3), "conv2d", {"n_out": 2}),
    (flat(6, 6, 3), "dense", {"n_out": 2}),
    (flat(6, 6, 3), "cropping2d", {"crop": [1, 1, 1, 1]}),
    (conv(6, 6, 3), "cropping2d", {"crop": [1, 1, 1, 1]}),
    (conv(6, 6, 3), "lstm", {"n_out": 4}),
    (conv(6, 6, 3), "conv1d", {"n_out": 4}),
    (conv(6, 6, 3), "batch_norm", {}),
    (conv(6, 6, 3), "global_pooling", {}),
    (conv(6, 6, 3), "dropout", {}),
    (conv(6, 6, 3), "prelu", {}),
    (rec(5, 4), "dense", {"n_out": 3}),
    (rec(5, 4), "subsampling1d", {}),
    (ff(5), "dense", {"n_out": 3}),
    (flat(4, 4, 2), "space_to_depth", {}),
    (flat(4, 4, 2), "subsampling2d", {}),
    (flat(4, 4, 2), "lrn", {}),
]


@pytest.mark.parametrize("it,tag,fields", INFER)
def test_infer_preprocessor_follows_the_jax_package(it, tag, fields):
    jl, tl = _pair(tag, fields)
    want = jpp.infer_preprocessor(JInputType.from_dict(it), jl)
    got = pp.infer_preprocessor(InputType.from_dict(it), tl)
    assert (want is None) == (got is None)
    if want is not None:
        assert got.to_dict() == want.to_dict()


def test_feed_forward_into_a_conv_layer_raises_in_both():
    jl, tl = _pair("conv2d", {"n_out": 2})
    with pytest.raises(ValueError, match="convolutional_flat"):
        jpp.infer_preprocessor(JInputType.feed_forward(8), jl)
    with pytest.raises(ValueError, match="convolutional_flat"):
        pp.infer_preprocessor(InputType.feed_forward(8), tl)
