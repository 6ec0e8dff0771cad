"""The port's updaters against ``deeplearning4j_tpu.train.updaters``: all ten
updaters, the LR policies, bf16 mixed precision and every gradient-
normalization mode, three steps each on a nested param tree, with the same
numpy params and gradients into both."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.train import updaters as jup
from deeplearning4j_tpu_torch.train import updaters as up
from deeplearning4j_tpu_torch.utils.tree import tree_leaves, tree_map

# f32 elementwise math on the same inputs; pow/exp/sqrt may differ by an
# ulp between XLA and torch and Adam divides by sqrt(v) ~ |g|
F32 = dict(rtol=2e-5, atol=1e-6)

UPDATERS = ["sgd", "adam", "adamax", "nadam", "amsgrad", "nesterovs", "adagrad",
            "adadelta", "rmsprop", "noop"]
POLICIES = [
    None,
    {"policy": "exponential", "decay_rate": 0.9},
    {"policy": "inverse", "gamma": 0.1, "power": 0.75},
    {"policy": "poly", "power": 2.0, "max_iter": 5},
    {"policy": "sigmoid", "gamma": 0.5, "step_size": 1},
    {"policy": "step", "decay_rate": 0.5, "step_size": 2},
    {"policy": "map", "schedule": {"0": 0.05, "2": 0.01}},
    {"policy": "warmup_cosine", "warmup": 1, "max_iter": 4, "min_lr": 1e-3},
]
NORMS = ["renormalize_l2_per_layer", "renormalizel2perparamtype",
         "clip_elementwise_absolute_value", "clipl2perlayer",
         "clip_l2_per_param_type", None]


def _tree(rs, scale=1.0):
    return {"W": rs.randn(3, 4).astype(np.float32) * scale,
            "b": rs.randn(4).astype(np.float32) * scale,
            "sub": {"g": rs.randn(2, 3).astype(np.float32) * scale}}


def _torch(tree, dtype=torch.float32):
    return tree_map(lambda a: torch.from_numpy(a).to(dtype), tree)


def _jax(tree, dtype=jnp.float32):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x.astype(jnp.float32))


def _run(spec, dtype=torch.float32, jdtype=jnp.float32, steps=3, seed=0):
    """Three steps in each package; per step the updates, then the final
    params and updater state, as f32 numpy lists in treedef order."""
    rs = np.random.RandomState(seed)
    params0 = _tree(rs)
    grads = [_tree(rs, 0.5) for _ in range(steps)]
    u, ju = up.make_updater(spec), jup.make_updater(spec)
    p, jp = _torch(params0, dtype), _jax(params0, jdtype)
    s, js = u.init(p), ju.init(jp)
    got, want = [], []
    for i, g in enumerate(grads):
        d, s = u.update(_torch(g, dtype), s, p, i)
        jd, js = ju.update(_jax(g, jdtype), js, jp, i)
        p = tree_map(lambda a, b: a - b, p, d)
        jp = jax.tree_util.tree_map(lambda a, b: a - b, jp, jd)
        got += [_f32(x) for x in tree_leaves(d)]
        want += [_f32(x) for x in jax.tree_util.tree_leaves(jd)]
    got += [_f32(x) for x in tree_leaves(p) + tree_leaves(s)]
    want += [_f32(x) for x in jax.tree_util.tree_leaves(jp) + jax.tree_util.tree_leaves(js)]
    return got, want, p, s


@pytest.mark.parametrize("name", UPDATERS)
def test_inplace_update_writes_the_same_bits_into_its_own_state(name):
    """``inplace=True`` (the model's step) gives the functional update's
    bits and keeps every state tensor it took."""
    rs = np.random.RandomState(1)
    p = _torch(_tree(rs))
    u = up.make_updater(name)
    s_fun, s_in = u.init(p), u.init(p)
    ptrs = [t.data_ptr() for t in tree_leaves(s_in)]
    for i in range(3):
        g = _torch(_tree(rs, 0.5))
        d_fun, s_fun = u.update(g, s_fun, p, i)
        d_in, s_in = u.update(g, s_in, p, i, inplace=True)
        assert [t.data_ptr() for t in tree_leaves(s_in)] == ptrs
        for a, b in zip(tree_leaves(d_fun) + tree_leaves(s_fun),
                        tree_leaves(d_in) + tree_leaves(s_in)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("name", UPDATERS)
def test_three_steps_match(name):
    got, want, _, _ = _run({"type": name})
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **F32)


@pytest.mark.parametrize("policy", POLICIES, ids=lambda p: (p or {}).get("policy", "constant"))
@pytest.mark.parametrize("name", ["sgd", "adam", "nesterovs"])
def test_lr_policies_match(policy, name):
    spec = {"type": name, "lr": 0.05, "schedule": policy}
    got, want, _, _ = _run(spec, steps=4)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **F32)


@pytest.mark.parametrize("policy", POLICIES[1:], ids=lambda p: p["policy"])
def test_schedule_values_are_f32(policy):
    for step in range(6):
        got = up.schedule_value(policy, 0.05, step)
        want = jup.schedule_value(policy, 0.05, step)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("name", ["sgd", "adam", "nesterovs", "rmsprop", "adadelta"])
def test_bf16_params_keep_f32_state(name):
    # bf16 params and grads, f32 moments; the delta is cast to bf16 and
    # p - delta rounds to bf16, in both packages
    got, want, p, s = _run({"type": name, "lr": 0.05}, torch.bfloat16, jnp.bfloat16)
    assert all(x.dtype == torch.bfloat16 for x in tree_leaves(p))
    assert all(x.dtype == torch.float32 for x in tree_leaves(s))
    for a, b in zip(got, want):
        # the f32 update math agrees to f32 rounding; a bf16 result differs
        # by at most one bf16 ulp where that rounding lands on a tie
        np.testing.assert_allclose(a, b, rtol=2 ** -8, atol=1e-6)


def test_momentum_schedule_and_aliases():
    spec = {"type": "momentum", "lr": 0.1, "momentum": 0.5,
            "momentum_schedule": {"policy": "step", "decay_rate": 2.0, "step_size": 2}}
    got, want, _, _ = _run(spec, steps=4)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **F32)
    assert up.normalize_updater("nesterov") == jup.normalize_updater("nesterov")
    assert up.normalize_updater(None) == jup.normalize_updater(None)
    assert up.scale_lr({"type": "adam", "lr": 0.01}, 0.5) == jup.scale_lr(
        {"type": "adam", "lr": 0.01}, 0.5)
    with pytest.raises(ValueError, match="Unknown updater"):
        up.normalize_updater("lbfgs")


@pytest.mark.parametrize("mode", NORMS)
@pytest.mark.parametrize("threshold", [0.3, 5.0])
def test_gradient_normalization_matches(mode, threshold):
    g = _tree(np.random.RandomState(4))
    got = up.apply_gradient_normalization(mode, threshold, _torch(g))
    want = jup.apply_gradient_normalization(mode, threshold, _jax(g))
    for a, b in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(_f32(a), _f32(b), **F32)


def test_unknown_gradient_normalization_raises():
    with pytest.raises(ValueError, match="gradient normalization"):
        up.apply_gradient_normalization("clip_everything", 1.0, _torch(_tree(np.random.RandomState(0))))
