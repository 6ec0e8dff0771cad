"""The port's fused LSTM (``deeplearning4j_tpu_torch/ops/fused_lstm.py``) on
the CPU against the JAX package's ``fused_lstm(..., interpret=True)``, its
Pallas kernels run in the interpreter: outputs, h_T, c_T and the gradients
of zx, Wh, h0, c0 and the peepholes, with and without masks and peepholes,
with nonzero dh_T and dc_T. Every case of ``tests/test_fused_lstm.py`` is
here, the TPU wrapper's forced multi-chunk grid held against a prime T.

f32 tolerance: rtol 2e-4, atol 2e-4, the JAX package's own kernel-against-
oracle bound. bf16: finite, and within 2e-2 of the f32 result."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import deeplearning4j_tpu.ops.fused_lstm as JF
from deeplearning4j_tpu.nn.input_type import InputType as JInputType
from deeplearning4j_tpu.nn.layers.recurrent import GravesLSTM as JGravesLSTM
from deeplearning4j_tpu.nn.layers.recurrent import LSTM as JLSTM
from deeplearning4j_tpu_torch.nn.layers.recurrent import LSTM, GravesLSTM
from deeplearning4j_tpu_torch.ops import fused_lstm as fl

F32 = dict(rtol=2e-4, atol=2e-4)
CFGS = [(2, 6, 128), (3, 10, 128), (2, 5, 256)]


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    # another test module may leave tuning knobs in os.environ
    for k in list(os.environ):
        if k.startswith("DL4J_TPU_"):
            monkeypatch.delenv(k)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _rand(rs, *shape):
    return (rs.randn(*shape) * 0.3).astype(np.float32)


def _inputs(seed, B, T, H, peep=False):
    rs = np.random.RandomState(seed)
    d = {"zx": _rand(rs, B, T, 4 * H), "wh": _rand(rs, H, 4 * H),
         "h0": _rand(rs, B, H), "c0": _rand(rs, B, H)}
    if peep:
        d["peep"] = _rand(rs, 3 * H)
    return d


def _lens_mask(T, lens):
    return (np.arange(T)[None] < np.asarray(lens)[:, None]).astype(np.float32)


def _jax_run(d, mask=None):
    """JAX fused_lstm (interpreted kernels): outputs and the gradients of
    sum(out^2) + 0.5 sum(h_T) + 0.25 sum(c_T) (nonzero dh_T and dc_T)."""
    names = [k for k in ("zx", "wh", "h0", "c0", "peep") if k in d]
    m = None if mask is None else jnp.asarray(mask)

    def run(*a):
        kw = dict(zip(names, a))
        return JF.fused_lstm(kw["zx"], kw["wh"], kw["h0"], kw["c0"], m, kw.get("peep"),
                             interpret=True)

    def loss(*a):
        out, (hT, cT) = run(*a)
        return jnp.sum(out ** 2) + jnp.sum(hT * 0.5) + jnp.sum(cT * 0.25)

    args = [jnp.asarray(d[k]) for k in names]
    out, (hT, cT) = run(*args)
    grads = jax.jit(jax.grad(loss, argnums=tuple(range(len(names)))))(*args)
    return ([np.asarray(out), np.asarray(hT), np.asarray(cT)],
            {k: np.asarray(g) for k, g in zip(names, grads)})


def _port_run(d, mask=None):
    names = [k for k in ("zx", "wh", "h0", "c0", "peep") if k in d]
    t = {k: torch.tensor(d[k], requires_grad=True) for k in names}
    out, (hT, cT) = fl.fused_lstm(t["zx"], t["wh"], t["h0"], t["c0"],
                                  None if mask is None else torch.tensor(mask),
                                  t.get("peep"))
    loss = (out ** 2).sum() + (hT * 0.5).sum() + (cT * 0.25).sum()
    grads = torch.autograd.grad(loss, [t[k] for k in names])
    return ([x.detach().numpy() for x in (out, hT, cT)],
            {k: g.numpy() for k, g in zip(names, grads)})


def _assert_parity(d, mask=None, tol=F32):
    (jo, jg), (po, pg) = _jax_run(d, mask), _port_run(d, mask)
    for name, a, b in zip(("out", "hT", "cT"), po, jo):
        np.testing.assert_allclose(a, b, err_msg=name, **tol)
    assert pg.keys() == jg.keys()
    for k in jg:
        np.testing.assert_allclose(pg[k], jg[k], err_msg=f"d{k}", **tol)


class TestForward:
    @pytest.mark.parametrize("B,T,H", CFGS)
    def test_matches_jax(self, B, T, H):
        d = _inputs(0, B, T, H)
        (jo, _), (po, _) = _jax_run(d), _port_run(d)
        for name, a, b in zip(("out", "hT", "cT"), po, jo):
            np.testing.assert_allclose(a, b, err_msg=name, **F32)

    def test_masked_matches_jax(self):
        d = _inputs(1, 3, 8, 128)
        _assert_parity(d, _lens_mask(8, [8, 5, 2]))


class TestBackward:
    @pytest.mark.parametrize("B,T,H", CFGS)
    def test_grads_match_jax(self, B, T, H):
        _assert_parity(_inputs(2, B, T, H))

    def test_masked_grads_match_jax(self):
        m = np.array([[1, 1, 1, 0, 0, 0], [1, 1, 1, 1, 1, 0]], np.float32)
        _assert_parity(_inputs(3, 2, 6, 128), m)

    def test_row_masked_throughout(self):
        # the whole row carries h0/c0 through, outputs zeros and passes its
        # carry cotangents straight to dh0/dc0
        d = _inputs(12, 3, 7, 128, peep=True)
        m = _lens_mask(7, [7, 0, 3])
        _assert_parity(d, m)
        (out, hT, cT), _ = _port_run(d, m)
        assert not out[1].any()
        np.testing.assert_array_equal(hT[1], d["h0"][1])
        np.testing.assert_array_equal(cT[1], d["c0"][1])

    def test_bf16_finite_and_close(self):
        d = _inputs(4, 2, 4, 128)
        d["h0"] = np.zeros_like(d["h0"])
        d["c0"] = np.zeros_like(d["c0"])
        _bf16_case(d)


def _bf16_case(d):
    """bf16 inputs (the f32 values rounded to bf16): the port's bf16 output
    within 2e-2 of the JAX f32 result on the same rounded values, and of
    the JAX bf16 result; finite bf16 gradients."""
    bf = {k: torch.tensor(v).to(torch.bfloat16) for k, v in d.items()}
    rounded = {k: v.float().numpy() for k, v in bf.items()}
    f32_out = _jax_run(rounded)[0][0]
    out, _ = fl.fused_lstm(bf["zx"], bf["wh"], bf["h0"], bf["c0"], None, bf.get("peep"))
    np.testing.assert_allclose(out.float().numpy(), f32_out, rtol=0, atol=2e-2)
    jout, _ = JF.fused_lstm(*(jnp.asarray(rounded[k], jnp.bfloat16)
                              for k in ("zx", "wh", "h0", "c0")), None,
                            jnp.asarray(rounded["peep"], jnp.bfloat16) if "peep" in d else None,
                            interpret=True)
    np.testing.assert_allclose(out.float().numpy(), np.asarray(jout, np.float32),
                               rtol=0, atol=2e-2)
    leaves = {k: v.clone().requires_grad_(True) for k, v in bf.items()}
    o, _ = fl.fused_lstm(leaves["zx"], leaves["wh"], leaves["h0"], leaves["c0"], None,
                         leaves.get("peep"))
    grads = torch.autograd.grad(o.float().square().sum(), list(leaves.values()))
    for g in grads:
        assert g.dtype == torch.bfloat16 and torch.isfinite(g.float()).all()


def _layer_pair(jcls, cls, n_in, T, seed, peep_scale=None):
    """A JAX layer's params (nonzero peepholes when asked) and the port's
    layer over the same numpy weights."""
    rs = np.random.RandomState(seed)
    jl = jcls(n_out=128)
    jp = jl.init(jax.random.PRNGKey(seed), JInputType.recurrent(n_in, T))
    if peep_scale is not None:
        jp = {**jp, "peephole": jnp.asarray(_rand(rs, 3 * 128) * peep_scale)}
    p = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    x = rs.randn(2, T, n_in).astype(np.float32)
    return jl, jp, cls(n_out=128, n_in=n_in), p, x


class TestLayerPolicy:
    @pytest.mark.parametrize("policy", ["0", "1"])
    def test_forced_fused_matches_scan_layer(self, monkeypatch, policy):
        """The port's LSTM layer under DL4J_TPU_FUSED_LSTM=0 (the step loop)
        and =1 (the fused op) against the JAX layer's scan path."""
        jl, jp, layer, p, x = _layer_pair(JLSTM, LSTM, 16, 6, 5)
        monkeypatch.setenv("DL4J_TPU_FUSED_LSTM", "0")
        want, _ = jl.apply(jp, {}, jnp.asarray(x))
        monkeypatch.setenv("DL4J_TPU_FUSED_LSTM", policy)
        got, _ = layer.apply(p, {}, torch.tensor(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)

    def test_ineligible_configs_fall_back(self):
        for cfg in (dict(n_out=100), dict(n_out=128, activation="relu"),
                    dict(n_out=128), dict(n_out=256)):
            assert LSTM(**cfg)._fused_eligible() == JLSTM(**cfg)._fused_eligible()
        assert not LSTM(n_out=100)._fused_eligible()
        assert not LSTM(n_out=128, activation="relu")._fused_eligible()
        assert GravesLSTM(n_out=128)._fused_eligible()
        assert LSTM(n_out=256)._fused_eligible()


class TestPeephole:
    def test_forward_matches_jax(self):
        d = _inputs(6, 2, 6, 128, peep=True)
        (jo, _), (po, _) = _jax_run(d), _port_run(d)
        for name, a, b in zip(("out", "hT", "cT"), po, jo):
            np.testing.assert_allclose(a, b, err_msg=name, **F32)

    def test_grads_match_jax(self):
        _assert_parity(_inputs(7, 2, 5, 128, peep=True))

    def test_masked_peephole_grads(self):
        m = np.array([[1, 1, 0, 0], [1, 1, 1, 1]], np.float32)
        _assert_parity(_inputs(8, 2, 4, 128, peep=True), m)

    @pytest.mark.parametrize("policy", ["0", "1"])
    def test_graves_layer_forced_fused_matches_scan(self, monkeypatch, policy):
        jl, jp, layer, p, x = _layer_pair(JGravesLSTM, GravesLSTM, 12, 5, 9, 0.2)
        monkeypatch.setenv("DL4J_TPU_FUSED_LSTM", "0")
        want, _ = jl.apply(jp, {}, jnp.asarray(x))
        monkeypatch.setenv("DL4J_TPU_FUSED_LSTM", policy)
        got, _ = layer.apply(p, {}, torch.tensor(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)

    @pytest.mark.parametrize("T", [7, 11])
    def test_multichunk_grid_against_prime_T(self, monkeypatch, T):
        """The TPU wrapper forced to 2-step chunks (a padded tail at prime
        T, dpeep summed across chunks) against the port's one sweep."""
        monkeypatch.setattr(JF, "_pick_chunk", lambda *a: 2)
        _assert_parity(_inputs(10 + T, 2, T, 128, peep=True))

    def test_bf16_peephole_finite_and_close(self):
        d = _inputs(11, 2, 4, 128, peep=True)
        d["peep"] = d["peep"] * 0.2
        d["h0"] = np.zeros_like(d["h0"])
        d["c0"] = np.zeros_like(d["c0"])
        _bf16_case(d)


def test_reference_backward_follows_the_kernels_cast_points():
    """In bf16 the plain backward rounds dz to Wh's dtype before both
    products and sums in f32: dWh equals hprevᵀ·round(dz) summed in f32."""
    d = _inputs(13, 2, 3, 128, peep=True)
    bf = {k: torch.tensor(v).to(torch.bfloat16) for k, v in d.items()}
    hs, gates, cs, _, _ = fl.fused_lstm_reference(bf["zx"], bf["wh"], bf["h0"], bf["c0"],
                                                  None, bf["peep"])
    dout = torch.tensor(_rand(np.random.RandomState(0), 2, 3, 128))
    cprev, hprev, m, dhs = fl.bwd_operands(hs, cs, bf["h0"], bf["c0"], None, dout,
                                           torch.zeros(2, 128))
    dzx, dwh, *_ = fl.fused_lstm_bwd_reference(gates, cs, cprev, hprev, bf["wh"], m,
                                               dhs, torch.zeros(2, 128), bf["peep"])
    assert dzx.dtype == dwh.dtype == torch.float32
    want = sum(hprev[:, t].float().T @ dzx[:, t].to(torch.bfloat16).float()
               for t in range(3))
    torch.testing.assert_close(dwh, want, rtol=1e-6, atol=1e-6)
