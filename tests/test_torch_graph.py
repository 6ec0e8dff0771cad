"""ComputationGraph on the CPU against the JAX package, from the same numpy
weights (``params_from_numpy`` / ``state_from_numpy`` over the dict keyed
by vertex name): every vertex forward (masked too), a residual DAG with
BatchNorm, a two-input and a two-output graph (``output``, the loss, the
gradients per vertex, three ``fit`` steps of SGD and of Adam, BatchNorm's
state), the seq2seq graph at LSTM(128) (the fused LSTM's plain version on
the CPU), truncated BPTT, ``rnn_time_step``, JSON / YAML, and graph zips
written by either package and read by the other.

Tolerances: f32 forward and loss within 1e-5 relative (F32); gradients
and post-update params within 1e-4 relative with an atol scaled to each
tensor's largest entry (the sums regroup)."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.nn import graph as jg
from deeplearning4j_tpu.nn.input_type import InputType as JInputType
from deeplearning4j_tpu.nn.layers import BatchNorm as JBatchNorm
from deeplearning4j_tpu.nn.layers import Dense as JDense
from deeplearning4j_tpu.nn.layers import OutputLayer as JOutputLayer
from deeplearning4j_tpu.nn.layers.recurrent import LSTM as JLSTM
from deeplearning4j_tpu.nn.layers.recurrent import GravesLSTM as JGravesLSTM
from deeplearning4j_tpu.nn.layers.recurrent import RnnOutputLayer as JRnnOutputLayer
from deeplearning4j_tpu.nn.preprocessors import CnnToFeedForward as JCnnToFeedForward
from deeplearning4j_tpu.train.listeners import CollectScoresListener as JCollect
from deeplearning4j_tpu.utils import serialization as jser
from deeplearning4j_tpu_torch.interop import (
    params_from_numpy,
    params_to_numpy,
    state_from_numpy,
    state_to_numpy,
)
from deeplearning4j_tpu_torch.nn import graph as g
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph, ComputationGraphConfiguration
from deeplearning4j_tpu_torch.nn.input_type import InputType
from deeplearning4j_tpu_torch.train.listeners import CollectScoresListener
from deeplearning4j_tpu_torch.utils import serialization as ser
from deeplearning4j_tpu_torch.utils.tree import tree_leaves

F32 = dict(rtol=1e-5, atol=1e-6)      # f32 forward / loss: summation order differs
GRAD = dict(rtol=1e-4, atol=1e-5)     # gradients and params after updates


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


def _np(t):
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _flat(tree, prefix=""):
    """A nested dict / list tree as {"a.b.0.c": numpy array}."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}."))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}."))
    elif tree is not None:
        out[prefix.rstrip(".")] = _np(tree)
    return out


def _assert_trees_close(got, want, tol=GRAD, scaled=True):
    got, want = _flat(got), _flat(jax.tree_util.tree_map(np.asarray, want))
    assert got.keys() == want.keys()
    for k in want:
        atol = tol["atol"] * max(1.0, float(np.abs(want[k]).max())) if scaled else tol["atol"]
        np.testing.assert_allclose(got[k], want[k], err_msg=k, rtol=tol["rtol"], atol=atol)


def _pair(jconf, seed_state=True):
    """(JAX graph, port graph) with the same f32 params and vertex state
    (BatchNorm's running statistics drawn from a numpy seed, so eval mode
    reads non-trivial ones)."""
    jm = jg.ComputationGraph(jconf).init()
    if seed_state:
        rs = np.random.RandomState(9)
        jm.state = {k: ({"mean": jnp.asarray(0.3 * rs.randn(*s["mean"].shape), jnp.float32),
                         "var": jnp.asarray(rs.uniform(0.5, 1.5, s["var"].shape), jnp.float32)}
                        if s else s) for k, s in jm.state.items()}
    m = ComputationGraph(ComputationGraphConfiguration.from_json(jconf.to_json()),
                         device="cpu").init()
    params_from_numpy(m, jax.tree_util.tree_map(np.asarray, jm.params))
    state_from_numpy(m, jax.tree_util.tree_map(np.asarray, jm.state))
    return jm, m


# -- configurations -----------------------------------------------------------

def _residual(updater="sgd"):
    """Dense -> BatchNorm -> two branches joined by an add (the residual
    pattern: ``h`` feeds both the branch and the add), then a head."""
    return (jg.ComputationGraphConfiguration.builder()
            .add_inputs("in")
            .set_input_types(JInputType.feed_forward(6))
            .add_layer("h", JDense(n_out=8, activation="tanh"), "in")
            .add_layer("bn", JBatchNorm(), "h")
            .add_layer("b1", JDense(n_out=8, activation="relu"), "bn")
            .add_layer("b2", JDense(n_out=8, activation="identity", l2=1e-3), "b1")
            .add_vertex("add", jg.ElementWiseVertex(op="add"), "b2", "h")
            .add_layer("out", JOutputLayer(n_out=3, activation="softmax", loss="mcxent"), "add")
            .set_outputs("out").updater(updater).build())


def _two_input(updater="sgd"):
    return (jg.ComputationGraphConfiguration.builder()
            .add_inputs("a", "b")
            .set_input_types(JInputType.feed_forward(4), JInputType.feed_forward(3))
            .add_layer("ha", JDense(n_out=5, activation="tanh"), "a")
            .add_layer("hb", JDense(n_out=5, activation="sigmoid"), "b")
            .add_vertex("merge", jg.MergeVertex(), "ha", "hb")
            .add_vertex("prod", jg.ElementWiseVertex(op="product"), "ha", "hb")
            .add_vertex("cat", jg.MergeVertex(), "merge", "prod")
            .add_layer("out", JOutputLayer(n_out=3, activation="softmax", loss="mcxent"), "cat")
            .set_outputs("out").updater(updater).build())


def _two_output(updater="sgd"):
    return (jg.ComputationGraphConfiguration.builder()
            .add_inputs("in")
            .set_input_types(JInputType.feed_forward(5))
            .add_layer("h", JDense(n_out=7, activation="relu"), "in")
            .add_vertex("sub", jg.SubsetVertex(from_index=1, to_index=4), "h")
            .add_layer("cls", JOutputLayer(n_out=3, activation="softmax", loss="mcxent"), "h")
            .add_layer("reg", JOutputLayer(n_out=2, activation="identity", loss="mse"), "sub")
            .set_outputs("cls", "reg").updater(updater).build())


def _seq2seq(hidden=128, updater=None, tbptt=None, lstm=JGravesLSTM, vocab=7):
    """The seq2seq wiring of tests/test_graph.py: encoder LSTM -> last step
    -> duplicated over the decoder input's steps -> merged with it ->
    decoder LSTM -> RnnOutputLayer."""
    b = (jg.ComputationGraphConfiguration.builder()
         .add_inputs("enc_in", "dec_in")
         .set_input_types(JInputType.recurrent(vocab), JInputType.recurrent(vocab))
         .add_layer("enc", lstm(n_out=hidden, activation="tanh"), "enc_in")
         .add_vertex("last", jg.LastTimeStepVertex(), "enc")
         .add_vertex("dup", jg.DuplicateToTimeSeriesVertex(), "last", "dec_in")
         .add_vertex("merge", jg.MergeVertex(), "dec_in", "dup")
         .add_layer("dec", lstm(n_out=hidden, activation="tanh"), "merge")
         .add_layer("out", JRnnOutputLayer(n_out=vocab, activation="softmax", loss="mcxent"),
                    "dec")
         .set_outputs("out")
         .updater(updater or {"type": "rmsprop", "lr": 1e-3}))
    if tbptt:
        b.tbptt(tbptt)
    return b.build()


CONFS = {"residual": _residual, "two_input": _two_input, "two_output": _two_output}


def _batch(name, n, seed):
    rs = np.random.RandomState(seed)
    if name == "residual":
        return (rs.randn(n, 6).astype(np.float32),
                np.eye(3, dtype=np.float32)[rs.randint(0, 3, n)])
    if name == "two_input":
        return ((rs.randn(n, 4).astype(np.float32), rs.randn(n, 3).astype(np.float32)),
                np.eye(3, dtype=np.float32)[rs.randint(0, 3, n)])
    return (rs.randn(n, 5).astype(np.float32),
            (np.eye(3, dtype=np.float32)[rs.randint(0, 3, n)],
             rs.randn(n, 2).astype(np.float32)))


def _seq_batch(n, T_enc, T_dec, vocab=7, seed=0):
    rs = np.random.RandomState(seed)
    eye = np.eye(vocab, dtype=np.float32)
    return ((eye[rs.randint(0, vocab, (n, T_enc))], eye[rs.randint(0, vocab, (n, T_dec))]),
            eye[rs.randint(0, vocab, (n, T_dec))])


def _inputs(conf, f):
    f = f if isinstance(f, tuple) else (f,)
    return dict(zip(conf.inputs, f))


# -- vertices -----------------------------------------------------------------

def _rnd(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


_MASK = (np.arange(6)[None] < np.array([6, 3, 1])[:, None]).astype(np.float32)

VERTEX_CASES = [
    ("merge_ff", "MergeVertex", {}, [(3, 4), (3, 2)], None),
    ("merge_conv", "MergeVertex", {}, [(2, 3, 3, 2), (2, 3, 3, 5)], None),
    ("merge_rnn", "MergeVertex", {}, [(3, 6, 2), (3, 6, 3)], None),
    ("add", "ElementWiseVertex", {"op": "add"}, [(3, 4)] * 3, None),
    ("subtract", "ElementWiseVertex", {"op": "subtract"}, [(3, 4)] * 2, None),
    ("product", "ElementWiseVertex", {"op": "product"}, [(3, 4)] * 3, None),
    ("average", "ElementWiseVertex", {"op": "average"}, [(3, 4)] * 3, None),
    ("max", "ElementWiseVertex", {"op": "max"}, [(3, 4)] * 3, None),
    ("stack", "StackVertex", {}, [(3, 4), (3, 4)], None),
    ("unstack", "UnstackVertex", {"from_index": 1, "stack_size": 3}, [(6, 4)], None),
    ("subset", "SubsetVertex", {"from_index": 1, "to_index": 3}, [(3, 6, 5)], None),
    ("scale", "ScaleVertex", {"scale": -1.5}, [(3, 4)], None),
    ("shift", "ShiftVertex", {"shift": 0.25}, [(3, 4)], None),
    ("l2", "L2Vertex", {}, [(3, 2, 2), (3, 2, 2)], None),
    ("l2normalize", "L2NormalizeVertex", {}, [(3, 2, 3)], None),
    ("reshape", "ReshapeVertex", {"shape": (-1, 2, 3)}, [(4, 6)], None),
    ("last_time_step", "LastTimeStepVertex", {}, [(3, 6, 4)], None),
    ("last_time_step_masked", "LastTimeStepVertex", {}, [(3, 6, 4)], _MASK),
    ("duplicate_to_time_series", "DuplicateToTimeSeriesVertex", {}, [(3, 4), (3, 6, 2)],
     None),
    ("duplicate_to_time_series_masked", "DuplicateToTimeSeriesVertex", {},
     [(3, 4), (3, 6, 2)], _MASK),
    ("reverse_time_series", "ReverseTimeSeriesVertex", {}, [(3, 6, 2)], None),
    ("reverse_time_series_masked", "ReverseTimeSeriesVertex", {}, [(3, 6, 2)], _MASK),
]


@pytest.mark.parametrize("case", VERTEX_CASES, ids=[c[0] for c in VERTEX_CASES])
def test_vertex_forward_and_mask_match_jax(case):
    _, cls, kw, shapes, mask = case
    xs = [_rnd(i + 3, *s) for i, s in enumerate(shapes)]
    masks = None
    if mask is not None:
        masks = [mask] if len(xs) == 1 else [None, mask]
    jv, v = getattr(jg, cls)(**kw), getattr(g, cls)(**kw)
    jy, _ = jv.apply({}, {}, [jnp.asarray(x) for x in xs],
                     masks=None if masks is None else [None if m is None else jnp.asarray(m)
                                                       for m in masks])
    y, _ = v.apply({}, {}, [torch.from_numpy(x) for x in xs],
                   masks=None if masks is None else [None if m is None else torch.from_numpy(m)
                                                     for m in masks])
    assert tuple(y.shape) == jy.shape
    np.testing.assert_allclose(_np(y), np.asarray(jy), **F32)
    jm = jv.propagate_mask(masks, None)
    m = v.propagate_mask(None if masks is None else
                         [None if a is None else torch.from_numpy(a) for a in masks], None)
    assert (jm is None) == (m is None)
    if m is not None:
        np.testing.assert_array_equal(_np(m), np.asarray(jm))
    assert v.to_dict() == jv.to_dict()


def test_preprocessor_vertex_and_output_types_match_jax():
    from deeplearning4j_tpu_torch.nn.preprocessors import CnnToFeedForward

    x = _rnd(1, 2, 3, 3, 4)
    jv = jg.PreprocessorVertex(preprocessor=JCnnToFeedForward())
    v = g.PreprocessorVertex(preprocessor=CnnToFeedForward())
    np.testing.assert_array_equal(
        _np(v.apply({}, {}, [torch.from_numpy(x)])[0]),
        np.asarray(jv.apply({}, {}, [jnp.asarray(x)])[0]))
    assert v.to_dict() == jv.to_dict()
    assert g.PreprocessorVertex._decode(v.to_dict()) == v
    conv = [InputType.convolutional(3, 3, 2), InputType.convolutional(3, 3, 5)]
    jconv = [JInputType.convolutional(3, 3, 2), JInputType.convolutional(3, 3, 5)]
    for cls, kw, its, jits in (
            ("MergeVertex", {}, conv, jconv),
            ("SubsetVertex", {"from_index": 0, "to_index": 1}, conv[:1], jconv[:1]),
            ("L2Vertex", {}, conv, jconv),
            ("ReshapeVertex", {"shape": (-1, 6, 3)}, conv[:1], jconv[:1]),
            ("LastTimeStepVertex", {}, [InputType.recurrent(4, 6)],
             [JInputType.recurrent(4, 6)]),
            ("DuplicateToTimeSeriesVertex", {},
             [InputType.feed_forward(4), InputType.recurrent(2, 7)],
             [JInputType.feed_forward(4), JInputType.recurrent(2, 7)])):
        got = getattr(g, cls)(**kw).output_type(its).to_dict()
        assert got == getattr(jg, cls)(**kw).output_type(jits).to_dict(), cls


def test_every_vertex_type_is_registered_with_the_jax_tags():
    assert sorted(g.vertex_registry) == sorted(jg.vertex_registry)
    for tag, cls in g.vertex_registry.items():
        assert cls._vtype_name == tag


# -- configuration serde and topology -----------------------------------------

@pytest.mark.parametrize("make", [_residual, _two_input, _two_output,
                                  lambda: _seq2seq(tbptt=5)],
                         ids=["residual", "two_input", "two_output", "seq2seq_tbptt"])
def test_json_and_yaml_round_trip_across_packages(make):
    jconf = make()
    s = jconf.to_json()
    conf = ComputationGraphConfiguration.from_json(s)
    assert json.loads(conf.to_json()) == json.loads(s)
    assert jg.ComputationGraphConfiguration.from_json(conf.to_json()).to_dict() == jconf.to_dict()
    assert ComputationGraphConfiguration.from_yaml(conf.to_yaml()) == conf
    assert conf.to_dict()["format"] == "deeplearning4j_tpu/ComputationGraphConfiguration"


def test_builder_and_toposort_refuse_bad_graphs():
    b = ComputationGraphConfiguration.builder().add_inputs("in")
    with pytest.raises(ValueError, match="not defined"):
        b.add_vertex("x", g.ScaleVertex(), "nope")
    with pytest.raises(ValueError, match="set_input_types"):
        (ComputationGraphConfiguration.builder().add_inputs("in")
         .add_vertex("s", g.ScaleVertex(), "in").set_outputs("s").build())
    conf = ComputationGraphConfiguration(
        inputs=("in",), input_types={"in": InputType.feed_forward(2)},
        vertices={"a": g.VertexSpec(g.ScaleVertex(), ("b",)),
                  "b": g.VertexSpec(g.ScaleVertex(), ("a",))}, outputs=("a",))
    with pytest.raises(ValueError, match="cycle"):
        ComputationGraph(conf, device="cpu")


def test_default_device_is_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is taken, not refused")
    with pytest.raises(RuntimeError, match="CUDA"):
        ComputationGraph(ComputationGraphConfiguration.from_json(_residual().to_json()))


# -- residual, two-input and two-output graphs --------------------------------

@pytest.mark.parametrize("name", list(CONFS))
def test_output_matches_jax(name):
    jm, m = _pair(CONFS[name]())
    f, _ = _batch(name, 5, 1)
    got = m.output(*f) if isinstance(f, tuple) else m.output(f)
    want = jm.output(*f) if isinstance(f, tuple) else jm.output(f)
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    assert len(got) == len(want) == len(m.conf.outputs)
    for a, b in zip(got, want):
        assert a.device.type == "cpu"
        np.testing.assert_allclose(_np(a), np.asarray(b), **F32)


@pytest.mark.parametrize("name", list(CONFS))
def test_loss_gradients_and_new_state_match_jax(name):
    jm, m = _pair(CONFS[name]())
    f, l = _batch(name, 6, 2)
    l = l if isinstance(l, tuple) else (l,)
    jin = {k: jnp.asarray(v) for k, v in _inputs(jm.conf, f).items()}
    (jloss, (jstate, _)), jgrads = jax.jit(jax.value_and_grad(
        lambda p: jm._loss(p, jm.state, jin, tuple(jnp.asarray(y) for y in l), None, None,
                           None), has_aux=True))(jm.params)
    inputs, labels, _, _ = m._to_device(f if isinstance(f, tuple) else (f,), l, None, None)
    loss, new_state, grads, _ = m._value_and_grad(m.state, inputs, labels, None, None, None)
    np.testing.assert_allclose(float(loss), float(jloss), **F32)
    _assert_trees_close(grads, jgrads)
    _assert_trees_close(new_state, jstate, dict(rtol=1e-5, atol=1e-6), scaled=False)
    assert not any(s.requires_grad for s in tree_leaves(new_state))


@pytest.mark.parametrize("name", list(CONFS))
@pytest.mark.parametrize("updater", [{"type": "sgd", "lr": 0.05}, {"type": "adam", "lr": 1e-2}],
                         ids=["sgd", "adam"])
def test_three_step_fit_matches_jax(name, updater):
    """10 rows at batch 4: two full batches and a tail of 2 padded to 4
    (weighted out of the loss and of BatchNorm's statistics)."""
    jm, m = _pair(CONFS[name](updater))
    f, l = _batch(name, 10, 3)
    jl, pl = JCollect(), CollectScoresListener()
    jm.set_listeners(jl)
    m.set_listeners(pl)
    jm.fit((f, l), epochs=1, batch_size=4)
    m.fit((f, l), epochs=1, batch_size=4)
    assert [i for i, _ in pl.scores] == [i for i, _ in jl.scores] == [1, 2, 3]
    np.testing.assert_allclose([s for _, s in pl.scores], [s for _, s in jl.scores],
                               **GRAD)
    _assert_trees_close(params_to_numpy(m), jm.params)
    _assert_trees_close(state_to_numpy(m), jm.state, dict(rtol=1e-5, atol=1e-6), scaled=False)
    if name == "residual":
        assert m.state["bn"]["mean"].abs().sum() > 0
    got = m.score((f, l))
    np.testing.assert_allclose(got, jm.score((f, l)), **GRAD)
    np.testing.assert_allclose(m.score((f, l), train=True), jm.score((f, l), train=True),
                               **GRAD)


def test_batch_forms_dict_and_multidataset_take_the_same_step():
    """(x, y), a dict and an object with as_tuple() are one batch: each
    takes the same step from the same start."""
    class MDS:
        def __init__(self, f, l):
            self.f, self.l = f, l

        def as_tuple(self):
            return (self.f, self.l, None, None)

    f, l = _batch("two_input", 4, 5)
    outs = []
    for form in ((f, l), {"features": f, "labels": l}, MDS(f, l), (list(f), [l])):
        _, m = _pair(_two_input({"type": "sgd", "lr": 0.1}))
        m.fit_batch(form)
        outs.append(_flat(params_to_numpy(m)))
    for o in outs[1:]:
        for k in outs[0]:
            np.testing.assert_array_equal(o[k], outs[0][k], err_msg=k)


def test_frozen_vertex_keeps_params_and_gets_no_gradient():
    from deeplearning4j_tpu_torch.nn.layers import Dense

    conf = ComputationGraphConfiguration.from_json(_residual().to_json())
    spec = conf.vertices["b1"]
    conf.vertices["b1"] = g.VertexSpec(Dense(n_out=8, activation="relu", trainable=False),
                                       spec.inputs)
    m = ComputationGraph(conf, device="cpu").init()
    before = {k: v.clone() for k, v in m.params["b1"].items()}
    other = m.params["b2"]["W"].clone()
    f, l = _batch("residual", 8, 6)
    m.fit((f, l), epochs=2)
    assert all(torch.equal(m.params["b1"][k], before[k]) for k in before)
    assert not torch.equal(m.params["b2"]["W"], other)
    assert m.opt_state["b1"] == ()


def test_gradient_accumulation_matches_the_whole_batch(monkeypatch):
    f, l = _batch("two_output", 8, 7)
    _, whole = _pair(_two_output({"type": "sgd", "lr": 0.1}))
    _, accum = _pair(_two_output({"type": "sgd", "lr": 0.1}))
    whole.fit_batch((f, l))
    monkeypatch.setenv("DL4J_TPU_GRAD_ACCUM", "2")
    accum.fit_batch((f, l))
    _assert_trees_close(params_to_numpy(accum), params_to_numpy(whole), GRAD)


# -- recurrent graphs ---------------------------------------------------------

def test_seq2seq_output_gradients_and_fit_match_jax():
    """The seq2seq graph at GravesLSTM(128), which takes the fused LSTM's
    plain version on the CPU: output, gradients per vertex, 3 RMSProp
    steps."""
    jm, m = _pair(_seq2seq(128), seed_state=False)
    (enc, dec), y = _seq_batch(4, 5, 6, seed=1)
    np.testing.assert_allclose(_np(m.output(enc, dec)), np.asarray(jm.output(enc, dec)), **F32)
    jin = {"enc_in": jnp.asarray(enc), "dec_in": jnp.asarray(dec)}
    jgrads = jax.jit(jax.grad(lambda p: jm._loss(p, jm.state, jin, (jnp.asarray(y),), None, None,
                                         None)[0]))(jm.params)
    inputs, labels, _, _ = m._to_device((enc, dec), (y,), None, None)
    _, _, grads, _ = m._value_and_grad(m.state, inputs, labels, None, None, None)
    _assert_trees_close(grads, jgrads)
    for _ in range(3):
        jm.fit(((enc, dec), y))
        m.fit(((enc, dec), y))
    _assert_trees_close(params_to_numpy(m), jm.params)


def test_masked_last_time_step_reads_the_named_input_mask():
    """LastTimeStepVertex(mask_input="enc_in") takes the encoder input's
    mask, not its own input's propagated one."""
    jconf = (jg.ComputationGraphConfiguration.builder()
             .add_inputs("enc_in")
             .set_input_types(JInputType.recurrent(3))
             .add_layer("enc", JLSTM(n_out=4), "enc_in")
             .add_vertex("last", jg.LastTimeStepVertex(mask_input="enc_in"), "enc")
             .add_layer("out", JOutputLayer(n_out=2, activation="softmax"), "last")
             .set_outputs("out").build())
    jm, m = _pair(jconf, seed_state=False)
    x = _rnd(2, 3, 6, 3)
    got = m.output(x, fmasks=_MASK)
    np.testing.assert_allclose(_np(got), np.asarray(jm.output(x, fmasks=_MASK)), **F32)
    # the masked rows' outputs depend only on their valid prefix
    x2 = x.copy()
    x2[1, 3:] = 9.0
    np.testing.assert_allclose(_np(m.output(x2, fmasks=_MASK)), _np(got), **F32)


def test_tbptt_at_one_chunk_equals_the_standard_step():
    """With the chunk as long as the sequence, a tBPTT fit takes exactly the
    standard step, in both packages."""
    (enc, dec), y = _seq_batch(3, 4, 5, seed=2)
    _, std = _pair(_seq2seq(128), seed_state=False)
    jm, tb = _pair(_seq2seq(128, tbptt=5), seed_state=False)
    std.fit(((enc, dec), y))
    tb.fit(((enc, dec), y))
    jm.fit(((enc, dec), y))
    assert tb.iteration == std.iteration == jm.iteration == 1
    _assert_trees_close(params_to_numpy(tb), params_to_numpy(std), dict(rtol=1e-6, atol=1e-7))
    _assert_trees_close(params_to_numpy(tb), jm.params)


def test_tbptt_chunks_match_jax():
    """T=6 in chunks of 2 (the encoder input is static across chunks,
    the decoder input and labels are chunked): 3 updates a batch, the same
    params as the JAX package's."""
    (enc, dec), y = _seq_batch(3, 4, 6, seed=3)
    jm, m = _pair(_seq2seq(16, tbptt=2, updater={"type": "sgd", "lr": 0.1}), seed_state=False)
    jm.conf.input_types["enc_in"] = JInputType.feed_forward(7)
    m.conf.input_types["enc_in"] = InputType.feed_forward(7)
    jm.fit(((enc, dec), y))
    m.fit(((enc, dec), y))
    assert m.iteration == jm.iteration == 3
    _assert_trees_close(params_to_numpy(m), jm.params)


def test_rnn_time_step_matches_the_full_forward_and_jax():
    jm, m = _pair(_seq2seq(128), seed_state=False)
    (enc, dec), _ = _seq_batch(2, 4, 5, seed=4)
    full = _np(m.output(enc, dec))
    m.rnn_clear_previous_state()
    jm.rnn_clear_previous_state()
    steps, jsteps = [], []
    for t in range(5):
        # a 2-D decoder step is one step; the encoder input is fed whole
        steps.append(_np(m.rnn_time_step(enc, dec[:, t])))
        jsteps.append(np.asarray(jm.rnn_time_step(enc, dec[:, t])))
    assert steps[0].shape == (2, 7)
    np.testing.assert_allclose(np.stack(steps, 1), np.stack(jsteps, 1), **F32)
    # each call re-runs the encoder from its carry, so only the first step
    # equals the full forward's
    np.testing.assert_allclose(steps[0], full[:, 0], **F32)


def test_rnn_time_step_streams_like_the_full_sequence():
    jconf = (jg.ComputationGraphConfiguration.builder()
             .add_inputs("x")
             .set_input_types(JInputType.recurrent(5))
             .add_layer("l1", JGravesLSTM(n_out=128), "x")
             .add_layer("l2", JLSTM(n_out=6), "l1")
             .add_layer("out", JRnnOutputLayer(n_out=5, activation="softmax"), "l2")
             .set_outputs("out").build())
    jm, m = _pair(jconf, seed_state=False)
    x = _rnd(5, 3, 7, 5)
    full = _np(m.output(x))
    np.testing.assert_allclose(full, np.asarray(jm.output(x)), **F32)
    m.rnn_clear_previous_state()
    first = _np(m.rnn_time_step(x[:, :3]))
    rest = [_np(m.rnn_time_step(x[:, t])) for t in range(3, 7)]
    np.testing.assert_allclose(np.concatenate([first, np.stack(rest, 1)], 1), full, **F32)
    m.rnn_clear_previous_state()
    np.testing.assert_allclose(_np(m.rnn_time_step(x[:, 0])), full[:, 0], **F32)


def test_wrapped_rnn_refuses_streaming():
    from deeplearning4j_tpu_torch.nn.layers import Bidirectional, RnnOutputLayer, SimpleRnn

    conf = (ComputationGraphConfiguration.builder()
            .add_inputs("seq").set_input_types(InputType.recurrent(3, 6))
            .add_layer("bi", Bidirectional(rnn=SimpleRnn(n_out=4)), "seq")
            .add_layer("out", RnnOutputLayer(n_out=2, activation="softmax"), "bi")
            .set_outputs("out").build())
    m = ComputationGraph(conf, device="cpu").init()
    with pytest.raises(NotImplementedError, match="wrapper"):
        m.rnn_time_step(_rnd(1, 2, 3))


def test_unported_training_options_raise_naming_their_slice():
    m = ComputationGraph(ComputationGraphConfiguration.from_json(_residual().to_json()),
                         device="cpu").init()
    # resume and the divergence guard are ported (the training-runtime
    # slice): an empty directory warns and trains from the current state
    from deeplearning4j_tpu_torch.train import resilience

    with pytest.warns(UserWarning, match="no valid checkpoint"):
        m.fit(_batch("residual", 4, 0), resume_from="somewhere")
    assert m.iteration == 1
    guard = resilience.DivergenceGuard("warn")
    assert m.set_divergence_guard(guard).divergence_guard is guard
    # the distributed chaos faults parse as they do in the JAX package
    from deeplearning4j_tpu.train.resilience import ChaosInjector as JChaos

    spec = "host_kill@iter:1:rank1,net_partition@iter:2:rank0:1.5"
    got, want = resilience.ChaosInjector.parse(spec), JChaos.parse(spec)
    assert [(f.kind, f.at_iter, f.arg) for f in got.faults] == \
        [(f.kind, f.at_iter, f.arg) for f in want.faults]


# -- zips, clone, summary -------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("make", [_residual, lambda: _seq2seq(16)], ids=["residual", "seq2seq"])
def test_graph_zips_cross_packages(writer, make, tmp_path):
    jm, m = _pair(make(), seed_state=make is _residual)
    f, l = (_batch("residual", 4, 8) if make is _residual else _seq_batch(4, 3, 4, seed=8))
    m.fit((f, l))
    jm.fit((f, l))
    path = str(tmp_path / "g.zip")
    if writer == "port":
        ser.save_network(m, path)
        back = jser.restore_network(path)
        assert isinstance(back, jg.ComputationGraph)
        _assert_trees_close(params_to_numpy(m), back.params, dict(rtol=0, atol=0), False)
        _assert_trees_close(state_to_numpy(m), back.state, dict(rtol=0, atol=0), False)
        _assert_trees_close(m.opt_state, back.opt_state, dict(rtol=0, atol=0), False)
        assert back.iteration == m.iteration
    else:
        jser.save_network(jm, path)
        back = ser.restore_network(path, device="cpu")
        assert isinstance(back, ComputationGraph)
        _assert_trees_close(params_to_numpy(back), jm.params, dict(rtol=0, atol=0), False)
        _assert_trees_close(state_to_numpy(back), jm.state, dict(rtol=0, atol=0), False)
        _assert_trees_close(back.opt_state, jm.opt_state, dict(rtol=0, atol=0), False)
        assert back.iteration == jm.iteration
        # the restored updater state continues the same trajectory
        back.fit((f, l))
        jm.fit((f, l))
        _assert_trees_close(params_to_numpy(back), jm.params)


def test_zip_leaves_follow_sorted_vertex_names(tmp_path):
    """Vertex names that sort differently as strings and as numbers
    (b10 before b2) keep their tensors in a cross-package zip."""
    b = (jg.ComputationGraphConfiguration.builder().add_inputs("in")
         .set_input_types(JInputType.feed_forward(3)))
    prev = "in"
    for i in (1, 2, 10, 3):
        b.add_layer(f"b{i}", JDense(n_out=3, activation="tanh"), prev)
        prev = f"b{i}"
    jconf = b.add_layer("out", JOutputLayer(n_out=2), prev).set_outputs("out").build()
    jm, m = _pair(jconf, seed_state=False)
    path = str(tmp_path / "s.zip")
    ser.save_network(m, path)
    back = jser.restore_network(path)
    for name in ("b1", "b2", "b3", "b10"):
        np.testing.assert_array_equal(np.asarray(back.params[name]["W"]),
                                      _np(m.params[name]["W"]))


def test_clone_and_summary():
    _, m = _pair(_residual({"type": "adam", "lr": 1e-2}))
    f, l = _batch("residual", 4, 9)
    m.fit((f, l))
    c = m.clone()
    assert c.iteration == m.iteration == 1
    for k, v in _flat(params_to_numpy(c)).items():
        np.testing.assert_array_equal(v, _flat(params_to_numpy(m))[k])
    c.fit((f, l))
    assert not torch.equal(c.params["h"]["W"], m.params["h"]["W"])
    lines = m.summary().splitlines()
    assert lines[-1] == f"Total params: {m.num_params()}"
    assert len(lines) == len(m.topo_order) + 2
    ev = m.evaluate((f, l))
    assert 0.0 <= ev.accuracy() <= 1.0


# -- the trainer CLI, ModelGuesser and serving --------------------------------

def test_cli_trains_a_graph_config_and_load_any_reads_it(tmp_path):
    from deeplearning4j_tpu_torch.train import __main__ as cli
    from deeplearning4j_tpu_torch.utils.guesser import load_any

    conf_path = tmp_path / "g.json"
    conf_path.write_text(_residual({"type": "adam", "lr": 1e-2}).to_json())
    assert isinstance(load_any(str(conf_path)), ComputationGraphConfiguration)
    x, y = _batch("residual", 10, 11)
    np.savez(tmp_path / "d.npz", x=x, y=y)
    out = tmp_path / "g.zip"
    m = cli.run([str(conf_path), "--data", str(tmp_path / "d.npz"), "--epochs", "2",
                 "--batch-size", "4", "--output", str(out), "--device", "cpu", "--evaluate"])
    assert isinstance(m, ComputationGraph) and m.iteration == 6
    back = load_any(str(out), device="cpu")
    assert isinstance(back, ComputationGraph) and back.iteration == 6
    np.testing.assert_array_equal(_np(back.output(x)), _np(m.output(x)))
    assert isinstance(jser.restore_network(str(out)), jg.ComputationGraph)


def test_registry_serves_a_one_input_graph_with_integer_pixels():
    import urllib.request

    from deeplearning4j_tpu.nn.layers import Conv2D as JConv2D
    from deeplearning4j_tpu.nn.layers import GlobalPooling as JGlobalPooling
    from deeplearning4j_tpu_torch.serve import InferenceServer, ModelRegistry, ServeConfig

    jconf = (jg.ComputationGraphConfiguration.builder().add_inputs("in")
             .set_input_types(JInputType.convolutional(6, 6, 2))
             .add_layer("c", JConv2D(n_out=4, kernel=(3, 3), convolution_mode="same",
                                     activation="relu"), "in")
             .add_vertex("res", jg.ElementWiseVertex(op="add"), "c", "c")
             .add_layer("pool", JGlobalPooling(pooling="avg"), "res")
             .add_layer("out", JOutputLayer(n_out=3, activation="softmax"), "pool")
             .set_outputs("out").build())
    _, m = _pair(jconf, seed_state=False)
    assert not m.takes_ids and tuple(m.dummy_input(3).shape) == (3, 6, 6, 2)
    reg = ModelRegistry(ServeConfig(max_batch=4), device="cpu")
    reg.register("g", m)
    srv = InferenceServer(reg).start(port=0)
    try:
        pix = np.random.RandomState(0).randint(0, 256, (2, 6, 6, 2))
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/v1/models/g:predict",
            data=json.dumps({"inputs": pix.tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            body = json.loads(r.read())
    finally:
        srv.stop()
        reg.shutdown()
    want = _np(m.output(pix.astype(np.float32)))
    np.testing.assert_allclose(np.asarray(body["outputs"], np.float32), want, **F32)


def test_cli_trains_a_two_input_graph_from_numbered_arrays(tmp_path):
    """x0, x1 (the graph's inputs in order) and y in the .npz: the seq2seq
    graph trains through the CLI under tBPTT and its zip restores."""
    from deeplearning4j_tpu_torch.train import __main__ as cli

    conf_path = tmp_path / "s.json"
    conf_path.write_text(_seq2seq(16, tbptt=3).to_json())
    (enc, dec), y = _seq_batch(6, 6, 6, seed=12)
    np.savez(tmp_path / "d.npz", x0=enc, x1=dec, y=y)
    out = tmp_path / "s.zip"
    m = cli.run([str(conf_path), "--data", str(tmp_path / "d.npz"), "--epochs", "1",
                 "--batch-size", "3", "--output", str(out), "--device", "cpu"])
    assert m.iteration == 2 * 2          # 2 batches x 2 chunks of 3 steps
    back = ser.restore_network(str(out), device="cpu")
    np.testing.assert_array_equal(_np(back.output(enc, dec)), _np(m.output(enc, dec)))


def test_id_stream_graph_tbptt_and_streaming_match_jax():
    """A recurrent input of integer ids ([B, T], an EmbeddingSequence
    consumer): tBPTT chunks the id stream, and rnn_time_step takes [B] ids
    as one step, as in the JAX package."""
    from deeplearning4j_tpu.nn.layers import EmbeddingSequence as JEmbeddingSequence

    T = 8
    jconf = (jg.ComputationGraphConfiguration.builder().add_inputs("tok")
             .set_input_types(JInputType.recurrent(1, T))
             .add_layer("emb", JEmbeddingSequence(n_in=10, n_out=5), "tok")
             .add_layer("lstm", JLSTM(n_out=6), "emb")
             .add_layer("out", JRnnOutputLayer(n_out=2, activation="softmax"), "lstm")
             .set_outputs("out").updater({"type": "sgd", "lr": 0.1}).tbptt(4).build())
    jm, m = _pair(jconf, seed_state=False)
    rs = np.random.RandomState(13)
    tok = rs.randint(0, 10, (4, T)).astype(np.int32)
    y = np.eye(2, dtype=np.float32)[rs.randint(0, 2, (4, T))]
    assert m.takes_ids and m.dummy_input(3).dtype == torch.int64
    m.fit((tok, y))
    jm.fit((tok, y))
    assert m.iteration == jm.iteration == T // 4
    _assert_trees_close(params_to_numpy(m), jm.params)
    m.rnn_clear_previous_state()
    jm.rnn_clear_previous_state()
    got = np.stack([_np(m.rnn_time_step(tok[:, t])) for t in range(T)], 1)
    want = np.stack([np.asarray(jm.rnn_time_step(tok[:, t])) for t in range(T)], 1)
    assert got.shape == (4, T, 2)
    np.testing.assert_allclose(got, want, **F32)
    np.testing.assert_allclose(got, _np(m.output(tok)), **F32)
