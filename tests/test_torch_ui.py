"""The port's training dashboard (``deeplearning4j_tpu_torch/ui``) against
the JAX package's: the component DSL renders byte for byte alike, a
FileStatsStorage written by either package reads in the other, StatsListener
records over the same params carry the same keys and statistics, the
activation grids and PNGs are equal, and every UIServer route answers on
the CPU."""

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.input_type import InputType as JInputType
from deeplearning4j_tpu.nn.model import MultiLayerConfiguration as JConf
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JNetwork
from deeplearning4j_tpu.ui import components as jcomp
from deeplearning4j_tpu.ui import convolutional as jconv
from deeplearning4j_tpu.ui import i18n as ji18n
from deeplearning4j_tpu.ui import stats as jstats
from deeplearning4j_tpu.ui import storage as jstorage
from deeplearning4j_tpu_torch.interop import params_to_numpy
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration, MultiLayerNetwork
from deeplearning4j_tpu_torch.ui import (ChartHistogram, ChartHorizontalBar, ChartLine,
                                         ChartScatter, ChartStackedArea, ChartTimeline,
                                         ComponentDiv, ComponentTable, ComponentText,
                                         ConvolutionalIterationListener, FileStatsStorage,
                                         InMemoryStatsStorage, StatsListener, UIServer,
                                         render_html)
from deeplearning4j_tpu_torch.ui import __main__ as ui_cli
from deeplearning4j_tpu_torch.ui import convolutional, i18n
from deeplearning4j_tpu_torch.ui import components as comp

STATS_REL = 1e-6


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


def _tree(mod):
    line = mod.ChartLine("loss").add_series("train", [0, 1, 2], [3.0, 2.0, 1.5])
    line.add_series("val", [0, 1, 2], [3.5, 2.5, 2.0])
    sc = mod.ChartScatter("emb").add_series("pts", [0.1, 0.5], [0.3, -0.2])
    area = mod.ChartStackedArea("mix").add_series("a", [0, 1], [1, 2])
    area.add_series("b", [0, 1], [2, 1])
    tl = mod.ChartTimeline("phases").add_lane(
        "main", [{"start": 0, "end": 2, "label": "fwd"}, {"start": 2, "end": 5, "label": "bwd"}])
    hist = mod.ChartHistogram("w").add_bin(-1, 0, 3).add_bin(0, 1, 5)
    bar = mod.ChartHorizontalBar("time").add_value("fwd", 2.5).add_value("bwd <&>", 4.0)
    table = mod.ComponentTable(header=["k", "v"], content=[["a", "1"], ["b<", "2"]])
    return (mod.ComponentText("Report <one>"),
            mod.ComponentDiv(line, sc, area, tl, hist, bar, table))


def test_render_html_is_byte_equal_to_the_jax_package(tmp_path):
    got = render_html(*_tree(comp), title="t & u")
    assert got == jcomp.render_html(*_tree(jcomp), title="t & u")
    for a, b in zip(_tree(comp), _tree(jcomp)):
        assert a.to_json() == b.to_json()
        assert comp.Component.from_json(b.to_json()).to_json() == a.to_json()
    path = tmp_path / "page.html"
    comp.save_html(str(path), *_tree(comp))
    assert path.read_text() == jcomp.render_html(*_tree(jcomp))


def test_i18n_messages_equal_the_jax_package():
    mine, theirs = i18n.I18N(), ji18n.I18N()
    for lang in ("en", "ja", "zh", "ko", "de", "fr", "ru", "xx"):
        for key in ("train.pagetitle", "train.overview.title", "train.system", "tsne.title",
                    "no.such.key"):
            assert mine.get_message(key, lang) == theirs.get_message(key, lang)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_file_stats_storage_reads_in_either_package(tmp_path, writer):
    path = str(tmp_path / "stats.jsonl")
    w = FileStatsStorage(path) if writer == "port" else jstorage.FileStatsStorage(path)
    w.put_static_info({"session_id": "s1", "worker_id": "0", "type_id": "StatsInitializationReport",
                       "model_class": "MultiLayerNetwork"})
    for i in range(3):
        w.put_update({"session_id": "s1", "worker_id": "0", "type_id": "StatsReport",
                      "iteration": i, "score": 1.0 / (i + 1)})
    r = jstorage.FileStatsStorage(path) if writer == "port" else FileStatsStorage(path)
    assert r.list_session_ids() == ["s1"]
    assert [u["iteration"] for u in r.get_all_updates("s1")] == [0, 1, 2]
    assert r.get_static_info("s1")[0]["model_class"] == "MultiLayerNetwork"


def _jax_copy(pm):
    """The port's params as JAX arrays that share no memory with them (the
    port updates its params in place)."""
    return jax.tree_util.tree_map(lambda a: jnp.asarray(np.array(a, copy=True)),
                                  params_to_numpy(pm))


def _pair():
    jconf = JConf(layers=(jl.Dense(n_out=12, activation="tanh"),
                          jl.Dense(n_out=6, activation="relu"),
                          jl.OutputLayer(n_out=3, activation="softmax")),
                  input_type=JInputType.feed_forward(5), seed=7)
    pm = MultiLayerNetwork(MultiLayerConfiguration.from_json(jconf.to_json()),
                           device="cpu").init()
    jm = JNetwork(jconf).init()
    jm.params = _jax_copy(pm)
    return pm, jm


def _close(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _close(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _close(x, y)
    elif isinstance(a, float):
        assert abs(a - b) <= STATS_REL * max(abs(b), 1e-30), (a, b)
    else:
        assert a == b


def test_stats_listener_records_equal_the_jax_package():
    pm, jm = _pair()
    ps, js = InMemoryStatsStorage(), jstorage.InMemoryStatsStorage()
    pl = StatsListener(ps, session_id="s", histogram_bins=8)
    jlis = jstats.StatsListener(js, session_id="s", histogram_bins=8)
    rs = np.random.RandomState(3)
    for it in (1, 2):
        pl.iteration_done(pm, it, 0.5 / it, batch_size=4)
        jlis.iteration_done(jm, it, 0.5 / it, batch_size=4)
        # the same update on both: the listener's update statistics see it
        delta = [{k: rs.randn(*v.shape).astype(np.float32) * 1e-2 for k, v in layer.items()}
                 for layer in params_to_numpy(pm)]
        with torch.no_grad():
            for layer, d in zip(pm.params, delta):
                for k, v in d.items():
                    layer[k].add_(torch.from_numpy(v))
        jm.params = _jax_copy(pm)
    pu, ju = ps.get_all_updates("s"), js.get_all_updates("s")
    assert len(pu) == len(ju) == 2
    for a, b in zip(pu, ju):
        assert sorted(a) == sorted(b)
        for key in ("parameters", "updates", "update_ratios"):
            _close(a[key], b[key])
        assert (a["iteration"], a["score"], a["batch_size"]) == (
            b["iteration"], b["score"], b["batch_size"])
    assert sorted(pu[0]["parameters"]) == ["0/W", "0/b", "1/W", "1/b", "2/W", "2/b"]
    st_p, st_j = ps.get_static_info("s")[0], js.get_static_info("s")[0]
    assert st_p["n_params"] == st_j["n_params"] and st_p["backend"] == "cpu"
    assert st_p["devices"] == ["cpu"] and st_p["n_layers"] == st_j["n_layers"]


def test_stats_listener_on_a_fit_and_the_obs_gauges():
    from deeplearning4j_tpu_torch import obs

    m = MultiLayerNetwork(zoo.TextGenerationLSTM(hidden=128, timesteps=8), device="cpu").init()
    ids = np.random.RandomState(0).randint(0, 77, (8, 16))
    eye = np.eye(77, dtype=np.float32)
    st = InMemoryStatsStorage()
    lis = StatsListener(st, session_id="fit")
    m.set_listeners(lis).fit((eye[ids], eye[np.roll(ids, -1, 1)]), epochs=1, batch_size=4)
    ups = st.get_all_updates("fit")
    assert [u["iteration"] for u in ups] == [1, 2]
    assert ups[1]["updates"] and all(v > 0 for v in ups[1]["update_ratios"].values())
    g = obs.registry().gauge("dl4j_training_score", "", ("session",))
    assert g.value(session="fit") == pytest.approx(ups[-1]["score"])


def test_activation_grids_and_pngs_equal_the_jax_package(tmp_path):
    act = np.random.RandomState(1).rand(6, 5, 7).astype(np.float32)
    act[:, :, 2] = 0.5                                    # a flat channel
    g = convolutional.activation_grid(act, max_channels=6)
    np.testing.assert_array_equal(g, jconv.activation_grid(act, max_channels=6))
    assert convolutional.encode_png_gray(g) == jconv.encode_png_gray(g)
    with pytest.raises(ValueError):
        convolutional.activation_grid(act[0])
    net = MultiLayerNetwork(zoo.LeNet5(height=12, width=12), device="cpu").init()
    rs = np.random.RandomState(2)
    x = rs.rand(8, 12, 12, 1).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rs.randint(0, 10, 8)]
    lis = ConvolutionalIterationListener(x[:1], str(tmp_path / "conv"), frequency=1)
    net.set_listeners(lis).fit((x, y), epochs=1, batch_size=4)
    assert len(lis.rendered) == 2 * 4                     # 4 conv-shaped activations, 2 steps
    acts = net.feed_forward(x[:1], train=False)
    conv_acts = [a for a in acts if a.dim() == 4]
    want = jconv.encode_png_gray(jconv.activation_grid(conv_acts[0][0].numpy()))
    assert open(lis.rendered[-4], "rb").read() == want
    assert (tmp_path / "conv" / "index.html").exists()
    with pytest.raises(ValueError):
        ConvolutionalIterationListener(x[:1], str(tmp_path / "c2"), frequency=0)


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _post(port, path, payload):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_ui_server_routes_answer_on_the_cpu(tmp_path):
    st = InMemoryStatsStorage()
    pm, _ = _pair()
    lis = StatsListener(st, session_id="sess")
    lis.iteration_done(pm, 1, 0.9, batch_size=2)
    lis.iteration_done(pm, 2, 0.8, batch_size=2)
    ui = UIServer()
    ui.attach(st)
    remote = ui.enable_remote_listener()
    ui.serve(0, warm_models=[pm], warm_batch=4)
    try:
        for route in ("/", "/train", "/train/overview", "/train/overview?lang=ja",
                      "/train/system", "/tsne", "/stats", "/debug/trace", "/metrics",
                      "/healthz"):
            status, body = _get(ui.port, route)
            assert status == 200, (route, status)
        assert "cpu" in _get(ui.port, "/train/system")[1].decode()
        trace = json.loads(_get(ui.port, "/debug/trace")[1])
        assert isinstance(trace["traceEvents"], list)
        assert _get(ui.port, "/nope")[0] == 404
        assert _post(ui.port, "/tsne", {"coords": [[0, 1], [1, 0]], "labels": ["a", "b"],
                                        "name": "e"})[0] == 200
        assert "e (2" in _get(ui.port, "/tsne")[1].decode()
        assert _post(ui.port, "/tsne", {"coords": [1, 2]})[0] == 400
        rec = {"session_id": "r1", "type_id": "StatsReport", "iteration": 1, "score": 1.0}
        assert _post(ui.port, "/remote", [rec])[0] == 200
        assert remote.list_session_ids() == ["r1"]
        assert _post(ui.port, "/remote", [{"no": "session"}])[0] == 400
    finally:
        ui.stop()
    html = ui.render(str(tmp_path / "dash.html"))
    assert "sess" in open(html).read()
    assert pm._get_output_fn().compiled_count == 3     # serve(warm_models=) warmed 1, 2, 4
    args = ui_cli.build_parser().parse_args(["--storage", "s.jsonl", "--port", "0"])
    assert (args.storage, args.port) == ("s.jsonl", 0)
