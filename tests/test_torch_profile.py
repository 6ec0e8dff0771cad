"""The port's cost ledger (``deeplearning4j_tpu_torch/obs/profile.py``): the
counting pass against XLA's ``cost_analysis`` of the JAX package on the
same dense networks, the analytic kernel counts against the bound column of
PERF.md §6 (the formulas ``chip_smoke.py`` computes its bounds with), the
roofline table and its env overrides, and utilization: device time for a
CUDA site, the host span for a CPU one, a share above 1.0 reported as an
error and never clipped."""

import os

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu.nn import aot as jaot
from deeplearning4j_tpu.nn import layers as jl
from deeplearning4j_tpu.nn.input_type import InputType as JInputType
from deeplearning4j_tpu.nn.model import MultiLayerConfiguration as JConf
from deeplearning4j_tpu.nn.model import MultiLayerNetwork as JNetwork
from deeplearning4j_tpu.obs import profile as jprofile
from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.models import TransformerLM
from deeplearning4j_tpu_torch.nn import aot
from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration, MultiLayerNetwork
from deeplearning4j_tpu_torch.obs import profile
from deeplearning4j_tpu_torch.utils.tree import tree_leaves

PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12
FLOPS_VS_XLA_REL = 0.05


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith("DL4J_TPU_"):
            monkeypatch.delenv(k)
    obs.reset()
    jprofile.reset()
    yield
    obs.reset()


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _dense_conf(widths, n_in, activation):
    layers = tuple(jl.Dense(n_out=w, activation=activation) for w in widths)
    return JConf(layers=layers + (jl.OutputLayer(n_out=10, activation="softmax"),),
                 input_type=JInputType.feed_forward(n_in), seed=5,
                 updater={"type": "adam", "lr": 1e-3})


@pytest.mark.parametrize("widths,n_in,activation,batch", [
    ((256,), 256, "relu", 16),
    ((512, 256), 256, "tanh", 16),
    ((256, 256, 256), 512, "relu", 32),
    ((1024,), 256, "sigmoid", 8),
])
def test_counted_flops_match_xla_cost_analysis(widths, n_in, activation, batch):
    jconf = _dense_conf(widths, n_in, activation)
    jm = JNetwork(jconf).init()
    jaot.warm_serving(jm, batch)
    want = jprofile.cost_report()["sites"]["mln.output"][f"b{batch}"]["flops"]
    m = MultiLayerNetwork(MultiLayerConfiguration.from_json(jconf.to_json()), device="cpu").init()
    aot.warm_serving(m, batch)
    got = obs.cost_report()["sites"]["mln.output"][f"b{batch}"]
    assert got["source"] == "count" and got["device"] == "cpu" and got["bytes_accessed"] > 0
    assert abs(got["flops"] - want) / want <= FLOPS_VS_XLA_REL, (got["flops"], want)
    # the products alone, exactly
    dims = (n_in,) + tuple(widths) + (10,)
    assert got["flops"] == sum(2 * batch * a * b for a, b in zip(dims, dims[1:]))


def test_a_transformer_forward_counts_its_products_and_attention():
    m = MultiLayerNetwork(TransformerLM(vocab_size=64, max_len=16, d_model=32, n_heads=2,
                                        n_blocks=2), device="cpu").init()
    aot.warm_serving(m, 4)
    got = obs.cost_report()["sites"]["mln.output"]["b4"]["flops"]
    weights = sum(t.numel() for l, p in zip(m.layers, m.params)
                  if type(l).__name__ not in ("EmbeddingSequence", "PositionalEmbedding")
                  for t in tree_leaves(p) if t.dim() == 2)
    # the CPU runs the plain attention over every (query, key) pair
    attn = 2 * 4.0 * 4 * 2 * 16 * 16 * 16
    assert got == 2 * 4 * 16 * weights + attn


# PERF.md §6's bound column (ms, what bounds it), as chip_smoke.py computes it
_BOUNDS = [
    ("#1 flash fwd", lambda: profile.attention_fwd_cost(16, 2048, 2048, 16, 128, True, 2),
     PEAK_BF16, 0.278, "operations"),
    ("#2 flash dq", lambda: profile.attention_bwd_cost(16, 2048, 2048, 16, 128, True, 2, "dq"),
     PEAK_BF16, 0.417, "operations"),
    ("#3 flash dk/dv",
     lambda: profile.attention_bwd_cost(16, 2048, 2048, 16, 128, True, 2, "dkv"),
     PEAK_BF16, 0.556, "operations"),
    ("#4 lstm fwd", lambda: profile.lstm_cost(128, 50, 256, 4, "fwd"), PEAK_F32, 0.050,
     "operations"),
    ("#5 lstm bwd", lambda: profile.lstm_cost(128, 50, 256, 4, "bwd"), PEAK_F32, 0.100,
     "operations"),
    ("#4 step route H1152 f32", lambda: profile.lstm_cost(32, 20, 1152, 4, "fwd"), PEAK_F32,
     0.101, "operations"),
    ("#5 step route H1152 f32", lambda: profile.lstm_cost(32, 20, 1152, 4, "bwd"), PEAK_F32,
     0.203, "operations"),
    ("#4 step route H2048 f32", lambda: profile.lstm_cost(32, 20, 2048, 4, "fwd"), PEAK_F32,
     0.321, "operations"),
    ("#5 step route H2048 f32", lambda: profile.lstm_cost(32, 20, 2048, 4, "bwd"), PEAK_F32,
     0.641, "operations"),
    ("row 6 diagonal fwd", lambda: profile.chunk_cost(
        16, 512, 512, 16, 128, profile.attention_pairs(512, 512, True), 2, False),
     PEAK_BF16, 0.040, "bytes"),
    ("row 6 diagonal fwd+bwd", lambda: profile.chunk_cost(
        16, 512, 512, 16, 128, profile.attention_pairs(512, 512, True), 2, True),
     PEAK_BF16, 0.080, "bytes"),
    ("row 6 off-diagonal fwd+bwd", lambda: profile.chunk_cost(
        16, 512, 512, 16, 128, profile.attention_pairs(512, 512, False), 2, True),
     PEAK_BF16, 0.122, "operations"),
]


@pytest.mark.parametrize("name,cost,peak,want_ms,want_by", _BOUNDS, ids=[b[0] for b in _BOUNDS])
def test_analytic_counts_reproduce_the_bound_column(name, cost, peak, want_ms, want_by):
    flops, nbytes = cost()
    ms, by = profile.bound(flops, nbytes, peak, PEAK_BYTES)
    assert by == want_by
    assert abs(ms - want_ms) / want_ms <= 0.01, (name, ms, want_ms)


def test_chunk_pairs_match_the_ring_arithmetic():
    for Tq, Tk, qo, ko in ((512, 512, 0, 0), (512, 1536, 1536, 512), (512, 512, 0, 1024),
                           (7, 13, 3, 0)):
        want = int(np.clip(np.arange(Tq) + qo - ko + 1, 0, Tk).sum())
        assert profile.attention_pairs(Tq, Tk, True, qo, ko) == want
        assert profile.attention_pairs(Tq, Tk, False, qo, ko) == Tq * Tk
    f, b = profile.attention_fwd_cost(2, 64, 64, 4, 32, True, 2, kmask=True)
    fq, bq = profile.attention_fwd_cost(2, 64, 64, 4, 32, True, 2, kmask=False)
    assert f == fq and b - bq == 4.0 * 2 * 64


def test_kernels_report_to_the_active_counting_pass():
    assert profile.active_counter() is None

    def fn():
        c = profile.active_counter()
        c.kernel("flash_fwd", *profile.attention_fwd_cost(1, 8, 8, 2, 16, True, 2))
        c.kernel("flash_fwd", *profile.attention_fwd_cost(1, 8, 8, 2, 16, True, 2))
        return torch.ones(4, 4) @ torch.ones(4, 4)

    out, entry = profile.count_pass(fn, device="cpu", dtype="bfloat16")
    kf, kb = profile.attention_fwd_cost(1, 8, 8, 2, 16, True, 2)
    assert entry["kernels"]["flash_fwd"] == {"launches": 2, "flops": 2 * kf, "bytes": 2 * kb}
    assert entry["flops"] == 2 * kf + 2 * 4 * 4 * 4 and entry["dtype"] == "bfloat16"
    assert entry["peak_hbm_bytes"] is None and profile.active_counter() is None


def test_roofline_table_env_overrides_and_cpu(monkeypatch):
    r = profile.roofline("NVIDIA H100 80GB HBM3")
    assert (r["peak_bf16_flops"], r["peak_f32_flops"], r["hbm_bytes_per_s"]) == (
        PEAK_BF16, PEAK_F32, PEAK_BYTES) and r["source"] == "table"
    for kind in ("cpu", "TPU v5 lite", "NVIDIA A100-SXM4-80GB"):
        r = profile.roofline(kind)
        assert r["peak_bf16_flops"] is None and r["hbm_bytes_per_s"] is None
    assert profile.roofline()["peak_bf16_flops"] is None   # this host has no card
    assert profile.peak_flops("bfloat16", "H100 PCIe") == PEAK_BF16
    assert profile.peak_flops("float32", "H100 PCIe") == PEAK_F32
    monkeypatch.setenv("DL4J_TPU_PEAK_FLOPS", "2e12")
    monkeypatch.setenv("DL4J_TPU_HBM_GBPS", "100")
    r = profile.roofline("cpu")
    assert (r["peak_bf16_flops"], r["peak_f32_flops"], r["hbm_bytes_per_s"], r["source"]) == (
        2e12, 2e12, 100e9, "env")
    monkeypatch.setenv("DL4J_TPU_PEAK_FLOPS", "fast")
    assert profile.roofline("cpu")["peak_bf16_flops"] is None
    assert profile.utilization() == {}


def test_a_cpu_site_divides_by_its_host_span_and_reports_a_share_above_one(monkeypatch):
    profile.record("mln.output", "b8", {"source": "count", "flops": 4e9,
                                        "bytes_accessed": 2e8, "device": "cpu",
                                        "dtype": "float32"})
    spans = {"mln.output": {"count": 3, "wall_p50_s": 0.5}}
    assert profile.utilization(spans) == {}            # no roofline on the CPU
    monkeypatch.setenv("DL4J_TPU_PEAK_FLOPS", "1e10")
    monkeypatch.setenv("DL4J_TPU_HBM_GBPS", "1")
    u = profile.utilization(spans)["mln.output"]
    assert u["timebase"] == "host_span" and u["key"] == "b8"
    assert u["mfu"] == pytest.approx(0.8) and u["membw_util"] == pytest.approx(0.4)
    assert "error" not in u
    u = profile.utilization({"mln.output": {"count": 3, "wall_p50_s": 0.01}})["mln.output"]
    assert u["mfu"] == pytest.approx(40.0) and u["membw_util"] == pytest.approx(20.0)
    assert "mfu" in u["error"] and "membw_util" in u["error"]
    g = obs.registry().gauge("dl4j_mfu", "", ("site",))
    assert g.value(site="mln.output") == pytest.approx(40.0)


class _FakeEvent:
    clock = [0.0]

    def __init__(self, enable_timing=True):
        self.t = None

    def record(self, *a):
        self.t = _FakeEvent.clock[0]

    def query(self):
        return self.t is not None

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def test_a_cuda_site_divides_by_sampled_device_time(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setenv("DL4J_TPU_PEAK_FLOPS", "1e12")
    monkeypatch.setenv("DL4J_TPU_HBM_GBPS", "1000")
    monkeypatch.setattr(profile, "SAMPLE_EVERY", 2)
    entry = {"source": "count", "flops": 1e9, "bytes_accessed": 1e8, "device": "cuda",
             "dtype": "bfloat16"}
    profile.record("mln.output", "b16", entry)
    assert profile.sample_start("mln.output", "b99") is None     # not priced
    # the host span says 1 ms; the sampled device time, 4 ms: device wins
    spans = {"mln.output": {"count": 5, "wall_p50_s": 1e-3}}
    assert profile.utilization(spans) == {}                       # no sample yet
    took = 0
    for i in range(6):
        ev = profile.sample_start("mln.output", "b16")
        _FakeEvent.clock[0] += 0.004
        if ev is not None:
            took += 1
            profile.sample_stop("mln.output", "b16", ev)
    assert took == 3                                              # one in two
    u = profile.utilization(spans)["mln.output"]
    assert u["timebase"] == "device" and u["seconds"] == pytest.approx(0.004)
    assert u["mfu"] == pytest.approx(0.25) and u["membw_util"] == pytest.approx(0.025)
    assert profile.device_seconds("mln.output", "b16") == pytest.approx(0.004)


def test_snapshot_and_reset_carry_the_ledger():
    m = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        _dense_conf((16,), 8, "relu").to_json()), device="cpu").init()
    aot.warm_serving(m, 2)
    snap = obs.snapshot()
    assert sorted(snap["profile"]["sites"]["mln.output"]) == ["b1", "b2"]
    assert "dl4j_xla_flops" in obs.prometheus_text()
    obs.reset()
    assert obs.snapshot()["profile"]["sites"] == {}
    assert obs.cost_report()["sites"] == {}
