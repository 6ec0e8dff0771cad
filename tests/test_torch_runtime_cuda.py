"""The runtime layer on the GPU: a counting pass sees the hand-written
kernels it launches (their analytic counts beside the aten products), a
priced site's utilization divides by CUDA-event device time and stays at
or below 1.0, a bundle round trip replays the warmed grid with its costs,
and the memory report leaves the model as it found it. Every test needs an
NVIDIA card (marker ``cuda``) and skips without one; on a GPU host run

    python -m pytest --noconftest -m cuda tests/test_torch_runtime_cuda.py

This file imports no JAX."""

import os

import pytest
import torch

from deeplearning4j_tpu_torch import obs
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.nn import aot
from deeplearning4j_tpu_torch.nn.memory import memory_report
from deeplearning4j_tpu_torch.nn.model import MultiLayerNetwork
from deeplearning4j_tpu_torch.obs import profile
from deeplearning4j_tpu_torch.ops import flash_attention as fa
from deeplearning4j_tpu_torch.utils.tree import tree_leaves

pytestmark = pytest.mark.cuda

LM = dict(vocab_size=128, max_len=64, d_model=64, n_heads=2, n_blocks=2, dtype="bfloat16")


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is False")
    for k in list(os.environ):
        if k.startswith("DL4J_TPU_"):
            monkeypatch.delenv(k)
    obs.reset()
    aot.reset_validation()
    return torch.device("cuda")


def _weights(model):
    return sum(t.numel() for l, p in zip(model.layers, model.params)
               if type(l).__name__ not in ("EmbeddingSequence", "PositionalEmbedding")
               for t in tree_leaves(p) if t.dim() == 2)


def test_the_counting_pass_counts_the_flash_kernel(cuda):
    m = MultiLayerNetwork(zoo.TransformerLM(**LM)).init()
    before = fa.flash_fwd_cuda.launches
    aot.warm_serving(m, 4)
    assert fa.flash_fwd_cuda.launches == before + 3 * LM["n_blocks"]   # buckets 1, 2, 4
    e = obs.cost_report()["sites"]["mln.output"]["b4"]
    assert e["kernels"]["flash_fwd"]["launches"] == LM["n_blocks"]
    attn, _ = profile.attention_fwd_cost(4, 64, 64, 2, 32, True, 2)
    assert e["flops"] == 2 * 4 * 64 * _weights(m) + LM["n_blocks"] * attn
    assert e["device"] == "cuda" and e["peak_hbm_bytes"] > 0 and e["dtype"] == "bfloat16"


def test_utilization_divides_by_device_time(cuda, monkeypatch):
    m = MultiLayerNetwork(zoo.TransformerLM(**LM)).init()
    aot.warm_serving(m, 4)
    monkeypatch.setattr(profile, "SAMPLE_EVERY", 1)
    x = torch.zeros((4, 64), dtype=torch.int64)
    for _ in range(3):
        m.output(x)
    torch.cuda.synchronize()
    u = profile.utilization()["mln.output"]
    assert u["timebase"] == "device" and u["key"] == "b4"
    assert 0 < u["mfu"] <= 1.0 and 0 < u["membw_util"] <= 1.0 and "error" not in u


def test_a_bundle_replays_the_warmed_grid(cuda, tmp_path):
    m = MultiLayerNetwork(zoo.TransformerLM(**LM)).init()
    aot.warm_serving(m, 4)
    path = tmp_path / "lm.aotbundle"
    info = aot.save_bundle(m, path)                        # auto: on for CUDA
    assert info["entries"] == 3
    r = MultiLayerNetwork(zoo.TransformerLM(**LM)).init()
    before = fa.flash_fwd_cuda.launches
    assert aot.restore_bundle(r, path) == 3
    assert fa.flash_fwd_cuda.launches == before + 3 * LM["n_blocks"]   # replayed
    assert r._get_output_fn().compiled_count == 3
    assert aot.warm_serving(r, 4) == 3 and fa.flash_fwd_cuda.launches == before + 6


def test_the_memory_report_leaves_the_model(cuda):
    m = MultiLayerNetwork(zoo.TransformerLM(**LM)).init()
    before = [t.clone() for t in tree_leaves(m.params)]
    gen = m._gen.get_state()
    r = memory_report(m, 4)
    assert all(torch.equal(a, b) for a, b in zip(before, tree_leaves(m.params)))
    assert torch.equal(m._gen.get_state(), gen) and m.opt_state is None
    assert r.params_bytes == 2 * m.num_params() and r.opt_state_bytes == 8 * m.num_params()
    assert r.training["temp_bytes"] > 0 and r.training["peak_bytes"] > 0
