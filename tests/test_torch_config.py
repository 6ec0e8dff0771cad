"""Config JSON parity: the port reads and writes the JAX package's
MultiLayerConfiguration JSON (``"format"`` tag included), both ways."""

import json

import pytest

from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn.config import LayerConfig as JLayerConfig
from deeplearning4j_tpu.nn.model import MultiLayerConfiguration as JConf
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.nn.config import LayerConfig
from deeplearning4j_tpu_torch.nn.initializers import Distribution
from deeplearning4j_tpu_torch.nn.layers import (
    EmbeddingSequence, LayerNorm, MultiHeadAttention, PositionalEmbedding,
    RnnOutputLayer, TransformerBlock)
from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration

SIZES = [
    dict(),
    dict(vocab_size=2048, max_len=2048, d_model=2048, n_heads=16, n_blocks=8),
    dict(vocab_size=97, max_len=33, d_model=48, n_heads=3, n_blocks=1,
         ffn_mult=2, dtype="float32", seed=7),
]


@pytest.mark.parametrize("kw", SIZES)
def test_jax_json_loads_and_rewrites_identically(kw):
    jconf = jzoo.TransformerLM(**kw)
    d = json.loads(jconf.to_json())
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    assert d["format"] == "deeplearning4j_tpu/MultiLayerConfiguration"
    assert json.loads(conf.to_json()) == d
    assert conf == MultiLayerConfiguration.from_dict(d)


@pytest.mark.parametrize("kw", SIZES)
def test_port_json_loads_in_the_jax_package(kw):
    conf = zoo.TransformerLM(**kw)
    d = json.loads(conf.to_json())
    assert JConf.from_json(conf.to_json()).to_dict() == d
    assert d == json.loads(jzoo.TransformerLM(**kw).to_json())


def test_yaml_round_trip():
    conf = zoo.TransformerLM(vocab_size=31, d_model=16, n_heads=2, n_blocks=1)
    assert MultiLayerConfiguration.from_yaml(conf.to_yaml()) == conf


@pytest.mark.parametrize("layer", [
    EmbeddingSequence(n_in=11, n_out=4, weight_init=Distribution("uniform", lower=-0.1, upper=0.1)),
    PositionalEmbedding(max_len=9, name="pos"),
    MultiHeadAttention(n_heads=2, causal=True, attn_dropout=0.1, use_flash=False),
    TransformerBlock(n_heads=4, ffn_mult=2, use_flash=True, eps=1e-6),
    LayerNorm(eps=1e-3, use_gamma_beta=False),
    RnnOutputLayer(n_out=5, activation="softmax", constraints=({"type": "max_norm"},)),
])
def test_layer_round_trips_across_packages(layer):
    s = layer.to_json()
    assert LayerConfig.from_json(s) == layer
    assert JLayerConfig.from_json(s).to_dict() == json.loads(s)


def test_unported_layer_type_raises_naming_it():
    # a tag that no package registers: the refusal names it
    d = json.loads(jzoo.TransformerLM(vocab_size=31, d_model=16, n_heads=2,
                                      n_blocks=2).to_json())
    d["layers"][2] = dict(d["layers"][2], **{"@type": "no_such_layer"})
    with pytest.raises(ValueError, match="no_such_layer.*not ported"):
        MultiLayerConfiguration.from_dict(d)


@pytest.mark.parametrize("kw", [
    dict(vocab_size=31, d_model=16, n_heads=2, n_blocks=2, moe_experts=2),
    dict(vocab_size=2048, max_len=2048, d_model=2048, n_heads=16, n_blocks=8,
         moe_experts=8),
])
def test_jax_moe_json_loads_and_round_trips(kw):
    jconf = jzoo.TransformerLM(**kw)
    d = json.loads(jconf.to_json())
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    assert sum(l["@type"] == "mixture_of_experts" for l in d["layers"]) == kw["n_blocks"] // 2
    assert json.loads(conf.to_json()) == d
    assert conf == zoo.TransformerLM(**kw)
    assert JConf.from_json(conf.to_json()).to_dict() == d


def test_every_jax_layer_type_is_registered():
    import deeplearning4j_tpu.nn.layers  # noqa: F401  (registers every tag)
    from deeplearning4j_tpu.nn.config import layer_registry as jreg
    from deeplearning4j_tpu_torch.nn.config import layer_registry

    # the tags the JAX package's own modules register; a test module that
    # registers a custom layer in the same process is not the package's
    builtin = {tag for tag, cls in jreg.items()
               if cls.__module__.startswith("deeplearning4j_tpu.")}
    assert len(builtin) >= 56
    assert builtin <= set(layer_registry)


@pytest.mark.parametrize("make,kw", [
    ("LeNet5", dict()), ("LeNet5", dict(height=12, width=12, num_classes=7, dtype="bfloat16")),
    ("SimpleCNN", dict()), ("SimpleCNN", dict(height=12, width=12, channels=1, seed=4)),
])
def test_cnn_zoo_json_reads_and_writes_across_packages(make, kw):
    jconf = getattr(jzoo, make)(**kw)
    d = json.loads(jconf.to_json())
    conf = MultiLayerConfiguration.from_json(jconf.to_json())
    assert json.loads(conf.to_json()) == d
    assert conf == getattr(zoo, make)(**kw)
    assert JConf.from_json(conf.to_json()).to_dict() == d
