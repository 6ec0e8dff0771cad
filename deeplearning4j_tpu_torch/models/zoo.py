"""Zoo architectures (PyTorch port of ``models/zoo.py``).

Ported so far: ``LeNet5`` and ``SimpleCNN`` (the classic convolutional
MultiLayerNetworks), ``TransformerLM``, the framework's flagship
decoder-only language model (with its mixture-of-experts option), and
``TextGenerationLSTM``, the GravesLSTM char-RNN. Each builds the same
configuration (and JSON) as the JAX package's.
"""

from __future__ import annotations

from deeplearning4j_tpu_torch.nn.input_type import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    BatchNorm,
    Conv2D,
    Dense,
    DropoutLayer,
    EmbeddingSequence,
    GravesLSTM,
    LayerNorm,
    MixtureOfExperts,
    OutputLayer,
    PositionalEmbedding,
    RnnOutputLayer,
    Subsampling2D,
    TransformerBlock,
)
from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration


def LeNet5(height: int = 28, width: int = 28, channels: int = 1,
           num_classes: int = 10, updater=None, seed: int = 12345,
           dtype: str = "float32") -> MultiLayerConfiguration:
    """LeNet-5 (zoo/model/LeNet.java, BASELINE config #1): conv 5x5x20,
    max pool, conv 5x5x50, max pool, dense 500 (relu), softmax; SAME
    convolutions, Adam 1e-3."""
    return MultiLayerConfiguration(
        layers=(
            Conv2D(n_out=20, kernel=(5, 5), stride=(1, 1), activation="identity",
                   convolution_mode="same"),
            Subsampling2D(kernel=(2, 2), stride=(2, 2), pooling="max"),
            Conv2D(n_out=50, kernel=(5, 5), stride=(1, 1), activation="identity",
                   convolution_mode="same"),
            Subsampling2D(kernel=(2, 2), stride=(2, 2), pooling="max"),
            Dense(n_out=500, activation="relu"),
            OutputLayer(n_out=num_classes, activation="softmax", loss="mcxent"),
        ),
        input_type=InputType.convolutional(height, width, channels),
        updater=updater or {"type": "adam", "lr": 1e-3},
        seed=seed,
        dtype=dtype,
    )


def SimpleCNN(height: int = 48, width: int = 48, channels: int = 3,
              num_classes: int = 10, updater=None, seed: int = 12345) -> MultiLayerConfiguration:
    """SimpleCNN.java: four SAME 3x3 convolutions (16, 16, 32, 32) each
    followed by BatchNorm, a 2x2 max pool after each pair, dropout 0.5,
    dense 256 (relu), softmax; Adam 1e-3."""
    return MultiLayerConfiguration(
        layers=(
            Conv2D(n_out=16, kernel=(3, 3), activation="relu", convolution_mode="same"),
            BatchNorm(),
            Conv2D(n_out=16, kernel=(3, 3), activation="relu", convolution_mode="same"),
            BatchNorm(),
            Subsampling2D(kernel=(2, 2), stride=(2, 2)),
            Conv2D(n_out=32, kernel=(3, 3), activation="relu", convolution_mode="same"),
            BatchNorm(),
            Conv2D(n_out=32, kernel=(3, 3), activation="relu", convolution_mode="same"),
            BatchNorm(),
            Subsampling2D(kernel=(2, 2), stride=(2, 2)),
            DropoutLayer(dropout=0.5),
            Dense(n_out=256, activation="relu"),
            OutputLayer(n_out=num_classes, activation="softmax"),
        ),
        input_type=InputType.convolutional(height, width, channels),
        updater=updater or {"type": "adam", "lr": 1e-3},
        seed=seed,
    )


def TextGenerationLSTM(vocab_size: int = 77, timesteps: int = 50,
                       hidden: int = 256, updater=None, seed: int = 12345,
                       dtype: str = "float32") -> MultiLayerConfiguration:
    """TextGenerationLSTM.java, the GravesLSTM char-RNN: 2 x GravesLSTM
    (``hidden``) and a time-distributed softmax over ``vocab_size``
    characters, RMSProp, truncated BPTT of length 50. The same
    configuration (and JSON) as the JAX package's."""
    return MultiLayerConfiguration(
        layers=(
            GravesLSTM(n_out=hidden),
            GravesLSTM(n_out=hidden),
            RnnOutputLayer(n_out=vocab_size, activation="softmax", loss="mcxent"),
        ),
        input_type=InputType.recurrent(vocab_size, timesteps),
        updater=updater or {"type": "rmsprop", "lr": 1e-3},
        seed=seed,
        backprop_type="tbptt",
        tbptt_fwd_length=50,
        tbptt_back_length=50,
        dtype=dtype,
    )


def TransformerLM(vocab_size: int = 256, max_len: int = 512, d_model: int = 256,
                  n_heads: int = 8, n_blocks: int = 4, ffn_mult: int = 4,
                  sequence_parallel: bool = False, moe_experts: int = 0,
                  updater=None, seed: int = 12345,
                  dtype: str = "bfloat16") -> MultiLayerConfiguration:
    """Decoder-only transformer language model: token + learned positional
    embedding, ``n_blocks`` causal pre-LN transformer blocks (with
    ``moe_experts > 0``, a switch MixtureOfExperts after every second
    block), a final LayerNorm and a time-distributed softmax over the
    vocabulary. The same configuration (and JSON) as the JAX package's
    ``TransformerLM``."""
    layers = [
        EmbeddingSequence(n_in=vocab_size, n_out=d_model),
        PositionalEmbedding(max_len=max_len),
    ]
    for i in range(n_blocks):
        layers.append(TransformerBlock(
            n_heads=n_heads, ffn_mult=ffn_mult, causal=True,
            sequence_parallel=sequence_parallel,
        ))
        if moe_experts and i % 2 == 1:  # MoE every second block, switch-style
            layers.append(MixtureOfExperts(n_experts=moe_experts, ffn_mult=ffn_mult))
    layers += [
        LayerNorm(),
        RnnOutputLayer(n_out=vocab_size, activation="softmax", loss="mcxent"),
    ]
    return MultiLayerConfiguration(
        layers=tuple(layers),
        input_type=InputType.recurrent(vocab_size, max_len),
        updater=updater or {"type": "adam", "lr": 3e-4},
        seed=seed,
        dtype=dtype,
    )
