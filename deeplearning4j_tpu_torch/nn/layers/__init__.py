"""Layer configs ported so far (PyTorch).

Importing this package registers every ported ``@type`` tag for config
serde.
"""

from deeplearning4j_tpu_torch.nn.layers.attention import (
    MultiHeadAttention,
    PositionalEmbedding,
    TransformerBlock,
)
from deeplearning4j_tpu_torch.nn.layers.core import EmbeddingSequence
from deeplearning4j_tpu_torch.nn.layers.normalization import LayerNorm, layer_norm
from deeplearning4j_tpu_torch.nn.layers.recurrent import (
    GRU,
    LSTM,
    BaseRecurrent,
    Bidirectional,
    BidirectionalLastTimeStep,
    GravesLSTM,
    LastTimeStep,
    MaskZero,
    RnnOutputLayer,
    SimpleRnn,
)

__all__ = [
    "BaseRecurrent",
    "Bidirectional",
    "BidirectionalLastTimeStep",
    "EmbeddingSequence",
    "GRU",
    "GravesLSTM",
    "LSTM",
    "LastTimeStep",
    "LayerNorm",
    "MaskZero",
    "MultiHeadAttention",
    "PositionalEmbedding",
    "RnnOutputLayer",
    "SimpleRnn",
    "TransformerBlock",
    "layer_norm",
]
