"""Layer configs ported so far (PyTorch).

Importing this package registers every ported ``@type`` tag for config
serde: the core, convolution, pooling, normalization, attention and
recurrent layers, the mixture of experts, the custom-layer API and its heads, the variational
autoencoder and the YOLOv2 output layer (the preprocessors' tags register with
``nn/preprocessors.py``, which the model imports).
"""

from deeplearning4j_tpu_torch.nn.layers.attention import (
    MultiHeadAttention,
    PositionalEmbedding,
    TransformerBlock,
)
from deeplearning4j_tpu_torch.nn.layers.convolution import (
    Conv1D,
    Conv2D,
    Cropping1D,
    Cropping2D,
    Deconv2D,
    DepthToSpace,
    DepthwiseConv2D,
    SeparableConv2D,
    SpaceToDepth,
    Subsampling1D,
    Subsampling2D,
    Upsampling1D,
    Upsampling2D,
    ZeroPadding1D,
    ZeroPadding2D,
)
from deeplearning4j_tpu_torch.nn.layers.core import (
    ActivationLayer,
    AlphaDropout,
    AutoEncoder,
    Dense,
    DropoutLayer,
    ELULayer,
    Embedding,
    EmbeddingSequence,
    GaussianDropout,
    GaussianNoise,
    LeakyReLULayer,
    LossLayer,
    OutputLayer,
    Permute,
    PReLU,
    RepeatVector,
    SpatialDropout,
    ThresholdedReLULayer,
)
from deeplearning4j_tpu_torch.nn.layers.custom import (
    CenterLossOutputLayer,
    CnnLossLayer,
    CustomLayer,
    FrozenLayer,
    LambdaLayer,
)
from deeplearning4j_tpu_torch.nn.layers.moe import MixtureOfExperts
from deeplearning4j_tpu_torch.nn.layers.normalization import (
    BatchNorm,
    LayerNorm,
    LocalResponseNormalization,
    layer_norm,
)
from deeplearning4j_tpu_torch.nn.layers.objdetect import Yolo2OutputLayer
from deeplearning4j_tpu_torch.nn.layers.pooling import GlobalPooling
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
from deeplearning4j_tpu_torch.nn.layers.variational import VariationalAutoencoder

__all__ = [
    "ActivationLayer",
    "AlphaDropout",
    "AutoEncoder",
    "BaseRecurrent",
    "BatchNorm",
    "Bidirectional",
    "BidirectionalLastTimeStep",
    "CenterLossOutputLayer",
    "CnnLossLayer",
    "Conv1D",
    "Conv2D",
    "Cropping1D",
    "Cropping2D",
    "CustomLayer",
    "Deconv2D",
    "Dense",
    "DepthToSpace",
    "DepthwiseConv2D",
    "DropoutLayer",
    "ELULayer",
    "Embedding",
    "EmbeddingSequence",
    "FrozenLayer",
    "GRU",
    "GaussianDropout",
    "GaussianNoise",
    "GlobalPooling",
    "GravesLSTM",
    "LSTM",
    "LambdaLayer",
    "LastTimeStep",
    "LayerNorm",
    "LeakyReLULayer",
    "LocalResponseNormalization",
    "LossLayer",
    "MaskZero",
    "MixtureOfExperts",
    "MultiHeadAttention",
    "OutputLayer",
    "PReLU",
    "Permute",
    "PositionalEmbedding",
    "RepeatVector",
    "RnnOutputLayer",
    "SeparableConv2D",
    "SimpleRnn",
    "SpaceToDepth",
    "SpatialDropout",
    "Subsampling1D",
    "Subsampling2D",
    "ThresholdedReLULayer",
    "TransformerBlock",
    "Upsampling1D",
    "Upsampling2D",
    "VariationalAutoencoder",
    "Yolo2OutputLayer",
    "ZeroPadding1D",
    "ZeroPadding2D",
    "layer_norm",
]
