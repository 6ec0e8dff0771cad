"""Input preprocessors: shape adapters auto-inserted between layer kinds
(PyTorch port of ``nn/preprocessors.py``).

Reference parity: nn/conf/preprocessor/{CnnToFeedForwardPreProcessor,
FeedForwardToCnnPreProcessor,FeedForwardToRnnPreProcessor,
RnnToFeedForwardPreProcessor,CnnToRnnPreProcessor,RnnToCnnPreProcessor}.java,
as param-free layers under the same JSON tags, so they flow through the
same registry, serde and apply machinery. Activations are NHWC and
[b, t, f] as in the JAX package, so ``pp_cnn_to_ff`` flattens in (h, w, c)
order and a Dense after a conv reads the same features.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from deeplearning4j_tpu_torch.nn.config import LayerConfig, register_layer
from deeplearning4j_tpu_torch.nn.input_type import InputType


@register_layer("pp_cnn_to_ff")
@dataclass
class CnnToFeedForward(LayerConfig):
    """[b, h, w, c] -> [b, h*w*c]."""

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(input_type.height * input_type.width * input_type.channels)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return x.reshape(x.shape[0], -1), state


@register_layer("pp_ff_to_cnn")
@dataclass
class FeedForwardToCnn(LayerConfig):
    """[b, h*w*c] -> [b, h, w, c] (also conv_flat -> conv)."""

    height: int = 0
    width: int = 0
    channels: int = 0

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.convolutional(self.height, self.width, self.channels)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return x.reshape(x.shape[0], self.height, self.width, self.channels), state


@register_layer("pp_rnn_to_ff")
@dataclass
class RnnToFeedForward(LayerConfig):
    """[b, t, f] -> [b*t, f]: time steps flattened into the batch."""

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.feed_forward(input_type.size)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return x.reshape(-1, x.shape[-1]), state

    def propagate_mask(self, mask, input_type):
        return mask.reshape(-1) if mask is not None else None


@register_layer("pp_ff_to_rnn")
@dataclass
class FeedForwardToRnn(LayerConfig):
    """[b*t, f] -> [b, t, f]; needs static timesteps."""

    timesteps: int = 1

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(input_type.size, self.timesteps)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return x.reshape(-1, self.timesteps, x.shape[-1]), state

    def propagate_mask(self, mask, input_type):
        return mask.reshape(-1, self.timesteps) if mask is not None else None


@register_layer("pp_cnn_to_rnn")
@dataclass
class CnnToRnn(LayerConfig):
    """[b, h, w, c] -> [b, h, w*c]: height as time, width and channels
    flattened per row."""

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.recurrent(input_type.width * input_type.channels, input_type.height)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        b, h, w, c = x.shape
        return x.reshape(b, h, w * c), state


@register_layer("pp_rnn_to_cnn")
@dataclass
class RnnToCnn(LayerConfig):
    """[b, t, f] -> [b, h, w, c]."""

    height: int = 0
    width: int = 0
    channels: int = 0

    def output_type(self, input_type: InputType) -> InputType:
        return InputType.convolutional(self.height, self.width, self.channels)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return x.reshape(x.shape[0], self.height, self.width, self.channels), state


@register_layer("reshape")
@dataclass
class Reshape(LayerConfig):
    """Generic reshape (ReshapeVertex's counterpart); ``shape`` excludes
    the batch axis."""

    shape: tuple = ()

    def output_type(self, input_type: InputType) -> InputType:
        s = tuple(self.shape)
        if len(s) == 1:
            return InputType.feed_forward(s[0])
        if len(s) == 2:
            return InputType.recurrent(s[1], s[0])
        if len(s) == 3:
            return InputType.convolutional(s[0], s[1], s[2])
        raise ValueError(f"Unsupported reshape target {s}")

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return x.reshape((x.shape[0],) + tuple(self.shape)), state


def infer_preprocessor(from_type: InputType, to_layer) -> Optional[LayerConfig]:
    """The shape adapter to insert before ``to_layer``, or None when shapes
    already line up (the reference's ``setInputType`` inference).

    Three layer groups matter:
    - conv layers (need [b, h, w, c] input),
    - rnn layers (need [b, t, f] input),
    - shape-preserving layers (BatchNorm, dropout and noise, activations,
      global pooling): consume any rank as it is, never an adapter.
    Everything else (Dense, Output, Embedding, ...) consumes flat [b, f].
    """
    from deeplearning4j_tpu_torch.nn.layers.convolution import (
        Conv1D,
        Conv2D,
        Subsampling1D,
        Subsampling2D,
        Upsampling2D,
        ZeroPadding2D,
    )
    from deeplearning4j_tpu_torch.nn.layers.core import (
        ActivationLayer,
        AlphaDropout,
        DropoutLayer,
        ELULayer,
        GaussianDropout,
        GaussianNoise,
        LeakyReLULayer,
        PReLU,
        ThresholdedReLULayer,
    )
    from deeplearning4j_tpu_torch.nn.layers.normalization import (
        BatchNorm,
        LocalResponseNormalization,
    )
    from deeplearning4j_tpu_torch.nn.layers.pooling import GlobalPooling
    from deeplearning4j_tpu_torch.nn.layers.recurrent import (
        BaseRecurrent,
        Bidirectional,
        LastTimeStep,
        MaskZero,
    )

    conv_layers = (Conv2D, Subsampling2D, Upsampling2D, ZeroPadding2D, LocalResponseNormalization)
    rnn_layers = (BaseRecurrent, Bidirectional, LastTimeStep, MaskZero, Conv1D, Subsampling1D)
    shape_preserving = (
        BatchNorm,
        GlobalPooling,
        ActivationLayer,
        DropoutLayer,
        GaussianNoise,
        GaussianDropout,
        AlphaDropout,
        # parameterized activations consume any rank (PReLU's learned alpha
        # follows the input shape at init time)
        LeakyReLULayer,
        ELULayer,
        ThresholdedReLULayer,
        PReLU,
    )

    if isinstance(to_layer, shape_preserving):
        return None
    if getattr(to_layer, "CONSUMES_CONV", False) and from_type.kind in ("conv", "conv_flat"):
        # layers that take [b, h, w, c] without being "conv layers"
        # (Cropping2D, SpaceToDepth, DepthToSpace)
        if from_type.kind == "conv_flat":
            return FeedForwardToCnn(height=from_type.height, width=from_type.width,
                                    channels=from_type.channels)
        return None
    if isinstance(to_layer, conv_layers) and from_type.kind == "conv_flat":
        return FeedForwardToCnn(height=from_type.height, width=from_type.width,
                                channels=from_type.channels)
    if isinstance(to_layer, conv_layers) and from_type.kind == "ff":
        raise ValueError(
            "Feed-forward input into a convolutional layer: specify "
            "InputType.convolutional_flat(...) so the reshape target is known"
        )
    if from_type.kind == "conv" and not isinstance(to_layer, conv_layers):
        if isinstance(to_layer, rnn_layers):
            return CnnToRnn()
        return CnnToFeedForward()
    return None
