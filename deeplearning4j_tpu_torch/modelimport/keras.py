"""Keras HDF5 model import (PyTorch port of
``deeplearning4j_tpu/modelimport/keras.py``).

Capability parity with the reference's deeplearning4j-modelimport module:
KerasModelImport.java:50-121 (entry points), KerasSequentialModel /
KerasModel (config parsing), utils/KerasModelUtils (weight setting), and the
per-layer converters under layers/** (~40 Keras layer classes; the ~17
load-bearing ones are implemented here).

Keras channels_last conventions (NHWC activations, HWIO conv kernels,
Dense [in,out] kernels, LSTM i/f/c/o gate blocks in
kernel/recurrent_kernel/bias) are ALSO this framework's native layouts (the
JAX package's), so weights transfer without transposition — unlike the
reference, which permutes every kernel into NCHW buffers
(KerasConvolutionUtils). The converters are the JAX package's; the weights
become tensors on the model's device (the GPU unless ``device=`` names
another; with no GPU and no ``device`` the import raises).

The HDF5 container is read with h5py (imported at first use), and only
there: :func:`model_from_config` builds a model from the model-config JSON
and a ``{layer name: [arrays in Keras weight order]}`` dict, which is the
whole conversion and needs no h5py. Model-config JSON can also be imported
alone (importKerasModelConfiguration parity).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraph,
    ComputationGraphConfiguration,
    ElementWiseVertex,
    MergeVertex,
)
from deeplearning4j_tpu_torch.nn.input_type import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    ActivationLayer,
    BatchNorm,
    Conv1D,
    Conv2D,
    Dense,
    DepthwiseConv2D,
    DropoutLayer,
    EmbeddingSequence,
    GlobalPooling,
    LSTM,
    OutputLayer,
    RnnOutputLayer,
    SeparableConv2D,
    SimpleRnn,
    Subsampling1D,
    Subsampling2D,
    Upsampling2D,
    ZeroPadding2D,
)
from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration, MultiLayerNetwork


class InvalidKerasConfigurationError(ValueError):
    """Malformed Keras config (reference exceptions/InvalidKerasConfigurationException)."""


class UnsupportedKerasConfigurationError(ValueError):
    """Keras feature with no converter (UnsupportedKerasConfigurationException)."""


# ---------------------------------------------------------------------------
# activation / padding translation
# ---------------------------------------------------------------------------

_ACTIVATIONS = {
    "linear": "identity",
    "relu": "relu",
    "relu6": "relu6",
    "sigmoid": "sigmoid",
    "hard_sigmoid": "hardsigmoid",
    "tanh": "tanh",
    "softmax": "softmax",
    "softplus": "softplus",
    "softsign": "softsign",
    "elu": "elu",
    "selu": "selu",
    "swish": "swish",
    "gelu": "gelu",
    "exponential": "exp",
    "leaky_relu": "leakyrelu",
}


def _act(name: Optional[str]) -> str:
    if name is None:
        return "identity"
    if name not in _ACTIVATIONS:
        raise UnsupportedKerasConfigurationError(f"activation {name!r}")
    return _ACTIVATIONS[name]


def _conv_mode(padding: str) -> Tuple[str, Tuple[int, int]]:
    if padding == "same":
        return "same", (0, 0)
    if padding == "valid":
        return "truncate", (0, 0)
    raise UnsupportedKerasConfigurationError(f"padding {padding!r}")


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (list, tuple)):
        return (int(v[0]), int(v[1] if len(v) > 1 else v[0]))
    return (int(v), int(v))


# ---------------------------------------------------------------------------
# per-layer converters (Keras class_name -> LayerConfig)
# ---------------------------------------------------------------------------


def _loss_for(activation: str) -> str:
    return {"softmax": "mcxent", "sigmoid": "xent"}.get(activation, "mse")


def _keras1_normalize(class_name: str, cfg: dict) -> dict:
    """Accept the Keras-1 config dialect (reference
    config/Keras1LayerConfiguration.java): legacy field names are mapped to
    their Keras-2 equivalents before conversion."""
    cfg = dict(cfg)
    if "output_dim" in cfg:
        cfg.setdefault("units", cfg["output_dim"])
    if "nb_filter" in cfg:
        cfg.setdefault("filters", cfg["nb_filter"])
    if "nb_row" in cfg:
        cfg.setdefault("kernel_size", [cfg["nb_row"], cfg.get("nb_col", cfg["nb_row"])])
    if "filter_length" in cfg:
        cfg.setdefault("kernel_size", cfg["filter_length"])
    if "subsample" in cfg:
        cfg.setdefault("strides", cfg["subsample"])
    if "subsample_length" in cfg:
        cfg.setdefault("strides", cfg["subsample_length"])
    if "border_mode" in cfg:
        cfg.setdefault("padding", cfg["border_mode"])
    if "pool_length" in cfg:
        cfg.setdefault("pool_size", cfg["pool_length"])
    if "stride" in cfg and "strides" not in cfg:
        cfg.setdefault("strides", cfg["stride"])
    if "atrous_rate" in cfg:
        # Keras-1 AtrousConvolution1D/2D (reference
        # KerasAtrousConvolution1D/2D.java): dilation under a legacy name
        cfg.setdefault("dilation_rate", cfg["atrous_rate"])
    if class_name in ("Dropout", "GaussianDropout", "AlphaDropout") and "p" in cfg:
        cfg.setdefault("rate", cfg["p"])
    if class_name == "GaussianNoise" and "sigma" in cfg:
        cfg.setdefault("stddev", cfg["sigma"])
    return cfg


def _convert_layer(class_name: str, cfg: dict, *, as_output: bool = False,
                   recurrent: bool = False):
    """Returns a LayerConfig, or None for structural layers (Flatten,
    InputLayer) that this framework expresses as preprocessors."""
    cfg = _keras1_normalize(class_name, cfg)
    if class_name in ("InputLayer", "Flatten"):
        return None
    if class_name == "Dense":
        act = _act(cfg.get("activation"))
        if as_output:
            klass = RnnOutputLayer if recurrent else OutputLayer
            return klass(
                n_out=int(cfg["units"]), activation=act, loss=_loss_for(act),
                has_bias=bool(cfg.get("use_bias", True)),
            )
        return Dense(n_out=int(cfg["units"]), activation=act,
                     has_bias=bool(cfg.get("use_bias", True)))
    if class_name in ("Conv2D", "Convolution2D", "AtrousConvolution2D"):
        mode, pad = _conv_mode(cfg.get("padding", "valid"))
        return Conv2D(
            n_out=int(cfg["filters"]), kernel=_pair(cfg.get("kernel_size", 3)),
            stride=_pair(cfg.get("strides", 1)), dilation=_pair(cfg.get("dilation_rate", 1)),
            convolution_mode=mode, padding=pad,
            activation=_act(cfg.get("activation")),
            has_bias=bool(cfg.get("use_bias", True)),
        )
    if class_name in ("Conv1D", "Convolution1D", "AtrousConvolution1D"):
        mode, _ = _conv_mode(cfg.get("padding", "valid"))
        k = cfg.get("kernel_size", 3)
        s = cfg.get("strides", 1)
        d = cfg.get("dilation_rate", 1)
        return Conv1D(
            n_out=int(cfg["filters"]),
            kernel=int(k[0] if isinstance(k, (list, tuple)) else k),
            stride=int(s[0] if isinstance(s, (list, tuple)) else s),
            dilation=int(d[0] if isinstance(d, (list, tuple)) else d),
            convolution_mode=mode, activation=_act(cfg.get("activation")),
            has_bias=bool(cfg.get("use_bias", True)),
        )
    if class_name == "DepthwiseConv2D":
        mode, pad = _conv_mode(cfg.get("padding", "valid"))
        return DepthwiseConv2D(
            kernel=_pair(cfg.get("kernel_size", 3)), stride=_pair(cfg.get("strides", 1)),
            depth_multiplier=int(cfg.get("depth_multiplier", 1)),
            convolution_mode=mode, padding=pad,
            activation=_act(cfg.get("activation")),
            has_bias=bool(cfg.get("use_bias", True)),
        )
    if class_name == "SeparableConv2D":
        mode, pad = _conv_mode(cfg.get("padding", "valid"))
        return SeparableConv2D(
            n_out=int(cfg["filters"]), kernel=_pair(cfg.get("kernel_size", 3)),
            stride=_pair(cfg.get("strides", 1)),
            depth_multiplier=int(cfg.get("depth_multiplier", 1)),
            convolution_mode=mode, padding=pad,
            activation=_act(cfg.get("activation")),
            has_bias=bool(cfg.get("use_bias", True)),
        )
    if class_name in ("MaxPooling2D", "AveragePooling2D"):
        mode, pad = _conv_mode(cfg.get("padding", "valid"))
        return Subsampling2D(
            kernel=_pair(cfg.get("pool_size", 2)),
            stride=_pair(cfg.get("strides") or cfg.get("pool_size", 2)),
            padding=pad, convolution_mode=mode,
            pooling="max" if class_name.startswith("Max") else "avg",
        )
    if class_name in ("MaxPooling1D", "AveragePooling1D"):
        mode, _ = _conv_mode(cfg.get("padding", "valid"))
        p = cfg.get("pool_size", 2)
        s = cfg.get("strides") or p
        return Subsampling1D(
            kernel=int(p[0] if isinstance(p, (list, tuple)) else p),
            stride=int(s[0] if isinstance(s, (list, tuple)) else s),
            convolution_mode=mode,
            pooling="max" if class_name.startswith("Max") else "avg",
        )
    if class_name in ("GlobalMaxPooling2D", "GlobalAveragePooling2D",
                      "GlobalMaxPooling1D", "GlobalAveragePooling1D"):
        return GlobalPooling(pooling="max" if "Max" in class_name else "avg")
    if class_name == "BatchNormalization":
        return BatchNorm(
            eps=float(cfg.get("epsilon", 1e-3)),
            decay=float(cfg.get("momentum", 0.99)),
        )
    if class_name == "Activation":
        return ActivationLayer(activation=_act(cfg.get("activation")))
    if class_name == "Dropout":
        return DropoutLayer(dropout=float(cfg.get("rate", 0.5)))
    if class_name == "Reshape":
        from deeplearning4j_tpu_torch.nn.preprocessors import Reshape

        return Reshape(shape=tuple(int(d) for d in cfg["target_shape"]))
    if class_name in ("SpatialDropout1D", "SpatialDropout2D"):
        from deeplearning4j_tpu_torch.nn.layers import SpatialDropout

        return SpatialDropout(dropout=float(cfg.get("rate", 0.5)))
    if class_name == "ZeroPadding1D":
        from deeplearning4j_tpu_torch.nn.layers import ZeroPadding1D

        # the dataclass normalizes int-or-(l,r) itself (_pads)
        return ZeroPadding1D(padding=cfg.get("padding", 1))
    if class_name == "Cropping1D":
        from deeplearning4j_tpu_torch.nn.layers import Cropping1D

        return Cropping1D(crop=cfg.get("cropping", 1))
    if class_name == "UpSampling1D":
        from deeplearning4j_tpu_torch.nn.layers import Upsampling1D

        return Upsampling1D(size=int(cfg.get("size", 2)))
    if class_name == "ZeroPadding2D":
        pad = cfg.get("padding", 1)
        if isinstance(pad, (list, tuple)) and isinstance(pad[0], (list, tuple)):
            # ((top,bottom),(left,right))
            return ZeroPadding2D(padding=(int(pad[0][0]), int(pad[0][1]),
                                          int(pad[1][0]), int(pad[1][1])))
        ph, pw = _pair(pad)
        return ZeroPadding2D(padding=(ph, ph, pw, pw))
    if class_name == "UpSampling2D":
        return Upsampling2D(size=_pair(cfg.get("size", 2)))
    if class_name == "Embedding":
        return EmbeddingSequence(n_in=int(cfg["input_dim"]),
                                 n_out=int(cfg["output_dim"]))
    if class_name == "LSTM":
        return LSTM(
            n_out=int(cfg["units"]), activation=_act(cfg.get("activation", "tanh")),
            gate_activation=_act(cfg.get("recurrent_activation", "sigmoid")),
        )
    if class_name == "GRU":
        from deeplearning4j_tpu_torch.nn.layers import GRU

        return GRU(
            n_out=int(cfg["units"]), activation=_act(cfg.get("activation", "tanh")),
            gate_activation=_act(cfg.get("recurrent_activation", "sigmoid")),
            reset_after=bool(cfg.get("reset_after", True)),
        )
    if class_name == "SimpleRNN":
        return SimpleRnn(n_out=int(cfg["units"]),
                         activation=_act(cfg.get("activation", "tanh")))
    if class_name == "Conv2DTranspose":
        mode, pad = _conv_mode(cfg.get("padding", "valid"))
        from deeplearning4j_tpu_torch.nn.layers import Deconv2D

        if cfg.get("output_padding") not in (None, 0, [0, 0], (0, 0)):
            raise UnsupportedKerasConfigurationError(
                f"Conv2DTranspose output_padding {cfg['output_padding']!r}")
        if _pair(cfg.get("dilation_rate", 1)) != (1, 1):
            raise UnsupportedKerasConfigurationError(
                f"Conv2DTranspose dilation_rate {cfg['dilation_rate']!r}")
        return Deconv2D(
            n_out=int(cfg["filters"]), kernel=_pair(cfg.get("kernel_size", 3)),
            stride=_pair(cfg.get("strides", 1)),
            convolution_mode=mode, padding=pad,
            activation=_act(cfg.get("activation")),
            has_bias=bool(cfg.get("use_bias", True)),
        )
    if class_name == "Cropping2D":
        from deeplearning4j_tpu_torch.nn.layers import Cropping2D

        c = cfg.get("cropping", 0)
        if isinstance(c, (list, tuple)) and c and isinstance(c[0], (list, tuple)):
            crop = (int(c[0][0]), int(c[0][1]), int(c[1][0]), int(c[1][1]))
        else:
            ch, cw = _pair(c)
            crop = (ch, ch, cw, cw)
        return Cropping2D(crop=crop)
    if class_name == "LeakyReLU":
        from deeplearning4j_tpu_torch.nn.layers import LeakyReLULayer

        alpha = cfg.get("negative_slope", cfg.get("alpha", 0.3))
        return LeakyReLULayer(alpha=float(alpha))
    if class_name == "ELU":
        from deeplearning4j_tpu_torch.nn.layers import ELULayer

        return ELULayer(alpha=float(cfg.get("alpha", 1.0)))
    if class_name == "ThresholdedReLU":
        from deeplearning4j_tpu_torch.nn.layers import ThresholdedReLULayer

        return ThresholdedReLULayer(theta=float(cfg.get("theta", 1.0)))
    if class_name == "PReLU":
        from deeplearning4j_tpu_torch.nn.layers import PReLU

        if cfg.get("shared_axes"):
            raise UnsupportedKerasConfigurationError("PReLU shared_axes")
        return PReLU()
    if class_name == "Permute":
        from deeplearning4j_tpu_torch.nn.layers import Permute

        return Permute(dims=tuple(int(d) for d in cfg["dims"]))
    if class_name == "RepeatVector":
        from deeplearning4j_tpu_torch.nn.layers import RepeatVector

        return RepeatVector(n=int(cfg["n"]))
    if class_name == "GaussianNoise":
        from deeplearning4j_tpu_torch.nn.layers import GaussianNoise

        return GaussianNoise(stddev=float(cfg["stddev"]))
    if class_name == "GaussianDropout":
        from deeplearning4j_tpu_torch.nn.layers import GaussianDropout

        return GaussianDropout(rate=float(cfg["rate"]))
    if class_name == "AlphaDropout":
        from deeplearning4j_tpu_torch.nn.layers import AlphaDropout

        return AlphaDropout(dropout=float(cfg["rate"]))
    if class_name == "Bidirectional":
        from deeplearning4j_tpu_torch.nn.layers import Bidirectional

        inner_cfg = cfg["layer"]
        inner = _convert_layer(inner_cfg["class_name"],
                               inner_cfg.get("config", {}))
        mode = {"concat": "concat", "sum": "add", "ave": "average",
                "mul": "mul"}.get(cfg.get("merge_mode", "concat"))
        if mode is None:
            raise UnsupportedKerasConfigurationError(
                f"Bidirectional merge_mode {cfg.get('merge_mode')!r}")
        bidir = Bidirectional(rnn=inner, mode=mode)
        if not inner_cfg.get("config", {}).get("return_sequences", False):
            # Keras return_sequences=False: fwd LAST step ++ bwd FINAL state
            # (= step 0 after the flip-back) — a plain LastTimeStep would be
            # wrong for the backward half
            if mode != "concat":
                raise UnsupportedKerasConfigurationError(
                    "Bidirectional(return_sequences=False) with merge_mode "
                    f"{cfg.get('merge_mode')!r}")
            from deeplearning4j_tpu_torch.nn.layers import BidirectionalLastTimeStep

            return BidirectionalLastTimeStep(rnn=bidir)
        return bidir
    raise UnsupportedKerasConfigurationError(f"Keras layer {class_name!r}")


_RETURNS_SEQUENCES = ("LSTM", "SimpleRNN", "GRU")


def _keras_input_type(shape: Sequence[Optional[int]],
                      first_class: str) -> InputType:
    """batch_input_shape (leading None) -> InputType."""
    dims = [d for d in shape[1:]]
    if len(dims) == 3:
        return InputType.convolutional(int(dims[0]), int(dims[1]), int(dims[2]))
    if len(dims) == 2:
        if first_class == "Conv1D":
            return InputType.recurrent(int(dims[1]), int(dims[0]))
        return InputType.recurrent(int(dims[1]), int(dims[0]))
    if len(dims) == 1:
        if first_class == "Embedding":
            # [B, T] integer sequence input
            return InputType.recurrent(1, int(dims[0]))
        return InputType.feed_forward(int(dims[0]))
    raise UnsupportedKerasConfigurationError(f"input shape {shape}")


# ---------------------------------------------------------------------------
# weight mapping
# ---------------------------------------------------------------------------


def _set_weights(layer_conf, keras_weights: List[np.ndarray], params: dict,
                 state: dict, device=None) -> Tuple[dict, dict]:
    """Map a Keras layer's weight list onto (params, state) dicts of tensors
    on ``device``. Shapes are identical to ours (module docstring), so this
    is naming, not math."""

    def as_tensor(a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    t = type(layer_conf).__name__
    w = [np.asarray(a) for a in keras_weights]
    p = dict(params)
    s = dict(state) if isinstance(state, dict) else state
    if t in ("Dense", "OutputLayer", "RnnOutputLayer", "Conv2D", "Conv1D",
             "SeparableConv2D"):
        if t == "SeparableConv2D":
            dw, pw = w[0], w[1]
            kh, kw_, in_c, mult = dw.shape
            p["dW"] = as_tensor(dw.reshape(kh, kw_, 1, in_c * mult))
            p["pW"] = as_tensor(pw)
            if len(w) > 2:
                p["b"] = as_tensor(w[2])
        else:
            p["W"] = as_tensor(w[0])
            if len(w) > 1:
                p["b"] = as_tensor(w[1])
    elif t == "DepthwiseConv2D":
        dw = w[0]
        kh, kw_, in_c, mult = dw.shape
        p["W"] = as_tensor(dw.reshape(kh, kw_, 1, in_c * mult))
        if len(w) > 1:
            p["b"] = as_tensor(w[1])
    elif t == "BatchNorm":
        p["gamma"] = as_tensor(w[0])
        p["beta"] = as_tensor(w[1])
        s = {"mean": as_tensor(w[2]), "var": as_tensor(w[3])}
    elif t == "Deconv2D":
        # Keras Conv2DTranspose kernel is (kh, kw, OUT, IN) with
        # gradient-of-conv semantics; lax.conv_transpose with HWIO
        # (transpose_kernel=False) consumes the kernel directly, so the
        # equivalent native kernel is the spatially-FLIPPED transpose
        k = w[0]
        p["W"] = as_tensor(np.flip(k, axis=(0, 1)).transpose(0, 1, 3, 2))
        if len(w) > 1:
            p["b"] = as_tensor(w[1])
    elif t == "PReLU":
        p["alpha"] = as_tensor(w[0])
    elif t == "Bidirectional":
        if len(w) != 6:
            raise UnsupportedKerasConfigurationError(
                f"Bidirectional expects 6 weight arrays, got {len(w)}")

        def _dir(kernel, rec, bias):
            inner = type(layer_conf.rnn).__name__
            if inner == "GRU":
                b = np.asarray(bias)
                d = {"Wx": as_tensor(kernel), "Wh": as_tensor(rec)}
                if b.ndim == 2:      # reset_after=True: [2, 3H]
                    d["b_in"] = as_tensor(b[0])
                    d["b_rec"] = as_tensor(b[1])
                else:
                    d["b_in"] = as_tensor(b)
                return d
            return {"Wx": as_tensor(kernel), "Wh": as_tensor(rec),
                    "b": as_tensor(bias)}

        p["fwd"] = _dir(w[0], w[1], w[2])
        p["bwd"] = _dir(w[3], w[4], w[5])
    elif t == "GRU":
        p["Wx"] = as_tensor(w[0])
        p["Wh"] = as_tensor(w[1])
        if len(w) > 2:
            b = np.asarray(w[2])
            if b.ndim == 2:          # reset_after=True: [2, 3H] (input, rec)
                p["b_in"] = as_tensor(b[0])
                p["b_rec"] = as_tensor(b[1])
            else:                     # reset_after=False: single [3H]
                p["b_in"] = as_tensor(b)
    elif t in ("LSTM", "SimpleRnn"):
        p["Wx"] = as_tensor(w[0])
        p["Wh"] = as_tensor(w[1])
        if len(w) > 2:
            p["b"] = as_tensor(w[2])
    elif t == "EmbeddingSequence":
        p["W"] = as_tensor(w[0])
    elif w:
        raise UnsupportedKerasConfigurationError(
            f"no weight mapping for layer type {t}"
        )
    return p, s


# ---------------------------------------------------------------------------
# HDF5 reading
# ---------------------------------------------------------------------------


def _read_h5(path: str):
    """The HDF5 file, opened with h5py (imported here, at first use)."""
    try:
        import h5py
    except ImportError as e:  # pragma: no cover - h5py is in the image
        raise UnsupportedKerasConfigurationError(
            "h5py is required for HDF5 import (model_from_config takes the "
            "model-config JSON and the weights without it)"
        ) from e
    return h5py.File(path, "r")


def _model_config_from_h5(f) -> dict:
    raw = f.attrs.get("model_config")
    if raw is None:
        raise InvalidKerasConfigurationError("no model_config attribute in HDF5")
    if isinstance(raw, bytes):
        raw = raw.decode("utf-8")
    return json.loads(raw)


def _layer_weights_from_h5(f) -> Dict[str, List[np.ndarray]]:
    """{layer_name: [arrays in keras weight_names order]}."""
    grp = f["model_weights"] if "model_weights" in f else f
    out: Dict[str, List[np.ndarray]] = {}
    for lname in grp.attrs.get("layer_names", list(grp.keys())):
        if isinstance(lname, bytes):
            lname = lname.decode("utf-8")
        g = grp[lname]
        wnames = g.attrs.get("weight_names", [])
        arrays = []
        for wn in wnames:
            if isinstance(wn, bytes):
                wn = wn.decode("utf-8")
            arrays.append(np.asarray(g[wn]))
        if arrays:
            out[lname] = arrays
    return out


# ---------------------------------------------------------------------------
# model assembly
# ---------------------------------------------------------------------------


def _sequential_from_config(model_config: dict) -> Tuple[MultiLayerConfiguration, List[Optional[str]]]:
    """Build a MultiLayerConfiguration; returns (conf, keras layer name per
    OUR layer index) for weight pairing."""
    layers_cfg = model_config["config"]
    if isinstance(layers_cfg, dict):
        layers_cfg = layers_cfg.get("layers", [])
    if not layers_cfg:
        raise InvalidKerasConfigurationError("empty Sequential config")

    first = layers_cfg[0]
    shape = first["config"].get("batch_input_shape") or first["config"].get("batch_shape")
    if shape is None:
        raise InvalidKerasConfigurationError("first layer lacks batch_input_shape")
    first_real = next(
        lc["class_name"] for lc in layers_cfg if lc["class_name"] != "InputLayer"
    )
    input_type = _keras_input_type(shape, first_real)

    # a net is recurrent at the output if the LAST rnn layer returns sequences
    def _returns_seq(lc):
        if lc["class_name"] in _RETURNS_SEQUENCES:
            return lc["config"].get("return_sequences")
        if lc["class_name"] == "Bidirectional":
            return lc["config"].get("layer", {}).get("config", {}).get(
                "return_sequences")
        return False

    recurrent_out = any(_returns_seq(lc) for lc in layers_cfg[-3:])

    our_layers: List = []
    names: List[Optional[str]] = []
    _structural = ("InputLayer", "Flatten", "Dropout", "Activation",
                   "LeakyReLU", "ELU", "ThresholdedReLU", "PReLU",
                   "Cropping2D", "Permute", "RepeatVector",
                   "GaussianNoise", "GaussianDropout", "AlphaDropout",
                   "Masking", "Reshape", "SpatialDropout1D",
                   "SpatialDropout2D", "ZeroPadding1D", "ZeroPadding2D",
                   "Cropping1D", "UpSampling1D", "UpSampling2D")
    last_idx = max(
        i for i, lc in enumerate(layers_cfg)
        if lc["class_name"] not in _structural
    )
    cur_it = input_type
    pending_mask: Optional[float] = None
    mask_consumed = False
    _rnn_classes = set(_RETURNS_SEQUENCES) | {"Bidirectional"}
    # rnn_later[i]: does any layer AFTER index i still need the mask?
    rnn_later = [False] * (len(layers_cfg) + 1)
    for k in range(len(layers_cfg) - 1, -1, -1):
        rnn_later[k] = rnn_later[k + 1] or (
            layers_cfg[k]["class_name"] in _rnn_classes)
    # inference-identity layers keep zeros zero, so the derived mask survives
    _mask_transparent = ("Dropout", "SpatialDropout1D", "SpatialDropout2D",
                         "GaussianNoise", "GaussianDropout", "AlphaDropout")
    for i, lc in enumerate(layers_cfg):
        cn = lc["class_name"]
        cfg = lc.get("config", {})
        if cn == "Masking":
            # defer: the next recurrent layer is wrapped in MaskZero so the
            # mask is derived from its input (recurrent/MaskZeroLayer.java)
            pending_mask = float(cfg.get("mask_value", 0.0))
            mask_consumed = False  # a NEW mask must find its own consumer
            continue
        if cn == "Flatten" and cur_it.kind == "recurrent":
            # our Dense consumes [B,T,F] natively, so no auto-preprocessor
            # flattens timesteps — honor Keras's explicit Flatten with a
            # Reshape to [B, T*F]
            from deeplearning4j_tpu_torch.nn.preprocessors import Reshape

            t = cur_it.timesteps or 1
            conv = Reshape(shape=(int(t * cur_it.size),))
            our_layers.append(conv)
            # no names entry: the weight-pairing loop skips preprocessor-
            # module layers without consuming a name
            cur_it = conv.output_type(cur_it)
            continue
        conv = _convert_layer(cn, cfg, as_output=(i == last_idx and cn == "Dense"),
                              recurrent=recurrent_out)
        if conv is None:
            continue
        if cn in _RETURNS_SEQUENCES and not cfg.get("return_sequences", False):
            # our recurrent layers return full sequences; Keras
            # return_sequences=False keeps only the final step
            from deeplearning4j_tpu_torch.nn.layers import LastTimeStep

            conv = LastTimeStep(rnn=conv)
        if pending_mask is not None and (
                cn in _RETURNS_SEQUENCES or cn == "Bidirectional"):
            # MaskZero OUTERMOST: it derives the mask from its own input and
            # passes it down, so LastTimeStep picks the last VALID step.
            # Keras propagates the mask through EVERY downstream RNN, so the
            # wrap repeats for stacked RNNs — later layers re-derive it from
            # the zeros our masked steps emit (mask_value 0.0, not the
            # user's original value, which only applies to the raw input).
            from deeplearning4j_tpu_torch.nn.layers import MaskZero

            conv = MaskZero(rnn=conv, mask_value=pending_mask)
            pending_mask = 0.0
            mask_consumed = True
        elif (pending_mask is not None and rnn_later[i + 1]
                and cn not in _mask_transparent):
            # a value-transforming layer between Masking and a later RNN
            # breaks mask derivation (padded steps stop being mask_value /
            # zero) — refuse rather than silently diverge from Keras
            raise UnsupportedKerasConfigurationError(
                f"Masking followed by {cn!r} before an RNN: the derived "
                "mask cannot survive a value-transforming layer")
        our_layers.append(conv)
        if type(conv).__module__.endswith("preprocessors"):
            # preprocessor-module results (e.g. Keras Reshape) carry no
            # weights; the pairing loop skips them without consuming a name
            cur_it = conv.output_type(cur_it)
            continue
        names.append(cfg.get("name", lc.get("name")))
        try:
            cur_it = conv.output_type(cur_it)
        except Exception:
            pass  # shape tracking is best-effort; MLN resolution re-derives
    if pending_mask is not None and not mask_consumed:
        # Keras silently lets a mask die at a non-mask-consuming layer
        # (e.g. Masking->Dense); we import the layers but the masking is a
        # no-op — surface that instead of dropping it silently
        import warnings

        warnings.warn(
            "Keras Masking layer has no downstream RNN consumer — the mask "
            "is dropped (padded steps are treated as real values)",
            stacklevel=2)
    conf = MultiLayerConfiguration(layers=tuple(our_layers), input_type=input_type)
    return conf, names


class KerasModelImport:
    """Entry points (KerasModelImport.java:50-121)."""

    # -- Sequential --------------------------------------------------------
    @staticmethod
    def import_keras_sequential_configuration(model_json: str) -> MultiLayerConfiguration:
        """From a model-config JSON string (importKerasSequentialConfiguration)."""
        conf, _ = _sequential_from_config(json.loads(model_json))
        return conf

    @staticmethod
    def import_keras_sequential_model_and_weights(path: str, device=None) -> MultiLayerNetwork:
        with _read_h5(path) as f:
            model_config = _model_config_from_h5(f)
            if model_config.get("class_name") != "Sequential":
                raise InvalidKerasConfigurationError(
                    f"not a Sequential model: {model_config.get('class_name')}"
                )
            weights = _layer_weights_from_h5(f)
        return _sequential_model(model_config, weights, device)

    # -- functional Model --------------------------------------------------
    @staticmethod
    def import_keras_model_and_weights(path: str, device=None) -> ComputationGraph:
        with _read_h5(path) as f:
            model_config = _model_config_from_h5(f)
            if model_config.get("class_name") == "Sequential":
                raise InvalidKerasConfigurationError(
                    "Sequential model: use import_keras_sequential_model_and_weights"
                )
            weights = _layer_weights_from_h5(f)
        return _graph_model(model_config, weights, device)

    # -- auto-detect (ModelGuesser-ish surface) ---------------------------
    @staticmethod
    def import_keras_model(path: str, device=None):
        """Auto-detect Sequential vs functional (KerasModelImport's combined
        entry): returns MultiLayerNetwork or ComputationGraph on ``device``."""
        with _read_h5(path) as f:
            kind = _model_config_from_h5(f).get("class_name")
        if kind == "Sequential":
            return KerasModelImport.import_keras_sequential_model_and_weights(path, device)
        return KerasModelImport.import_keras_model_and_weights(path, device)


def model_from_config(model_config, weights: Dict[str, List[np.ndarray]], device=None):
    """The conversion without the HDF5 container: a Keras model-config (the
    JSON string or its dict, as ``model.to_json()`` writes it) and
    ``{layer name: [arrays in Keras weight order]}`` (what the HDF5 file's
    ``model_weights`` group holds) -> a MultiLayerNetwork (Sequential) or a
    ComputationGraph (functional) on ``device``. The HDF5 entry points of
    :class:`KerasModelImport` read the file and call the same builders."""
    if isinstance(model_config, (str, bytes)):
        model_config = json.loads(model_config)
    if model_config.get("class_name") == "Sequential":
        return _sequential_model(model_config, weights, device)
    return _graph_model(model_config, weights, device)


def _sequential_model(model_config: dict, weights, device) -> MultiLayerNetwork:
    conf, names = _sequential_from_config(model_config)
    model = MultiLayerNetwork(conf, device=device).init()
    new_params = list(model.params)
    new_state = list(model.state)
    # model.layers = conf.layers with auto-inserted preprocessors
    # interleaved; pair conf-layer names positionally, skipping inserted
    # preprocessor layers (they live in nn.preprocessors)
    j = 0
    for i, layer in enumerate(model.layers):
        if type(layer).__module__.endswith("preprocessors"):
            continue
        name = names[j]
        j += 1
        # Wrapper layers (LastTimeStep, MaskZero, ...) delegate init to
        # the wrapped rnn, so their params dict IS the innermost layer's
        # — walk the chain and map weights against the inner conf
        target = layer
        while type(target).__name__ in (
                "LastTimeStep", "BidirectionalLastTimeStep", "MaskZero"):
            target = target.rnn
        if name in weights:
            new_params[i], new_state[i] = _set_weights(
                target, weights[name], new_params[i], new_state[i], model.device
            )
    model.params = tuple(new_params)
    model.state = tuple(new_state)
    return model


def _graph_model(model_config: dict, weights, device) -> ComputationGraph:
    conf, names = _graph_from_config(model_config)
    model = ComputationGraph(conf, device=device).init()
    _apply_graph_weights(model, names, weights)
    return model


# ---------------------------------------------------------------------------
# functional-API graphs
# ---------------------------------------------------------------------------

_MERGE_LAYERS = {
    "Add": ElementWiseVertex(op="add"),
    "Subtract": ElementWiseVertex(op="subtract"),
    "Multiply": ElementWiseVertex(op="product"),
    "Average": ElementWiseVertex(op="average"),
    "Maximum": ElementWiseVertex(op="max"),
    "Concatenate": MergeVertex(),
}


def _collect_history(obj, out: List[str]) -> None:
    """Recursively pull keras_history source names out of keras-3 node args."""
    if isinstance(obj, dict):
        hist = obj.get("keras_history")
        if hist:
            out.append(str(hist[0]))
            return
        for v in obj.values():
            _collect_history(v, out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _collect_history(v, out)


def _inbound_names(lc: dict) -> List[str]:
    """Inbound layer names from either format: Keras 2's nested lists
    ([[['name', 0, 0, {}], ...]]) or Keras 3's node dicts
    ([{'args': [<keras_tensor with keras_history>], ...}])."""
    nodes = lc.get("inbound_nodes", [])
    if not nodes:
        return []
    first = nodes[0]
    out: List[str] = []
    if isinstance(first, dict):  # keras 3
        _collect_history(first.get("args", []), out)
        return out
    for entry in first:
        if isinstance(entry, (list, tuple)):
            out.append(str(entry[0]))
    return out


def _graph_from_config(model_config: dict):
    cfg = model_config["config"]
    layers_cfg = cfg["layers"]
    builder = ComputationGraphConfiguration.builder()

    def _endpoint_names(spec) -> List[str]:
        # keras 2: [['name', 0, 0], ...]; keras 3 single endpoint: ['name', 0, 0]
        if not spec:
            return []
        if isinstance(spec[0], str):
            return [str(spec[0])]
        return [str(n[0]) for n in spec]

    input_names = _endpoint_names(cfg.get("input_layers", []))
    output_names = _endpoint_names(cfg.get("output_layers", []))
    if not input_names:
        raise InvalidKerasConfigurationError("functional model without input_layers")

    input_types = []
    by_name = {lc["config"].get("name", lc.get("name")): lc for lc in layers_cfg}
    for iname in input_names:
        lc = by_name[iname]
        shape = lc["config"].get("batch_input_shape") or lc["config"].get("batch_shape")
        # first consumer decides ambiguous ranks
        consumer = next(
            (l["class_name"] for l in layers_cfg if iname in _inbound_names(l)),
            "Dense",
        )
        input_types.append(_keras_input_type(shape, consumer))
    builder.add_inputs(*input_names)
    builder.set_input_types(*input_types)

    names: List[Tuple[str, Any]] = []  # (keras name, our layer conf) for weights
    for lc in layers_cfg:
        cn = lc["class_name"]
        name = lc["config"].get("name", lc.get("name"))
        if cn == "InputLayer":
            continue
        inbound = _inbound_names(lc)
        if cn in _MERGE_LAYERS:
            builder.add_vertex(name, _MERGE_LAYERS[cn], *inbound)
            continue
        if cn == "Flatten":
            # preprocessor insertion handles conv->ff; pass through vertex-free
            # by aliasing: downstream layers reference this name, so emit an
            # identity activation layer
            builder.add_layer(name, ActivationLayer(activation="identity"), *inbound)
            continue
        conv = _convert_layer(cn, lc.get("config", {}),
                              as_output=(name in output_names and cn == "Dense"))
        if cn in _RETURNS_SEQUENCES and not lc["config"].get("return_sequences", False):
            from deeplearning4j_tpu_torch.nn.layers import LastTimeStep

            conv = LastTimeStep(rnn=conv)
        builder.add_layer(name, conv, *inbound)
        names.append((name, conv))
    builder.set_outputs(*output_names)
    return builder.build(), names


def _apply_graph_weights(model: ComputationGraph, names, weights) -> None:
    for kname, conv in names:
        if kname not in weights:
            continue
        p = model.params.get(kname) if isinstance(model.params, dict) else None
        st = model.state.get(kname) if isinstance(model.state, dict) else None
        if p is None:
            continue
        target = conv.rnn if type(conv).__name__ == "LastTimeStep" else conv
        new_p, new_s = _set_weights(target, weights[kname], p, st, model.device)
        model.params[kname] = new_p
        if isinstance(model.state, dict) and new_s is not None:
            model.state[kname] = new_s
