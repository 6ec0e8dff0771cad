"""DL4J model-zip interop: import/export of the reference's saved-model format
(PyTorch port of ``deeplearning4j_tpu/modelimport/dl4j.py``).

The byte formats, the JSON dialect, the layout conversions and the updater
blocks are the JAX package's, line for line; the mapped arrays become
tensors on the model's device (the GPU unless ``device=`` names another;
with no GPU and no ``device`` the import raises). Optimizer state is built
only when the zip holds ``updaterState.bin``; otherwise the model builds it
at its first update, as every port model does (zeros, as the JAX package's
``init`` builds them), and an export of such a model writes the zeros.

Reference format (util/ModelSerializer.java:110-150): a zip with
  configuration.json   MultiLayerConfiguration.toJson() (jackson, layer
                       subtypes as WRAPPER_OBJECT names — conf/layers/Layer.java:53-85)
  coefficients.bin     Nd4j.write(model.params(), dos): shapeInfo int buffer
                       then the data buffer, both in the ND4J DataBuffer
                       stream format (allocation-mode UTF8 string, int32
                       length, dtype UTF8 string, big-endian payload)
  updaterState.bin     optional, same binary layout.

Param-vector layout per layer (the flat view intervals in nn/params/*.java):
  dense/output/embedding  [ W: F-order (nIn,nOut) | b ]        (DefaultParamInitializer.java:116-139)
  convolution             [ b | W: C-order (nOut,nIn,kh,kw) ]  (ConvolutionParamInitializer.java:118-153)
  batchNormalization      [ gamma | beta | mean | var ]        (BatchNormalizationParamInitializer.java:79-114)
  gravesLSTM / LSTM       [ Wx: F (nIn,4H) | RW: F (H,4H[+3]) | b(4H) ]
                          DL4J gate blocks are [g,f,o,i] — block 0 is the
                          tanh candidate ("inputActivations"), block 3 the
                          sigmoid input gate ("inputModGate") — with peephole
                          columns [wFF,wOO,wGG] = [f(prev c), o(cur c),
                          i(prev c)] (LSTMHelpers.java:71,205-320,
                          GravesLSTMParamInitializer.java:117-160)
  simpleRnn               [ W: F (nIn,nOut) | RW: F (nOut,nOut) | b ]

Layout conversions to this framework's conventions (the JAX package's):
  conv W    (nOut,nIn,kh,kw) C-order  ->  (kh,kw,nIn,nOut) NHWC kernels
  dense-after-conv W rows: DL4J flattens NCHW (c,h,w); we flatten NHWC
            (h,w,c) — rows are permuted accordingly
  LSTM      DL4J blocks [g,f,o,i] -> ours [i,f,g,o]; peepholes
            [wGG,wFF,wOO] -> [p_i,p_f,p_o]
  BN        mean/var move to the (non-trainable) state pytree.

The fixtures committed under tests/fixtures/ were produced by the JAX
package's ``export_dl4j_zip``; tests/test_torch_dl4j_import.py holds this
module to it on them and on zips written by either package.
"""

from __future__ import annotations

import io
import json
import struct
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

import torch

from deeplearning4j_tpu_torch.nn.input_type import InputType

# ---------------------------------------------------------------------------
# ND4J binary array serde
# ---------------------------------------------------------------------------

_DTYPES = {"FLOAT": ("f", 4, np.float32), "DOUBLE": ("d", 8, np.float64),
           "INT": ("i", 4, np.int32), "LONG": ("q", 8, np.int64)}


def _read_utf(s: io.BufferedIOBase) -> str:
    """Java DataOutputStream.writeUTF: u16 byte-length + modified-UTF8."""
    (n,) = struct.unpack(">H", s.read(2))
    return s.read(n).decode("utf-8")


def _write_utf(s: io.BufferedIOBase, text: str):
    b = text.encode("utf-8")
    s.write(struct.pack(">H", len(b)))
    s.write(b)


def read_databuffer(s: io.BufferedIOBase) -> np.ndarray:
    """One ND4J DataBuffer: allocation-mode UTF, int32 length, dtype UTF,
    then big-endian elements (BaseDataBuffer.write)."""
    _alloc = _read_utf(s)
    (length,) = struct.unpack(">i", s.read(4))
    dtype = _read_utf(s)
    if dtype not in _DTYPES:
        raise ValueError(f"Unsupported ND4J dtype {dtype!r}")
    _, size, np_dt = _DTYPES[dtype]
    raw = s.read(length * size)
    if len(raw) != length * size:
        raise ValueError("Truncated ND4J data buffer")
    return np.frombuffer(raw, dtype=np.dtype(np_dt).newbyteorder(">"),
                         count=length).astype(np_dt)


def write_databuffer(s: io.BufferedIOBase, arr: np.ndarray, dtype: str):
    _, size, np_dt = _DTYPES[dtype]
    flat = np.ascontiguousarray(arr, dtype=np_dt).ravel()
    _write_utf(s, "DIRECT")
    s.write(struct.pack(">i", flat.size))
    _write_utf(s, dtype)
    s.write(flat.astype(np.dtype(np_dt).newbyteorder(">")).tobytes())


def read_nd4j(s: io.BufferedIOBase) -> np.ndarray:
    """Nd4j.read: shapeInfo int buffer [rank, shape.., stride.., offset,
    elementWiseStride, order-char] followed by the data buffer.

    Obligations per docs/DL4J_DIALECT.md: the STRIDES are the layout ground
    truth (the order char is only the fallback for ambiguous shapes),
    nonzero offsets are rejected loudly, and the shapeInfo length must be
    2*rank + 4."""
    shape_info = read_databuffer(s)
    rank = int(shape_info[0])
    if len(shape_info) != 2 * rank + 4:
        raise ValueError(
            f"shapeInfo length {len(shape_info)} != 2*rank+4 (rank {rank})")
    shape = tuple(int(d) for d in shape_info[1:1 + rank])
    strides = tuple(int(d) for d in shape_info[1 + rank:1 + 2 * rank])
    offset = int(shape_info[1 + 2 * rank])
    if offset != 0:
        raise ValueError(f"nonzero ND4J array offset {offset} unsupported")
    order = chr(int(shape_info[2 * rank + 3]))

    def contiguous(o):
        acc, out = 1, [0] * rank
        for i in (range(rank - 1, -1, -1) if o == "c" else range(rank)):
            out[i] = acc
            acc *= shape[i]
        return tuple(out)

    if strides == contiguous("c"):
        order = "c"          # strides win over a disagreeing order char
    elif strides == contiguous("f"):
        order = "f"
    else:
        raise ValueError(
            f"non-contiguous ND4J strides {strides} for shape {shape}")
    data = read_nd4j_databuffer_data(s)
    if data.size != int(np.prod(shape)):
        raise ValueError(f"data length {data.size} != prod{shape}")
    return np.reshape(data, shape, order=order)


def read_nd4j_databuffer_data(s) -> np.ndarray:
    return read_databuffer(s)


def write_nd4j(s: io.BufferedIOBase, arr: np.ndarray, dtype: str = "FLOAT"):
    arr = np.asarray(arr)
    if arr.ndim == 1:
        arr = arr[None, :]  # DL4J params() is a [1,N] row vector
    rank = arr.ndim
    c = np.ascontiguousarray(arr)
    strides = []
    acc = 1
    for d in reversed(c.shape):
        strides.insert(0, acc)
        acc *= d
    info = [rank, *c.shape, *strides, 0, 1, ord("c")]
    write_databuffer(s, np.asarray(info, np.int32), "INT")
    write_databuffer(s, c, dtype)


# ---------------------------------------------------------------------------
# JSON <-> layer-config conversion
# ---------------------------------------------------------------------------

_ACT_MAP = {
    # DL4J activation name (lowercased, 'activation' stripped) -> the name
    # REGISTERED in nn/activations.py
    "relu": "relu", "sigmoid": "sigmoid", "tanh": "tanh", "softmax": "softmax",
    "identity": "identity", "lrelu": "leakyrelu", "leakyrelu": "leakyrelu",
    "elu": "elu", "softplus": "softplus", "softsign": "softsign",
    "hardtanh": "hardtanh", "hardsigmoid": "hardsigmoid", "cube": "cube",
    "rationaltanh": "rationaltanh", "rectifiedtanh": "rectifiedtanh",
    "selu": "selu", "swish": "swish", "gelu": "gelu", "mish": "mish",
    "relu6": "relu6", "thresholdedrelu": "thresholdedrelu",
    "logsoftmax": "logsoftmax",
}

_LOSS_MAP = {
    "mcxent": "mcxent", "negativeloglikelihood": "mcxent", "mse": "mse",
    "xent": "xent", "l1": "l1", "l2": "l2", "squaredloss": "mse",
    "cosineproximity": "cosine_proximity", "hinge": "hinge",
    "squaredhinge": "squared_hinge", "kldivergence": "kld", "poisson": "poisson",
    "meanabsoluteerror": "mae", "meansquaredlogarithmicerror": "msle",
    "meanabsolutepercentageerror": "mape",
}

_WEIGHT_INIT_MAP = {
    # DL4J WeightInit enum (lowercased) -> the name registered in
    # nn/initializers.py
    "xavier": "xavier", "xavier_uniform": "xavier_uniform", "xavieruniform": "xavier_uniform",
    "xavierlegacy": "xavier", "xavierfanin": "xavier_fan_in", "relu": "relu",
    "reluuniform": "relu_uniform", "uniform": "uniform", "zero": "zero",
    "ones": "ones", "normal": "normal", "lecunnormal": "lecun_normal",
    "lecununiform": "lecun_uniform", "distribution": "normal",
    "identity": "identity",
    "varscalingnormalfanin": "varscaling_normal_fan_in",
    "varscalingnormalfanout": "varscaling_normal_fan_out",
    "varscalingnormalfanavg": "varscaling_normal_fan_avg",
    "sigmoiduniform": "sigmoid_uniform",
}


def _parse_activation(d: Dict[str, Any]) -> str:
    """Accept 'activationFn': {'ReLU': {}} (typed), a plain string, or the
    pre-0.7 'activationFunction': 'relu'."""
    fn = d.get("activationFn")
    if fn is None:
        fn = d.get("activationFunction")
    if fn is None:
        return "identity"
    if isinstance(fn, str):
        key = fn.lower().replace("activation", "")
    elif isinstance(fn, dict):
        if "@class" in fn:
            key = fn["@class"].rsplit(".", 1)[-1].lower().replace("activation", "")
        else:
            key = next(iter(fn)).lower().replace("activation", "")
    else:
        raise ValueError(f"Unparseable activation {fn!r}")
    if key not in _ACT_MAP:
        raise ValueError(f"Unsupported DL4J activation {fn!r}")
    return _ACT_MAP[key]


def _parse_loss(d: Dict[str, Any]) -> str:
    fn = d.get("lossFn")
    if fn is None:
        fn = d.get("lossFunction")
    if fn is None:
        return "mcxent"
    if isinstance(fn, str):
        key = fn.lower()
    elif isinstance(fn, dict):
        if "@class" in fn:
            key = fn["@class"].rsplit(".", 1)[-1].lower()
        else:
            key = next(iter(fn)).lower()
    else:
        raise ValueError(f"Unparseable loss {fn!r}")
    key = key.replace("loss", "", 1) if key.startswith("loss") else key
    if key not in _LOSS_MAP:
        raise ValueError(f"Unsupported DL4J loss {fn!r}")
    return _LOSS_MAP[key]


def _parse_weight_init(d: Dict[str, Any]) -> str:
    wi = d.get("weightInit")
    if wi is None:
        return "xavier"
    key = str(wi).lower()
    return _WEIGHT_INIT_MAP.get(key, "xavier")


def _parse_updater(d: Dict[str, Any]) -> Optional[dict]:
    """Layer 'iUpdater' typed object ({'Adam': {...}}) or legacy
    'updater': 'ADAM' + 'learningRate' fields."""
    iu = d.get("iUpdater") or d.get("iupdater")
    if isinstance(iu, dict):
        if "@class" in iu:
            name = iu["@class"].rsplit(".", 1)[-1].lower()
            body = {k: v for k, v in iu.items() if k != "@class"}
        else:
            name = next(iter(iu)).lower()
            body = iu[name] if name in iu else next(iter(iu.values()))
        name = name.replace("updater", "")
        spec = {"type": {"nesterovs": "nesterovs", "sgd": "sgd", "adam": "adam",
                         "adamax": "adamax", "nadam": "nadam", "amsgrad": "amsgrad",
                         "adagrad": "adagrad", "adadelta": "adadelta",
                         "rmsprop": "rmsprop", "noop": "noop"}.get(name, "sgd")}
        lr = body.get("learningRate")
        if lr is not None:
            spec["lr"] = float(lr)
        for src, dst in (("beta1", "beta1"), ("beta2", "beta2"), ("epsilon", "eps"),
                         ("momentum", "momentum"), ("rmsDecay", "decay"), ("rho", "rho")):
            if src in body:
                spec[dst] = float(body[src])
        return spec
    upd = d.get("updater")
    if isinstance(upd, str):
        spec = {"type": upd.lower()}
        if "learningRate" in d:
            spec["lr"] = float(d["learningRate"])
        return spec
    return None


def _common_kwargs(d: Dict[str, Any]) -> dict:
    kw = {}
    if d.get("layerName"):
        kw["name"] = d["layerName"]
    drop = d.get("dropOut", 0.0) or 0.0
    if 0.0 < drop < 1.0:
        # DL4J dropOut is the RETAIN probability; ours is the drop rate
        kw["dropout"] = 1.0 - float(drop)
    for field, ours in (("l1", "l1"), ("l2", "l2")):
        v = d.get(field, 0.0) or 0.0
        if v:
            kw[ours] = float(v)
    return kw


def _conv_mode(d: Dict[str, Any]) -> str:
    return str(d.get("convolutionMode") or "Truncate").lower()


def dl4j_layer_to_config(type_name: str, d: Dict[str, Any]):
    """One DL4J layer JSON object -> (our LayerConfig, dl4j_dict)."""
    from deeplearning4j_tpu_torch.nn import layers as L

    act = _parse_activation(d)
    wi = _parse_weight_init(d)
    kw = _common_kwargs(d)
    # per-layer iUpdater override is first-class in DL4J; carry it onto the
    # layer config so model._build_updaters honors it (and updater-state
    # accumulators land in matching opt_state structures)
    lupd = _parse_updater(d)
    if lupd is not None:
        kw["updater"] = lupd
    n_in = int(d.get("nin") or d.get("nIn") or 0) or None
    n_out = int(d.get("nout") or d.get("nOut") or 0) or None
    t = type_name

    if t == "dense":
        return L.Dense(n_in=n_in, n_out=n_out, activation=act, weight_init=wi,
                       has_bias=bool(d.get("hasBias", True)), **kw)
    if t == "output":
        return L.OutputLayer(n_in=n_in, n_out=n_out, activation=act,
                             loss=_parse_loss(d), weight_init=wi,
                             has_bias=bool(d.get("hasBias", True)), **kw)
    if t == "rnnoutput":
        return L.RnnOutputLayer(n_in=n_in, n_out=n_out, activation=act,
                                loss=_parse_loss(d), weight_init=wi,
                                has_bias=bool(d.get("hasBias", True)), **kw)
    if t == "loss":
        return L.LossLayer(activation=act, loss=_parse_loss(d))
    if t == "convolution":
        return L.Conv2D(n_in=n_in, n_out=n_out, activation=act, weight_init=wi,
                        kernel=tuple(d["kernelSize"]), stride=tuple(d.get("stride", (1, 1))),
                        padding=tuple(d.get("padding", (0, 0))),
                        convolution_mode=_conv_mode(d),
                        has_bias=bool(d.get("hasBias", True)), **kw)
    if t == "subsampling":
        pool = str(d.get("poolingType", "MAX")).lower()
        return L.Subsampling2D(kernel=tuple(d["kernelSize"]),
                               stride=tuple(d.get("stride", (2, 2))),
                               padding=tuple(d.get("padding", (0, 0))),
                               convolution_mode=_conv_mode(d), pooling=pool)
    if t == "batchNormalization":
        return L.BatchNorm(decay=float(d.get("decay", 0.9)),
                           eps=float(d.get("eps", 1e-5)),
                           use_gamma_beta=not bool(d.get("lockGammaBeta", False)),
                           updater=kw.get("updater"))
    if t == "localResponseNormalization":
        return L.LocalResponseNormalization(
            k=float(d.get("k", 2.0)), n=int(d.get("n", 5)),
            alpha=float(d.get("alpha", 1e-4)), beta=float(d.get("beta", 0.75)))
    if t in ("gravesLSTM", "LSTM"):
        cls = L.GravesLSTM if t == "gravesLSTM" else L.LSTM
        return cls(n_in=n_in, n_out=n_out, activation=act, weight_init=wi,
                   gate_activation=_ACT_MAP.get(
                       str(d.get("gateActivationFn", "sigmoid")).lower(), "sigmoid")
                   if isinstance(d.get("gateActivationFn"), str) else "sigmoid",
                   forget_gate_bias_init=float(d.get("forgetGateBiasInit", 1.0)), **kw)
    if t == "SimpleRnn":
        return L.SimpleRnn(n_in=n_in, n_out=n_out, activation=act, weight_init=wi, **kw)
    if t == "embedding":
        return L.Embedding(n_in=n_in, n_out=n_out, weight_init=wi,
                           has_bias=bool(d.get("hasBias", True)),
                           updater=kw.get("updater"))
    if t == "activation":
        return L.ActivationLayer(activation=act)
    if t == "dropout":
        return L.DropoutLayer(dropout=kw.get("dropout", 0.5))
    if t == "GlobalPooling":
        return L.GlobalPooling(pooling=str(d.get("poolingType", "MAX")).lower())
    raise ValueError(f"DL4J layer type {type_name!r} not supported by the importer")


# ---------------------------------------------------------------------------
# Parameter mapping
# ---------------------------------------------------------------------------

def _take(flat: np.ndarray, pos: int, n: int) -> Tuple[np.ndarray, int]:
    if pos + n > flat.size:
        # shared by coefficients.bin AND updaterState.bin consumption
        raise ValueError(
            f"binary parameter stream exhausted: need {pos + n}, have {flat.size}")
    return flat[pos:pos + n], pos + n


def _lstm_block_perm(H: int) -> List[Tuple[int, int]]:
    """(our_block, dl4j_block) pairs: ours [i,f,g,o] <- DL4J [g,f,o,i]."""
    return [(0, 3), (1, 1), (2, 0), (3, 2)]


def _map_layer_params(cfg, d: Dict[str, Any], flat: np.ndarray, pos: int,
                      in_type: InputType) -> Tuple[dict, dict, int]:
    """Consume one layer's segment. Returns (params, state, new_pos) in OUR
    conventions."""
    from deeplearning4j_tpu_torch.nn import layers as L

    name = type(cfg).__name__
    if isinstance(cfg, (L.Conv2D,)) and not isinstance(cfg, (L.Deconv2D,)):
        n_out = cfg.n_out
        n_in = cfg.n_in if cfg.n_in else in_type.channels
        kh, kw = cfg.kernel
        params = {}
        if cfg.has_bias:
            b, pos = _take(flat, pos, n_out)
            params["b"] = b.astype(np.float32)
        w, pos = _take(flat, pos, n_out * n_in * kh * kw)
        w = w.reshape(n_out, n_in, kh, kw)            # C order
        params["W"] = np.transpose(w, (2, 3, 1, 0)).astype(np.float32)  # -> (kh,kw,in,out)
        return params, {}, pos

    if isinstance(cfg, (L.GravesLSTM, L.LSTM)):
        H = cfg.n_out
        n_in = cfg.n_in if cfg.n_in else in_type.size
        graves = isinstance(cfg, L.GravesLSTM)
        wx, pos = _take(flat, pos, n_in * 4 * H)
        wx = wx.reshape(n_in, 4 * H, order="F")
        rw_cols = 4 * H + (3 if graves else 0)
        rw, pos = _take(flat, pos, H * rw_cols)
        rw = rw.reshape(H, rw_cols, order="F")
        b, pos = _take(flat, pos, 4 * H)
        Wx = np.empty_like(wx)
        Wh = np.empty((H, 4 * H), wx.dtype)
        bb = np.empty_like(b)
        for ours, theirs in _lstm_block_perm(H):
            Wx[:, ours * H:(ours + 1) * H] = wx[:, theirs * H:(theirs + 1) * H]
            Wh[:, ours * H:(ours + 1) * H] = rw[:, theirs * H:(theirs + 1) * H]
            bb[ours * H:(ours + 1) * H] = b[theirs * H:(theirs + 1) * H]
        params = {"Wx": Wx.astype(np.float32), "Wh": Wh.astype(np.float32),
                  "b": bb.astype(np.float32)}
        if graves:
            # DL4J peephole cols [wFF, wOO, wGG] -> ours [p_i, p_f, p_o]
            wff, woo, wgg = rw[:, 4 * H], rw[:, 4 * H + 1], rw[:, 4 * H + 2]
            params["peephole"] = np.concatenate([wgg, wff, woo]).astype(np.float32)
        return params, {}, pos

    if isinstance(cfg, L.SimpleRnn):
        H = cfg.n_out
        n_in = cfg.n_in if cfg.n_in else in_type.size
        w, pos = _take(flat, pos, n_in * H)
        rw, pos = _take(flat, pos, H * H)
        b, pos = _take(flat, pos, H)
        return ({"Wx": w.reshape(n_in, H, order="F").astype(np.float32),
                 "Wh": rw.reshape(H, H, order="F").astype(np.float32),
                 "b": b.astype(np.float32)}, {}, pos)

    if isinstance(cfg, L.BatchNorm):
        n = in_type.channels if in_type.kind == "conv" else in_type.flat_size()
        params = {}
        if cfg.use_gamma_beta:
            g, pos = _take(flat, pos, n)
            bta, pos = _take(flat, pos, n)
            params = {"gamma": g.astype(np.float32), "beta": bta.astype(np.float32)}
        mean, pos = _take(flat, pos, n)
        var, pos = _take(flat, pos, n)
        return params, {"mean": mean.astype(np.float32), "var": var.astype(np.float32)}, pos

    if name in ("Dense", "OutputLayer", "RnnOutputLayer", "Embedding"):
        n_out = cfg.n_out
        n_in = cfg.n_in if cfg.n_in else in_type.flat_size()
        w, pos = _take(flat, pos, n_in * n_out)
        W = w.reshape(n_in, n_out, order="F").astype(np.float32)
        if in_type.kind == "conv":
            # DL4J flattened (c,h,w); our preprocessor flattens (h,w,c)
            H_, W_, C_ = in_type.height, in_type.width, in_type.channels
            perm = np.arange(n_in).reshape(C_, H_, W_).transpose(1, 2, 0).ravel()
            W = W[perm]
        params = {"W": W}
        if getattr(cfg, "has_bias", True):
            b, pos = _take(flat, pos, n_out)
            params["b"] = b.astype(np.float32)
        return params, {}, pos

    # param-free layers (subsampling, activation, dropout, lrn, pooling, loss)
    return {}, {}, pos


# ---------------------------------------------------------------------------
# Updater state (updaterState.bin)
# ---------------------------------------------------------------------------
# The reference flattens optimizer state per UPDATER BLOCK: contiguous
# (layer, variable) pairs with equal updater configs merge into one block
# (BaseMultiLayerUpdater.java:56-127, UpdaterUtils.updaterConfigurationsEquals),
# and each block's view is [acc1(all vars) | acc2(all vars) | ...] — the
# ND4J GradientUpdater.setStateViewArray split (AdamUpdater: m then v;
# AdaDeltaUpdater: msg then msdx; AMSGradUpdater: m, v, vHat). Layers walk in
# the same order as the param flattening (MultiLayerUpdater: network layers;
# ComputationGraphUpdater.getOrderedLayers: topological order); variables walk
# in paramTable order = the per-layer flat layout above. BatchNorm mean/var
# use NoOp (BatchNormalization.java:144-155) — zero state, but they BREAK
# block contiguity.

# our opt_state dict keys, in the order ND4J splits the block state view
_STATE_KEYS = {
    "sgd": [], "noop": [],
    "nesterovs": ["v"],          # NesterovsUpdater: v (momentum)
    "adagrad": ["h"],            # AdaGradUpdater: historicalGradient
    "rmsprop": ["c"],            # RmsPropUpdater: lastGradient
    "adadelta": ["eg", "edx"],   # AdaDeltaUpdater: msg, msdx
    "adam": ["m", "v"], "nadam": ["m", "v"],
    "adamax": ["m", "v"],        # AdaMaxUpdater: m, u
    "amsgrad": ["m", "v", "vmax"],  # AMSGradUpdater: m, v, vHat
}


def _dl4j_var_sizes(cfg, in_type: InputType) -> List[Tuple[str, int]]:
    """Per-variable (kind, size) in DL4J paramTable order — MUST mirror the
    consumption order of ``_map_layer_params``. kind: 'train' uses the
    layer's updater; 'stats' is BN mean/var (NoOp)."""
    from deeplearning4j_tpu_torch.nn import layers as L

    name = type(cfg).__name__
    if isinstance(cfg, L.Conv2D) and not isinstance(cfg, L.Deconv2D):
        n_in = cfg.n_in if cfg.n_in else in_type.channels
        kh, kw = cfg.kernel
        out = [("train", cfg.n_out)] if cfg.has_bias else []
        return out + [("train", cfg.n_out * n_in * kh * kw)]
    if isinstance(cfg, (L.GravesLSTM, L.LSTM)):
        H = cfg.n_out
        n_in = cfg.n_in if cfg.n_in else in_type.size
        rw = H * (4 * H + (3 if isinstance(cfg, L.GravesLSTM) else 0))
        return [("train", n_in * 4 * H), ("train", rw), ("train", 4 * H)]
    if isinstance(cfg, L.SimpleRnn):
        H = cfg.n_out
        n_in = cfg.n_in if cfg.n_in else in_type.size
        return [("train", n_in * H), ("train", H * H), ("train", H)]
    if isinstance(cfg, L.BatchNorm):
        n = in_type.channels if in_type.kind == "conv" else in_type.flat_size()
        out = [("train", n), ("train", n)] if cfg.use_gamma_beta else []
        return out + [("stats", n), ("stats", n)]
    if name in ("Dense", "OutputLayer", "RnnOutputLayer", "Embedding"):
        n_out = cfg.n_out
        n_in = cfg.n_in if cfg.n_in else in_type.flat_size()
        out = [("train", n_in * n_out)]
        if getattr(cfg, "has_bias", True):
            out.append(("train", n_out))
        return out
    return []


def _spec_state_keys(spec: Optional[dict]) -> List[str]:
    t = (spec or {}).get("type", "sgd")
    if t not in _STATE_KEYS:
        raise ValueError(f"unknown updater type {t!r} in updater-state mapping")
    return _STATE_KEYS[t]


def _canon_spec(spec: Optional[dict]) -> dict:
    """Normalize an updater spec (fill defaults, drop non-identity fields) so
    block-equality compares like DL4J's IUpdater.equals — a layer whose JSON
    omits a default field must still merge with its neighbors."""
    from deeplearning4j_tpu_torch.train.updaters import normalize_updater

    out = dict(normalize_updater(spec if spec else {"type": "sgd"}))
    out.pop("schedule", None)
    return out


def _updater_var_blocks(layer_entries, spec_for_entry):
    """Shared import/export block segmentation. ``layer_entries``: ordered
    [(cfg, in_type)]-like; ``spec_for_entry(li)`` -> that layer's canonical
    trainable-var updater spec. Returns (var_recs, blocks) where var_recs =
    [(li, vi, size, spec_json, spec)] and blocks groups contiguous equal
    spec_json runs, mirroring BaseMultiLayerUpdater.java:56-127."""
    var_recs = []
    noop_json = json.dumps(_canon_spec({"type": "noop"}), sort_keys=True)
    for li, (cfg, in_type) in enumerate(layer_entries):
        spec = spec_for_entry(li)
        spec_json = json.dumps(spec, sort_keys=True)
        for vi, (kind, size) in enumerate(_dl4j_var_sizes(cfg, in_type)):
            if kind == "stats":
                var_recs.append((li, vi, size, noop_json, {"type": "noop"}))
            else:
                var_recs.append((li, vi, size, spec_json, spec))
    blocks: List[Tuple[dict, list]] = []
    for rec in var_recs:
        if blocks and blocks[-1][1][-1][3] == rec[3]:
            blocks[-1][1].append(rec)
        else:
            blocks.append((rec[4], [rec]))
    return var_recs, blocks


def _consume_updater_state(layer_entries, flat: np.ndarray, global_spec: dict):
    """layer_entries: ordered [(cfg, layer_json_dict, in_type)]. Returns
    {layer_pos: {acc_key: params-shaped-dict}} with every accumulator mapped
    through the same layout conversions as the weights (an Adam ``m`` for a
    conv W permutes (out,in,kh,kw)->(kh,kw,in,out) exactly like W itself)."""
    gspec = _canon_spec(global_spec)

    def spec_for(li):
        lspec = _parse_updater(layer_entries[li][1])
        return _canon_spec(lspec) if lspec else gspec

    _, blocks = _updater_var_blocks(
        [(cfg, it) for cfg, _d, it in layer_entries], spec_for)

    pos = 0
    segs: Dict[Tuple[int, int, str], np.ndarray] = {}
    for spec, recs in blocks:
        for key in _spec_state_keys(spec):
            for li, vi, size, _, _ in recs:
                seg, pos = _take(flat, pos, size)
                segs[(li, vi, key)] = seg
    if pos != flat.size:
        raise ValueError(
            f"updaterState.bin has {flat.size} values but the configuration's "
            f"updater blocks consume {pos} — block layout mismatch")

    out: Dict[int, Dict[str, dict]] = {}
    for li, (cfg, d, in_type) in enumerate(layer_entries):
        sizes = _dl4j_var_sizes(cfg, in_type)
        keys = {k for (l2, _, k) in segs if l2 == li}
        for key in sorted(keys):
            pieces = [segs.get((li, vi, key), np.zeros(size, np.float32))
                      for vi, (_, size) in enumerate(sizes)]
            fake = np.concatenate(pieces) if pieces else np.zeros(0, np.float32)
            p, _st, _ = _map_layer_params(cfg, d, fake, 0, in_type)
            out.setdefault(li, {})[key] = p
    return out


def _tensor(a: np.ndarray, device, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)


def _host(t) -> np.ndarray:
    """A leaf (a tensor on any device, or an array) as a float32 numpy array."""
    if isinstance(t, torch.Tensor):
        return t.detach().to(device="cpu", dtype=torch.float32).numpy()
    return np.asarray(t, np.float32)


def _merge_opt_state(existing, accs: Dict[str, dict], device):
    """Overlay imported accumulators onto a layer's initialized opt_state,
    keeping dtype (mixed-precision keeps f32 accumulators)."""
    if not isinstance(existing, dict):
        return existing
    new = dict(existing)
    for key, tree in accs.items():
        if key not in new:
            continue
        cur = new[key]
        new[key] = {k: _tensor(v, device, cur[k].dtype
                               if isinstance(cur, dict) and k in cur
                               else torch.float32)
                    for k, v in tree.items()}
    return new


def _updater_to_dl4j_json(spec: dict) -> dict:
    """Our updater spec -> DL4J iUpdater WRAPPER_OBJECT JSON (inverse of
    ``_parse_updater``)."""
    names = {"sgd": "Sgd", "nesterovs": "Nesterovs", "adam": "Adam",
             "adamax": "AdaMax", "nadam": "Nadam", "amsgrad": "AMSGrad",
             "adagrad": "AdaGrad", "adadelta": "AdaDelta",
             "rmsprop": "RmsProp", "noop": "NoOp"}
    body: Dict[str, Any] = {}
    if "lr" in spec:
        body["learningRate"] = spec["lr"]
    for ours, theirs in (("beta1", "beta1"), ("beta2", "beta2"),
                         ("eps", "epsilon"), ("momentum", "momentum"),
                         ("decay", "rmsDecay"), ("rho", "rho")):
        if ours in spec:
            body[theirs] = spec[ours]
    return {names.get(spec.get("type", "sgd"), "Sgd"): body}


# ---------------------------------------------------------------------------
# Import
# ---------------------------------------------------------------------------

def _infer_input_type(layer_dicts, preprocs: Dict[str, Any],
                      input_type: Optional[InputType]) -> InputType:
    if input_type is not None:
        return input_type
    pp0 = (preprocs or {}).get("0")
    if isinstance(pp0, dict):
        body = next(iter(pp0.values())) if "@class" not in pp0 else pp0
        h = body.get("inputHeight") or body.get("numRows")
        w = body.get("inputWidth") or body.get("numColumns")
        c = body.get("numChannels")
        if h and w and c:
            return InputType.convolutional_flat(int(h), int(w), int(c))
    t0, d0 = layer_dicts[0]
    n_in = int(d0.get("nin") or d0.get("nIn") or 0)
    if t0 in ("gravesLSTM", "LSTM", "SimpleRnn", "rnnoutput"):
        return InputType.recurrent(n_in)
    if t0 == "convolution":
        raise ValueError(
            "Cannot infer the conv input height/width from a DL4J config with "
            "no input preprocessor — pass input_type=InputType.convolutional(h,w,c)")
    return InputType.feed_forward(n_in)


def import_dl4j_zip(path: str, input_type: Optional[InputType] = None, device=None):
    """Load a DL4J MultiLayerNetwork OR ComputationGraph zip -> our model
    with the parameters (and BN running stats) mapped into native layouts,
    on ``device`` (the GPU unless named; it raises without one).

    CG weights: the reference splits the flat ``coefficients.bin`` view by
    walking vertices in the runtime topological order — Kahn's algorithm with
    a FIFO queue over vertex indices (inputs numbered first in networkInputs
    order, then config vertices in JSON/insertion order), seeded and expanded
    in ascending-index order (graph/ComputationGraph.java:377-470, 1211-1300;
    deterministic because Java HashMap/HashSet over small Integer keys
    iterate ascending). ``_dl4j_topo_order`` replicates exactly that walk.
    """
    from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration, MultiLayerNetwork

    with zipfile.ZipFile(path) as zf:
        conf = json.loads(zf.read("configuration.json").decode("utf-8"))
        names = set(zf.namelist())
        coeff = zf.read("coefficients.bin") if "coefficients.bin" in names else b""
        updater_bin = (zf.read("updaterState.bin")
                       if "updaterState.bin" in names else b"")

    if "vertices" in conf and "confs" not in conf:
        parsed = _parse_cg_conf(conf)
        model = _import_dl4j_graph_conf(conf, input_type, parsed=parsed, device=device)
        if coeff:
            flat = read_nd4j(io.BytesIO(coeff)).ravel().astype(np.float32)
            uflat = (read_nd4j(io.BytesIO(updater_bin)).ravel().astype(np.float32)
                     if updater_bin else None)
            _map_cg_weights(model, parsed, flat, uflat)
            # iterationCount lives on each LayerVertex's NeuralNetConfiguration
            for _vn, (vt, body) in parsed[3].items():
                if vt == "LayerVertex":
                    it_count = (body.get("layerConf") or {}).get("iterationCount")
                    if it_count:
                        model.iteration = int(it_count)
                        break
            model.weights_imported = True
        else:
            model.weights_imported = False  # config-only zip: fresh init
        return model

    confs = conf.get("confs") or []
    if not confs:
        raise ValueError("configuration.json has no 'confs' — not a MultiLayerNetwork zip")
    if not coeff:
        raise ValueError(
            f"{path!r} has no coefficients.bin — a MultiLayerNetwork zip "
            "without weights cannot be imported (the reference always writes "
            "one, ModelSerializer.java:110-150)")
    layer_dicts: List[Tuple[str, dict]] = []
    for c in confs:
        layer = c.get("layer") or {}
        if not isinstance(layer, dict) or len(layer) != 1:
            raise ValueError(f"Unparseable layer entry: {layer!r}")
        t = next(iter(layer))
        layer_dicts.append((t, layer[t]))

    our_layers = tuple(dl4j_layer_to_config(t, d) for t, d in layer_dicts)
    updater = None
    for _, d in layer_dicts:
        updater = _parse_updater(d)
        if updater:
            break

    it = _infer_input_type(layer_dicts, conf.get("inputPreProcessors"), input_type)
    bpt = str(conf.get("backpropType", "Standard"))
    mlc = MultiLayerConfiguration(
        layers=our_layers,
        input_type=it,
        updater=updater or {"type": "sgd", "lr": 0.1},
        seed=int(confs[0].get("seed", 12345) or 12345),
        backprop_type="tbptt" if bpt.lower().startswith("truncated") else "standard",
        tbptt_fwd_length=int(conf.get("tbpttFwdLength", 20)),
        tbptt_back_length=int(conf.get("tbpttBackLength", 20)),
    )
    model = MultiLayerNetwork(mlc, device=device).init()

    flat = read_nd4j(io.BytesIO(coeff)).ravel().astype(np.float32)
    pos = 0
    new_params = list(model.params)
    new_state = list(model.state)
    li = 0  # index over original (non-preprocessor) layers
    entries = []          # (cfg, layer_json, in_type) in flatten order
    entry_model_idx = []  # model layer index per entry

    for idx, lcfg in enumerate(model.layers):
        if type(lcfg).__module__.endswith("preprocessors"):
            continue
        cfg = lcfg
        in_type = model.layer_input_types[idx]
        # The flatten-order permutation for dense-after-conv needs the CONV
        # shape, which the auto-inserted CnnToFeedForward preprocessor hides:
        # use the preprocessor's input type when one precedes this layer.
        if idx > 0 and type(model.layers[idx - 1]).__module__.endswith("preprocessors"):
            pre_in = model.layer_input_types[idx - 1]
            if pre_in.kind == "conv":
                in_type = pre_in
        p, st, pos = _map_layer_params(cfg, layer_dicts[li][1], flat, pos, in_type)
        if p:
            new_params[idx] = {k: _tensor(v, model.device) for k, v in p.items()}
        if st:
            new_state[idx] = {k: _tensor(v, model.device) for k, v in st.items()}
        entries.append((cfg, layer_dicts[li][1], in_type))
        entry_model_idx.append(idx)
        li += 1
    if pos != flat.size:
        raise ValueError(
            f"coefficients.bin has {flat.size} values but the configuration "
            f"consumes {pos} — layer/param layout mismatch")
    model.params = tuple(new_params)
    model.state = tuple(new_state)
    if updater_bin:
        # restore optimizer accumulators (ModelSerializer.java:109-127) so
        # training resumes with the reference's Adam moments etc.
        from deeplearning4j_tpu_torch.train.updaters import normalize_updater
        new_opt = list(model.init_opt_state())
        uflat = read_nd4j(io.BytesIO(updater_bin)).ravel().astype(np.float32)
        gspec = normalize_updater(model.conf.updater)
        mapped = _consume_updater_state(entries, uflat, gspec)
        for li2, accs in mapped.items():
            idx = entry_model_idx[li2]
            new_opt[idx] = _merge_opt_state(new_opt[idx], accs, model.device)
        model.opt_state = tuple(new_opt)
    model.iteration = int(confs[0].get("iterationCount", 0) or 0)
    model.weights_imported = True
    return model


def _parse_cg_conf(conf: dict):
    """DL4J CG JSON -> (inputs, outputs, vertex_inputs, vertices) where
    ``vertices`` is an ordered dict name -> (vertex_type, body) preserving the
    JSON/insertion order that defines the reference's vertex numbering."""
    inputs = list(conf.get("networkInputs") or [])
    outputs = list(conf.get("networkOutputs") or [])
    vertex_inputs: Dict[str, List[str]] = {
        k: list(v) for k, v in (conf.get("vertexInputs") or {}).items()}
    raw = conf.get("vertices") or {}
    if not inputs or not outputs:
        raise ValueError("CG config lacks networkInputs/networkOutputs")
    vertices: Dict[str, Tuple[str, dict]] = {}
    for name, vd in raw.items():
        if not isinstance(vd, dict) or len(vd) != 1:
            raise ValueError(f"unparseable vertex {name!r}: {vd!r}")
        vtype = next(iter(vd))
        vertices[name] = (vtype, vd[vtype] or {})
    return inputs, outputs, vertex_inputs, vertices


def _dl4j_topo_order(inputs: List[str], vertex_names: List[str],
                     vertex_inputs: Dict[str, List[str]]) -> List[str]:
    """The reference's exact topological walk (ComputationGraph.java:1211-1300):
    vertex indices = networkInputs order then config-vertex insertion order;
    Kahn's algorithm with a FIFO queue, seeded with the zero-in-degree
    vertices in ascending index order, and each popped vertex's outputs
    relaxed in ascending index order."""
    from collections import deque

    names = list(inputs) + list(vertex_names)
    idx = {n: i for i, n in enumerate(names)}
    in_edges: Dict[int, set] = {i: set() for i in range(len(names))}
    out_edges: Dict[int, set] = {i: set() for i in range(len(names))}
    for n in vertex_names:
        for s in vertex_inputs.get(n, []):
            if s not in idx:
                raise ValueError(f"vertex {n!r} has unknown input {s!r}")
            in_edges[idx[n]].add(idx[s])
            out_edges[idx[s]].add(idx[n])
    queue = deque(i for i in range(len(names)) if not in_edges[i])
    order: List[int] = []
    while queue:
        nxt = queue.popleft()
        order.append(nxt)
        for v in sorted(out_edges[nxt]):
            in_edges[v].discard(nxt)
            if not in_edges[v]:
                queue.append(v)
    if len(order) != len(names):
        left = [names[i] for i, s in in_edges.items() if s]
        raise ValueError(f"cycle detected in CG config involving {left}")
    return [names[i] for i in order]


def _vertex_preproc(body: dict) -> Optional[Tuple[str, dict]]:
    """LayerVertex 'preProcessor' (InputPreProcessor.java:39-50
    WRAPPER_OBJECT names) -> (name, fields) or None."""
    pp = body.get("preProcessor")
    if isinstance(pp, dict) and len(pp) == 1:
        n = next(iter(pp))
        return n, (pp[n] or {})
    return None


def _pp_hwc(fields: dict) -> Optional[Tuple[int, int, int]]:
    h = fields.get("inputHeight") or fields.get("numRows")
    w = fields.get("inputWidth") or fields.get("numColumns")
    c = fields.get("numChannels")
    if h and w and c:
        return int(h), int(w), int(c)
    return None


_FF_LAYER_TYPES = ("dense", "output", "embedding", "loss", "activation", "dropout")
_RNN_LAYER_TYPES = ("gravesLSTM", "LSTM", "SimpleRnn", "rnnoutput")
_CNN_LAYER_TYPES = ("convolution", "subsampling", "batchNormalization",
                    "localResponseNormalization")


def _layer_of(body: dict) -> Tuple[str, dict]:
    layer_wrap = (body.get("layerConf") or {}).get("layer") or {}
    if len(layer_wrap) != 1:
        raise ValueError(f"unparseable LayerVertex layerConf {body!r}")
    t = next(iter(layer_wrap))
    return t, layer_wrap[t]


def _infer_cg_input_types(parsed, build_fn) -> List[InputType]:
    """Reconstruct the per-input InputTypes a DL4J CG conf does NOT serialize
    (ComputationGraphConfiguration keeps networkInputTypes builder-side only,
    ComputationGraphConfiguration.java:556,921 — but GraphBuilder.setInputTypes
    leaves two recoverable traces: nIn on every layer and InputPreProcessors
    embedded in LayerVertex JSON).

    Strategy per input: (a) a direct consumer's preProcessor names the type
    outright (cnnToFeedForward => conv(h,w,c); feedForwardToCnn =>
    ff of h*w*c); (b) a direct ff/rnn layer consumer's nIn; (c) conv-family
    consumer: channels = conv nIn, then scan square sizes s=1..512, building
    the (uninitialized) graph per candidate and accepting the first s whose
    resolved flatten points agree with every stored cnnToFeedForward dim /
    dense-after-conv nIn in the conf. Ambiguity or no constraint => raise,
    asking for an explicit input_type."""
    inputs, outputs, vertex_inputs, vertices = parsed

    consumers: Dict[str, List[str]] = {i: [] for i in inputs}
    for name in vertices:
        for s in vertex_inputs.get(name, []):
            if s in consumers:
                consumers[s].append(name)

    resolved: List[Optional[InputType]] = []
    unresolved_conv: List[Tuple[int, int]] = []  # (input index, channels)
    for ii, inp in enumerate(inputs):
        it: Optional[InputType] = None
        conv_channels = None
        for cname in consumers[inp]:
            vtype, body = vertices[cname]
            if vtype != "LayerVertex":
                continue
            pp = _vertex_preproc(body)
            t, d = _layer_of(body)
            n_in = int(d.get("nin") or d.get("nIn") or 0)
            if pp is not None:
                hwc = _pp_hwc(pp[1])
                if pp[0] == "cnnToFeedForward" and hwc:
                    it = InputType.convolutional(*hwc)
                    break
                if pp[0] == "feedForwardToCnn" and hwc:
                    it = InputType.convolutional_flat(*hwc)
                    break
                if pp[0] == "rnnToFeedForward" and n_in:
                    it = InputType.recurrent(n_in)
                    break
                if pp[0] == "feedForwardToRnn" and n_in:
                    it = InputType.feed_forward(n_in)
                    break
            if t in _RNN_LAYER_TYPES and n_in:
                it = InputType.recurrent(n_in)
                break
            if t in _FF_LAYER_TYPES and n_in:
                it = InputType.feed_forward(n_in)
                break
            if t == "convolution" and n_in:
                conv_channels = n_in
        if it is None and conv_channels is not None:
            unresolved_conv.append((ii, conv_channels))
        resolved.append(it)

    missing = [inputs[i] for i, it in enumerate(resolved)
               if it is None and i not in [u[0] for u in unresolved_conv]]
    if missing:
        raise ValueError(
            f"cannot infer InputType for CG inputs {missing} — pass "
            "input_type= (one InputType per network input)")

    if not unresolved_conv:
        return resolved  # type: ignore[return-value]

    def _flatten_constraints_ok(model) -> int:
        """#constraints checked, or -1 on any mismatch."""
        checks = 0
        for name, (vtype, body) in vertices.items():
            if vtype != "LayerVertex":
                continue
            rt = model.rt.get(name)
            if rt is None:
                return -1
            src_t = model.vertex_types.get(rt.inputs[0])
            pp = _vertex_preproc(body)
            if pp is not None and pp[0] == "cnnToFeedForward":
                hwc = _pp_hwc(pp[1])
                if hwc:
                    checks += 1
                    if (src_t is None or src_t.kind != "conv" or
                            (src_t.height, src_t.width, src_t.channels) != hwc):
                        return -1
                    continue
            if rt.pre is not None and src_t is not None and src_t.kind == "conv":
                t, d = _layer_of(body)
                n_in = int(d.get("nin") or d.get("nIn") or 0)
                if n_in:
                    checks += 1
                    if src_t.flat_size() != n_in:
                        return -1
        return checks

    matches: List[List[InputType]] = []
    match_sizes: List[int] = []
    first_build_error: Optional[Exception] = None
    any_built = False
    for s in range(1, 513):
        cand = list(resolved)
        for ii, ch in unresolved_conv:
            cand[ii] = InputType.convolutional(s, s, ch)
        try:
            model = build_fn(cand, init=False)
        except Exception as e:  # most candidates legitimately fail shape checks
            if first_build_error is None:
                first_build_error = e
            continue
        any_built = True
        checks = _flatten_constraints_ok(model)
        if checks > 0:
            matches.append(cand)
            match_sizes.append(s)
    if len(matches) == 1:
        return matches[0]  # type: ignore[return-value]
    names = [inputs[i] for i, _ in unresolved_conv]
    if len(matches) > 1:
        raise ValueError(
            f"ambiguous conv input size for CG inputs {names}: sizes "
            f"{match_sizes} all satisfy the conf's flatten constraints — "
            "pass input_type= (one InputType per network input)")
    if not any_built and first_build_error is not None:
        # every candidate failed identically: a size-INDEPENDENT config
        # problem — surface it instead of blaming the missing input size
        raise first_build_error
    raise ValueError(
        f"cannot infer the conv input height/width for CG inputs {names}: "
        "no stored InputPreProcessor or dense-nIn flatten constraint pins "
        "the size — pass input_type= (one InputType per network input)")


def _map_cg_weights(model, parsed, flat: np.ndarray,
                    updater_flat: Optional[np.ndarray] = None):
    """Split coefficients.bin by the reference's topological walk and map
    each LayerVertex segment into our per-vertex param/state dicts. When
    ``updater_flat`` is given, also restore optimizer accumulators
    (ComputationGraphUpdater.getOrderedLayers walks the same topo order)."""

    inputs, outputs, vertex_inputs, vertices = parsed
    order = _dl4j_topo_order(inputs, list(vertices), vertex_inputs)
    input_set = set(inputs)
    pos = 0
    entries = []       # (cfg, layer_json, in_type) in flatten order
    entry_names = []
    for name in order:
        if name in input_set:
            continue
        vtype, body = vertices[name]
        if vtype != "LayerVertex":
            continue  # all supported non-layer vertices are parameter-free
        t, d = _layer_of(body)
        rt = model.rt[name]
        in_t = rt.input_types[0]
        src_t = model.vertex_types.get(rt.inputs[0])
        # dense-after-conv needs the CONV shape for the (c,h,w)->(h,w,c)
        # flatten permutation, which our auto-preprocessor hides
        if rt.pre is not None and src_t is not None and src_t.kind == "conv":
            in_t = src_t
        p, st, pos = _map_layer_params(rt.config, d, flat, pos, in_t)
        if p:
            model.params[name] = {k: _tensor(v, model.device) for k, v in p.items()}
        if st:
            model.state[name] = {k: _tensor(v, model.device) for k, v in st.items()}
        entries.append((rt.config, d, in_t))
        entry_names.append(name)
    if pos != flat.size:
        raise ValueError(
            f"coefficients.bin has {flat.size} values but the CG configuration "
            f"consumes {pos} — vertex/param layout mismatch")
    model.opt_state = None
    if updater_flat is not None and updater_flat.size:
        from deeplearning4j_tpu_torch.train.updaters import normalize_updater
        model.init_opt_state()
        gspec = normalize_updater(model.conf.updater)
        mapped = _consume_updater_state(entries, updater_flat, gspec)
        for li, accs in mapped.items():
            name = entry_names[li]
            model.opt_state[name] = _merge_opt_state(model.opt_state[name], accs,
                                                     model.device)


def _import_dl4j_graph_conf(conf: dict, input_type, parsed=None, device=None):
    """DL4J ComputationGraphConfiguration JSON -> our ComputationGraph
    (freshly initialized). Vertex dialect: conf/graph/GraphVertex.java:40-52
    WRAPPER_OBJECT names; layer vertices wrap a NeuralNetConfiguration."""
    if parsed is None:
        parsed = _parse_cg_conf(conf)
    inputs, outputs, vertex_inputs, vertices = parsed

    def build(its, init=True):
        return _build_cg(inputs, outputs, vertex_inputs, vertices, its, init, device)

    if input_type is None:
        its = _infer_cg_input_types(parsed, build)
    else:
        its = list(input_type) if isinstance(input_type, (list, tuple)) else [input_type]
    return build(its, init=True)


def _build_cg(inputs, outputs, vertex_inputs, vertices, its, init=True, device=None):
    from deeplearning4j_tpu_torch.nn.graph import (
        ComputationGraph,
        ComputationGraphConfiguration,
        ElementWiseVertex,
        MergeVertex,
        SubsetVertex,
    )

    g = ComputationGraphConfiguration.builder().add_inputs(*inputs)
    g.set_input_types(*its)

    from deeplearning4j_tpu_torch.nn.graph import (
        L2NormalizeVertex,
        L2Vertex,
        ScaleVertex,
        ShiftVertex,
        StackVertex,
        UnstackVertex,
    )

    def make_vertex(vtype: str, body: dict):
        if vtype == "MergeVertex":
            return MergeVertex()
        if vtype == "ElementWiseVertex":
            return ElementWiseVertex(op=str(body.get("op", "Add")).lower())
        if vtype == "SubsetVertex":
            return SubsetVertex(from_index=int(body.get("from", 0)),
                                to_index=int(body.get("to", 0)))
        if vtype == "ScaleVertex":
            return ScaleVertex(scale=float(body.get("scaleFactor", 1.0)))
        if vtype == "ShiftVertex":
            return ShiftVertex(shift=float(body.get("shiftFactor", 0.0)))
        if vtype == "StackVertex":
            return StackVertex()
        if vtype == "UnstackVertex":
            return UnstackVertex(from_index=int(body.get("from", 0)),
                                 stack_size=int(body.get("stackSize", 1)))
        if vtype == "L2Vertex":
            return L2Vertex(eps=float(body.get("eps", 1e-8)))
        if vtype == "L2NormalizeVertex":
            return L2NormalizeVertex(eps=float(body.get("eps", 1e-8)))
        raise ValueError(f"DL4J graph vertex type {vtype!r} not supported")

    # vertexInputs preserves the reference's insertion order (LinkedHashMap);
    # add vertices in an order where inputs precede consumers
    added = set(inputs)
    pending = [n for n in vertex_inputs if n not in inputs]
    updater = None
    while pending:
        progressed = False
        for name in list(pending):
            ins = vertex_inputs.get(name, [])
            if any(i not in added for i in ins):
                continue
            if name not in vertices:
                raise ValueError(f"vertexInputs names unknown vertex {name!r}")
            vtype, body = vertices[name]
            if vtype == "LayerVertex":
                t, d = _layer_of(body)
                g.add_layer(name, dl4j_layer_to_config(t, d), *ins)
                if updater is None:
                    updater = _parse_updater(d)
            else:
                g.add_vertex(name, make_vertex(vtype, body), *ins)
            added.add(name)
            pending.remove(name)
            progressed = True
        if not progressed:
            raise ValueError(f"cyclic or dangling vertex inputs: {pending}")
    g.set_outputs(*outputs)
    g.updater(updater or {"type": "sgd", "lr": 0.1})
    model = ComputationGraph(g.build(), device=device)
    return model.init() if init else model


# ---------------------------------------------------------------------------
# Export
# ---------------------------------------------------------------------------

def _export_layer(cfg, params: dict, state: dict, in_type: InputType) -> Tuple[Optional[dict], np.ndarray]:
    """(DL4J layer JSON object or None for preprocessors, flat segment)."""
    from deeplearning4j_tpu_torch.nn import layers as L

    def act_json(a):
        # Keyed by OUR registered activation names; unmapped names must fail
        # loudly rather than silently exporting a different model.
        names = {"relu": "ReLU", "sigmoid": "Sigmoid", "tanh": "TanH",
                 "softmax": "Softmax", "identity": "Identity", "elu": "ELU",
                 "leakyrelu": "LReLU", "softplus": "SoftPlus",
                 "softsign": "SoftSign", "hardtanh": "HardTanh",
                 "hardsigmoid": "HardSigmoid", "selu": "SELU", "cube": "Cube",
                 "rationaltanh": "RationalTanh", "rectifiedtanh": "RectifiedTanh",
                 "swish": "Swish", "relu6": "ReLU6",
                 "thresholdedrelu": "ThresholdedReLU"}
        key = str(a).lower()
        if key not in names:
            raise ValueError(
                f"export_dl4j_zip: activation {a!r} has no DL4J equivalent")
        return {names[key]: {}}

    name = type(cfg).__name__
    seg = np.zeros((0,), np.float32)
    params = {k: v if isinstance(v, dict) else _host(v) for k, v in params.items()}
    state = {k: v if isinstance(v, dict) else _host(v) for k, v in state.items()}

    if isinstance(cfg, L.Conv2D) and not isinstance(cfg, L.Deconv2D):
        W = np.asarray(params["W"], np.float32)        # (kh,kw,in,out)
        kh, kw, n_in, n_out = W.shape
        pieces = []
        if cfg.has_bias:
            pieces.append(np.asarray(params["b"], np.float32).ravel())
        pieces.append(np.transpose(W, (3, 2, 0, 1)).ravel())  # C-order (out,in,kh,kw)
        seg = np.concatenate(pieces)
        d = {"nin": n_in, "nout": n_out, "kernelSize": [kh, kw],
             "stride": list(cfg.stride), "padding": list(cfg.padding),
             "convolutionMode": cfg.convolution_mode.capitalize(),
             "hasBias": cfg.has_bias, "activationFn": act_json(cfg.activation)}
        return {"convolution": d}, seg

    if isinstance(cfg, L.Subsampling2D):
        d = {"kernelSize": list(cfg.kernel), "stride": list(cfg.stride),
             "padding": list(cfg.padding),
             "convolutionMode": cfg.convolution_mode.capitalize(),
             "poolingType": cfg.pooling.upper()}
        return {"subsampling": d}, seg

    if isinstance(cfg, L.BatchNorm):
        pieces = []
        n = in_type.channels if in_type.kind == "conv" else in_type.flat_size()
        if cfg.use_gamma_beta:
            pieces += [np.asarray(params["gamma"], np.float32).ravel(),
                       np.asarray(params["beta"], np.float32).ravel()]
        pieces += [np.asarray(state["mean"], np.float32).ravel(),
                   np.asarray(state["var"], np.float32).ravel()]
        seg = np.concatenate(pieces)
        d = {"nin": n, "nout": n, "decay": cfg.decay, "eps": cfg.eps,
             "lockGammaBeta": not cfg.use_gamma_beta,
             "activationFn": act_json("identity")}
        return {"batchNormalization": d}, seg

    if isinstance(cfg, (L.GravesLSTM, L.LSTM)):
        graves = isinstance(cfg, L.GravesLSTM)
        Wx = np.asarray(params["Wx"], np.float32)
        Wh = np.asarray(params["Wh"], np.float32)
        b = np.asarray(params["b"], np.float32)
        n_in, H4 = Wx.shape
        H = H4 // 4
        wx = np.empty_like(Wx)
        rw_cols = 4 * H + (3 if graves else 0)
        rw = np.zeros((H, rw_cols), np.float32)
        bb = np.empty_like(b)
        for ours, theirs in _lstm_block_perm(H):
            wx[:, theirs * H:(theirs + 1) * H] = Wx[:, ours * H:(ours + 1) * H]
            rw[:, theirs * H:(theirs + 1) * H] = Wh[:, ours * H:(ours + 1) * H]
            bb[theirs * H:(theirs + 1) * H] = b[ours * H:(ours + 1) * H]
        if graves:
            p = np.asarray(params["peephole"], np.float32)
            rw[:, 4 * H] = p[H:2 * H]       # wFF <- p_f
            rw[:, 4 * H + 1] = p[2 * H:]    # wOO <- p_o
            rw[:, 4 * H + 2] = p[:H]        # wGG <- p_i
        seg = np.concatenate([wx.ravel(order="F"), rw.ravel(order="F"), bb])
        d = {"nin": n_in, "nout": H, "forgetGateBiasInit": cfg.forget_gate_bias_init,
             "activationFn": act_json(cfg.activation)}
        return {"gravesLSTM" if graves else "LSTM": d}, seg

    if name in ("Dense", "OutputLayer", "RnnOutputLayer", "Embedding"):
        W = np.asarray(params["W"], np.float32)
        n_in, n_out = W.shape
        if in_type.kind == "conv":
            H_, W_, C_ = in_type.height, in_type.width, in_type.channels
            inv = np.arange(n_in).reshape(H_, W_, C_).transpose(2, 0, 1).ravel()
            W = W[inv]
        has_bias = bool(getattr(cfg, "has_bias", True)) and "b" in params
        pieces = [W.ravel(order="F")]
        if has_bias:
            pieces.append(np.asarray(params["b"], np.float32).ravel())
        seg = np.concatenate(pieces)
        d = {"nin": n_in, "nout": n_out, "hasBias": has_bias,
             "activationFn": act_json(cfg.activation)}
        t = {"Dense": "dense", "OutputLayer": "output",
             "RnnOutputLayer": "rnnoutput", "Embedding": "embedding"}[name]
        if t in ("output", "rnnoutput"):
            loss_names = {"mcxent": "MCXENT", "mse": "MSE", "xent": "BinaryXENT",
                          "l1": "L1", "l2": "L2", "mae": "MAE", "msle": "MSLE",
                          "mape": "MAPE", "hinge": "Hinge",
                          "squared_hinge": "SquaredHinge", "poisson": "Poisson",
                          "kld": "KLD", "cosine_proximity": "CosineProximity"}
            key = str(cfg.loss).lower()
            if key not in loss_names:
                raise ValueError(
                    f"export_dl4j_zip: loss {cfg.loss!r} has no DL4J equivalent")
            d["lossFn"] = {"@class": "org.nd4j.linalg.lossfunctions.impl.Loss"
                           + loss_names[key]}
        return {t: d}, seg

    if isinstance(cfg, L.ActivationLayer):
        return {"activation": {"activationFn": act_json(cfg.activation)}}, seg
    if isinstance(cfg, L.DropoutLayer):
        return {"dropout": {"dropOut": 1.0 - cfg.dropout}}, seg
    if isinstance(cfg, L.LocalResponseNormalization):
        return {"localResponseNormalization": {
            "k": cfg.k, "n": cfg.n, "alpha": cfg.alpha, "beta": cfg.beta}}, seg
    if isinstance(cfg, L.GlobalPooling):
        return {"GlobalPooling": {"poolingType": cfg.pooling.upper()}}, seg
    raise ValueError(f"export_dl4j_zip: layer {name} not supported")


def _export_layer_spec(cfg, gspec: dict) -> dict:
    """The canonical updater spec a layer's trainable vars use on export:
    per-layer override first (LayerConfig.updater), else the model global;
    frozen layers are NoOp."""
    if not getattr(cfg, "trainable", True):
        return _canon_spec({"type": "noop"})
    lspec = getattr(cfg, "updater", None)
    return _canon_spec(lspec) if lspec else gspec


def _export_updater_state(model, export_entries) -> np.ndarray:
    """Flatten optimizer accumulators into the reference's updater-block
    layout (inverse of ``_consume_updater_state``). ``export_entries``:
    ordered [(cfg, in_type, model_idx)]."""
    gspec = _canon_spec(model.conf.updater)

    def spec_for(li):
        return _export_layer_spec(export_entries[li][0], gspec)

    # per-(entry, var) accumulator segments in DL4J per-layer layout
    seg_of: Dict[Tuple[int, int, str], np.ndarray] = {}
    for li, (cfg, in_type, idx) in enumerate(export_entries):
        sizes = _dl4j_var_sizes(cfg, in_type)
        # a model that never updated has no opt_state yet: its accumulators
        # are the zeros the JAX package's init builds
        opt = model.opt_state[idx] if model.opt_state is not None else None
        keys = _spec_state_keys(spec_for(li))
        if keys and isinstance(opt, dict):
            for key in keys:
                tree = opt.get(key)
                if tree is None:
                    continue
                # accumulators flatten exactly like the params themselves;
                # BN mean/var (stats) have no accumulator — zero-filled here
                # and dropped below
                np_tree = {k: _host(v) for k, v in tree.items()}
                zero_state = {k: np.zeros(tuple(v.shape), np.float32)
                              for k, v in (model.state[idx] or {}).items()}
                _, seg = _export_layer(cfg, np_tree, zero_state, in_type)
                off = 0
                for vi, (kind, size) in enumerate(sizes):
                    if kind == "train":
                        seg_of[(li, vi, key)] = seg[off:off + size]
                    off += size

    _, blocks = _updater_var_blocks(
        [(cfg, it) for cfg, it, _idx in export_entries], spec_for)
    pieces = []
    for spec, recs in blocks:
        for key in _spec_state_keys(spec):
            for li, vi, size, _, _ in recs:
                pieces.append(seg_of.get((li, vi, key),
                                         np.zeros(size, np.float32)))
    return (np.concatenate(pieces).astype(np.float32)
            if pieces else np.zeros((0,), np.float32))


def _vertex_to_dl4j_json(v) -> dict:
    """Inverse of ``_build_cg.make_vertex`` (conf/graph/GraphVertex.java
    WRAPPER_OBJECT names)."""
    name = type(v).__name__
    if name == "MergeVertex":
        return {"MergeVertex": {}}
    if name == "ElementWiseVertex":
        return {"ElementWiseVertex": {"op": str(v.op).capitalize()}}
    if name == "SubsetVertex":
        return {"SubsetVertex": {"from": v.from_index, "to": v.to_index}}
    if name == "ScaleVertex":
        return {"ScaleVertex": {"scaleFactor": v.scale}}
    if name == "ShiftVertex":
        return {"ShiftVertex": {"shiftFactor": v.shift}}
    if name == "StackVertex":
        return {"StackVertex": {}}
    if name == "UnstackVertex":
        return {"UnstackVertex": {"from": v.from_index,
                                  "stackSize": v.stack_size}}
    if name == "L2Vertex":
        return {"L2Vertex": {"eps": v.eps}}
    if name == "L2NormalizeVertex":
        return {"L2NormalizeVertex": {"eps": v.eps}}
    raise ValueError(
        f"export_dl4j_zip: graph vertex {name} has no DL4J equivalent")


def _export_cg_zip(model, path: str):
    """ComputationGraph -> reference CG zip: vertices emitted in topological
    order (so the reference's vertex numbering and param-flattening walk —
    see ``_dl4j_topo_order`` — reproduce this exporter's segment order),
    LayerVertices carrying cnnToFeedForward preProcessors where our resolver
    inserted one (which is also what makes re-import's input-type inference
    work), plus coefficients.bin and updaterState.bin."""
    conf = model.conf
    gspec = _canon_spec(conf.updater)
    inputs = list(conf.inputs)
    vertices_json: Dict[str, dict] = {}
    vertex_inputs: Dict[str, list] = {}

    def layer_in_type(rt):
        """(the in_type _export_layer uses, the preProcessor JSON to store
        — WRAPPER_OBJECT names the importer and the reference both read)."""
        in_type = rt.input_types[0]
        src_t = model.vertex_types.get(rt.inputs[0])
        if rt.pre is None or src_t is None:
            return in_type, None
        pname = type(rt.pre).__name__
        if pname == "CnnToFeedForward":
            # dense-after-conv: the flatten permutation needs the CONV shape
            return src_t, {"cnnToFeedForward": {
                "inputHeight": src_t.height, "inputWidth": src_t.width,
                "numChannels": src_t.channels}}
        if pname == "FeedForwardToCnn":
            return in_type, {"feedForwardToCnn": {
                "inputHeight": in_type.height, "inputWidth": in_type.width,
                "numChannels": in_type.channels}}
        if pname == "RnnToFeedForward":
            return in_type, {"rnnToFeedForward": {}}
        if pname == "FeedForwardToRnn":
            return in_type, {"feedForwardToRnn": {}}
        if pname == "CnnToRnn":
            return in_type, {"cnnToRnn": {
                "inputHeight": src_t.height, "inputWidth": src_t.width,
                "numChannels": src_t.channels}}
        if pname == "RnnToCnn":
            return in_type, {"rnnToCnn": {
                "inputHeight": in_type.height, "inputWidth": in_type.width,
                "numChannels": in_type.channels}}
        raise ValueError(
            f"export_dl4j_zip: auto-inserted preprocessor {pname} has no "
            "DL4J InputPreProcessor equivalent")

    # pass 1: the conf JSON, vertices keyed in our topological order; the
    # per-vertex flat segment is cached so pass 2 only reorders
    seg_of: Dict[str, np.ndarray] = {}
    entry_of: Dict[str, tuple] = {}
    for name in model.topo_order:
        rt = model.rt[name]
        vertex_inputs[name] = list(rt.inputs)
        if not rt.spec.is_layer():
            vertices_json[name] = _vertex_to_dl4j_json(rt.config)
            continue
        in_type, pp = layer_in_type(rt)
        obj, seg = _export_layer(rt.config, model.params.get(name) or {},
                                 model.state.get(name) or {}, in_type)
        if obj is None:
            raise ValueError(
                f"export_dl4j_zip: CG vertex {name!r} produced no DL4J layer")
        t = next(iter(obj))
        if _dl4j_var_sizes(rt.config, in_type):
            obj[t].setdefault(
                "iUpdater",
                _updater_to_dl4j_json(_export_layer_spec(rt.config, gspec)))
        lv: Dict[str, Any] = {"layerConf": {
            "layer": obj,
            "iterationCount": int(getattr(model, "iteration", 0))}}
        if pp is not None:
            lv["preProcessor"] = pp
        vertices_json[name] = {"LayerVertex": lv}
        seg_of[name] = seg
        entry_of[name] = (rt.config, in_type, name)

    # pass 2: coefficients in the order the IMPORTER (and the reference
    # runtime) will consume them — the Kahn walk over the numbering the
    # JSON defines, which is NOT always our emission order (two valid
    # topological orders of the same DAG can differ)
    ref_order = _dl4j_topo_order(inputs, list(vertices_json), vertex_inputs)
    segs = [seg_of[n] for n in ref_order if n in seg_of]
    export_entries = [entry_of[n] for n in ref_order if n in entry_of]

    conf_json = {
        "networkInputs": inputs,
        "networkOutputs": list(conf.outputs),
        "vertexInputs": vertex_inputs,
        "vertices": vertices_json,
    }
    flat = np.concatenate(segs) if segs else np.zeros((0,), np.float32)
    buf = io.BytesIO()
    write_nd4j(buf, flat[None, :], "FLOAT")
    ustate = _export_updater_state(model, export_entries)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("configuration.json", json.dumps(conf_json))
        zf.writestr("coefficients.bin", buf.getvalue())
        if ustate.size:
            ubuf = io.BytesIO()
            write_nd4j(ubuf, ustate[None, :], "FLOAT")
            zf.writestr("updaterState.bin", ubuf.getvalue())


def export_dl4j_zip(model, path: str):
    """Write a MultiLayerNetwork OR ComputationGraph in the reference's zip
    format (configuration.json + coefficients.bin + updaterState.bin) so
    DL4J can load our models and resume training with the optimizer state
    intact."""
    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    if isinstance(model, ComputationGraph):
        return _export_cg_zip(model, path)
    mlc = model.conf
    gspec = _canon_spec(mlc.updater)
    confs = []
    segs = []
    export_entries = []  # (cfg, in_type, model layer idx)
    for idx, cfg in enumerate(model.layers):
        if type(cfg).__module__.endswith("preprocessors"):
            continue
        in_type = model.layer_input_types[idx]
        if idx > 0 and type(model.layers[idx - 1]).__module__.endswith("preprocessors"):
            pre_in = model.layer_input_types[idx - 1]
            if pre_in.kind == "conv":
                in_type = pre_in
        obj, seg = _export_layer(cfg, model.params[idx] or {},
                                 model.state[idx] or {}, in_type)
        if obj is not None:
            t = next(iter(obj))
            if _dl4j_var_sizes(cfg, in_type):
                # frozen layers export iUpdater NoOp so the import side
                # segments updaterState.bin identically (no accumulators)
                obj[t].setdefault(
                    "iUpdater", _updater_to_dl4j_json(_export_layer_spec(cfg, gspec)))
            confs.append({"layer": obj, "seed": mlc.seed,
                          "iterationCount": int(getattr(model, "iteration", 0))})
            segs.append(seg)
            export_entries.append((cfg, in_type, idx))

    preprocs = {}
    it = mlc.input_type
    if it is not None and it.kind in ("conv", "conv_flat"):
        preprocs["0"] = {"feedForwardToCnn": {
            "inputHeight": it.height, "inputWidth": it.width,
            "numChannels": it.channels}}

    conf_json = {
        "backprop": True, "pretrain": False,
        "backpropType": "TruncatedBPTT" if mlc.backprop_type == "tbptt" else "Standard",
        "tbpttFwdLength": mlc.tbptt_fwd_length, "tbpttBackLength": mlc.tbptt_back_length,
        "confs": confs, "inputPreProcessors": preprocs,
    }
    flat = np.concatenate(segs) if segs else np.zeros((0,), np.float32)
    buf = io.BytesIO()
    write_nd4j(buf, flat[None, :], "FLOAT")
    ustate = _export_updater_state(model, export_entries)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("configuration.json", json.dumps(conf_json))
        zf.writestr("coefficients.bin", buf.getvalue())
        if ustate.size:
            ubuf = io.BytesIO()
            write_nd4j(ubuf, ustate[None, :], "FLOAT")
            zf.writestr("updaterState.bin", ubuf.getvalue())
