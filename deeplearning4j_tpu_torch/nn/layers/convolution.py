"""Convolution, pooling, padding and resampling layers (PyTorch port of
``nn/layers/convolution.py``).

The JAX package lowers these through XLA (``lax.conv_general_dilated``,
``lax.reduce_window``); none is a TPU kernel. Here they are torch ops:
``F.conv1d`` / ``F.conv2d`` (cuDNN on the card) and torch's pooling.

Layout: the port keeps the JAX package's **NHWC** activations ([B, H, W,
C]; [B, T, C] for the 1-D layers) at every layer boundary and its **HWIO**
kernels ([kh, kw, in, out]; 1-D [k, in, out]), so checkpoints, interop and
``pp_cnn_to_ff``'s (h, w, c) flattening compare one to one. Inside
``apply`` the activation is permuted to NCHW and the kernel to OIHW for
torch: on the card a contiguous NHWC tensor permuted to NCHW is a
``channels_last`` view, so cuDNN gets NHWC memory and nothing is copied.

Padding follows XLA exactly. ``convolution_mode="same"`` pads
``total = max((ceil(n / s) - 1) * s + k_eff - n, 0)`` with ``total // 2``
before and the rest after (k_eff the dilated kernel extent), as explicit
``F.pad`` (torch's ``padding="same"`` refuses strides above 1);
``truncate`` and ``strict`` pad ``padding`` symmetrically, and ``strict``
raises at config time when the stride does not divide. Pooling pads as
``reduce_window`` inits: max with -inf, avg, sum and pnorm with 0, avg
dividing by kh * kw, padded cells included.

Float32 convolutions on the card go through cuDNN in TF32 while
``torch.backends.cudnn.allow_tf32`` is True, which is torch's default; a
caller who wants float32 arithmetic sets it to False.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn import initializers
from deeplearning4j_tpu_torch.nn.config import FeedForwardLayerConfig, LayerConfig, register_layer
from deeplearning4j_tpu_torch.nn.input_type import InputType


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (tuple, list)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def _out_size(size: int, k: int, s: int, p: int, mode: str, d: int = 1) -> int:
    k_eff = (k - 1) * d + 1  # effective kernel extent under dilation
    if mode == "same":
        return -(-size // s)  # ceil
    if mode == "strict":
        if (size - k_eff + 2 * p) % s != 0:
            raise ValueError(
                f"Strict convolution mode: ({size} - {k_eff} + 2*{p}) not divisible by stride {s}"
            )
    return (size - k_eff + 2 * p) // s + 1


def _same_pads(n: int, k_eff: int, s: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial axis: (before, after)."""
    total = max((-(-n // s) - 1) * s + k_eff - n, 0)
    return total // 2, total - total // 2


def _spatial_pads(mode: str, sizes, kernel, strides, padding, dilation=None):
    """(before, after) per spatial axis: SAME as XLA computes it, else the
    symmetric explicit padding."""
    dilation = dilation or (1,) * len(sizes)
    if mode == "same":
        return [_same_pads(n, (k - 1) * d + 1, s)
                for n, k, s, d in zip(sizes, kernel, strides, dilation)]
    return [(p, p) for p in padding]


def _torch_pad(pads) -> Tuple[int, ...]:
    """Per-axis (before, after) pads, first spatial axis first, as the flat
    tuple ``F.pad`` takes (last axis first)."""
    out: Tuple[int, ...] = ()
    for lo, hi in reversed(pads):
        out += (lo, hi)
    return out


def _nchw(x: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] -> [B, C, H, W] (a channels_last view, no copy)."""
    return x.permute(0, 3, 1, 2)


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1)


def _oihw(W: torch.Tensor) -> torch.Tensor:
    """An HWIO kernel as torch's [out, in, kh, kw]."""
    return W.permute(3, 2, 0, 1)


@register_layer("conv2d")
@dataclass
class Conv2D(FeedForwardLayerConfig):
    """2-D convolution (ConvolutionLayer.java): n_out output channels, n_in
    inferred from the input channels; HWIO kernel ``W``, bias ``b``."""

    kernel: Any = (3, 3)
    stride: Any = (1, 1)
    padding: Any = (0, 0)
    dilation: Any = (1, 1)
    convolution_mode: str = "truncate"  # same | truncate | strict
    has_bias: bool = True

    def infer_n_in(self, input_type):
        return input_type.channels  # n_in = input channels, not flat size

    def output_type(self, input_type: InputType) -> InputType:
        if input_type.kind != "conv":
            raise ValueError(f"Conv2D needs convolutional input, got {input_type}")
        kh, kw = _pair(self.kernel)
        sh, sw = _pair(self.stride)
        ph, pw = _pair(self.padding)
        dh, dw = _pair(self.dilation)
        oh = _out_size(input_type.height, kh, sh, ph, self.convolution_mode, dh)
        ow = _out_size(input_type.width, kw, sw, pw, self.convolution_mode, dw)
        return InputType.convolutional(oh, ow, self.n_out)

    def init(self, gen, input_type, dtype=torch.float32, device=None):
        in_c = self.n_in if self.n_in is not None else input_type.channels
        kh, kw = _pair(self.kernel)
        params = {"W": initializers.initialize(
            self.weight_init, gen, (kh, kw, in_c, self.n_out), in_c * kh * kw,
            self.n_out * kh * kw, dtype, device)}
        if self.has_bias:
            params["b"] = torch.full((self.n_out,), self.bias_init, dtype=dtype, device=device)
        return params

    def _conv(self, x, W, groups: int = 1):
        """NHWC x (*) HWIO W with the layer's stride, dilation and padding;
        NHWC out."""
        stride, dilation = _pair(self.stride), _pair(self.dilation)
        xc = _nchw(x)
        pads = _spatial_pads(self.convolution_mode, xc.shape[2:], W.shape[:2], stride,
                             _pair(self.padding), dilation)
        if any(lo != hi for lo, hi in pads):
            xc, pad = F.pad(xc, _torch_pad(pads)), 0
        else:
            pad = tuple(lo for lo, _ in pads)
        y = F.conv2d(xc, _oihw(W), stride=stride, padding=pad, dilation=dilation,
                     groups=groups)
        return _nhwc(y)

    def _finish(self, params, y, state):
        if self.has_bias:
            y = y + params["b"]
        return self.activation_fn()(y), state

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        x = self.maybe_dropout_input(x, train, rng)
        return self._finish(params, self._conv(x, params["W"]), state)

    def propagate_mask(self, mask, input_type):
        return None  # masks don't flow through spatial convs


def _dilate(x: torch.Tensor, strides) -> torch.Tensor:
    """NCHW ``x`` with ``s - 1`` zeros between neighbours along each
    spatial axis (the lhs dilation of ``lax.conv_transpose``)."""
    sh, sw = strides
    if (sh, sw) == (1, 1):
        return x
    B, C, H, W = x.shape
    out = x.new_zeros((B, C, (H - 1) * sh + 1, (W - 1) * sw + 1))
    out[:, :, ::sh, ::sw] = x
    return out


def _conv_transpose_pads(k: int, s: int) -> Tuple[int, int]:
    """``lax.conv_transpose``'s padding for "SAME" (jax ``_conv_transpose_padding``)."""
    pad_len = k + s - 2
    pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
    return pad_a, pad_len - pad_a


@register_layer("deconv2d")
@dataclass
class Deconv2D(Conv2D):
    """Transposed convolution (Deconvolution2D.java), as the JAX package's
    ``lax.conv_transpose`` without ``transpose_kernel``: a convolution of the
    stride-dilated input with the HWIO kernel as given (no spatial flip, no
    in/out swap), explicit pads ``k - 1 - p`` (or SAME's). torch's
    ``conv_transpose2d`` is the adjoint of a convolution, another function
    of the same kernel, so the port dilates the input and convolves."""

    def output_type(self, input_type: InputType) -> InputType:
        kh, kw = _pair(self.kernel)
        sh, sw = _pair(self.stride)
        ph, pw = _pair(self.padding)
        if self.convolution_mode == "same":
            oh, ow = input_type.height * sh, input_type.width * sw
        else:
            oh = sh * (input_type.height - 1) + kh - 2 * ph
            ow = sw * (input_type.width - 1) + kw - 2 * pw
        return InputType.convolutional(oh, ow, self.n_out)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        x = self.maybe_dropout_input(x, train, rng)
        W = params["W"]
        kh, kw = W.shape[:2]
        strides = _pair(self.stride)
        if self.convolution_mode == "same":
            pads = [_conv_transpose_pads(k, s) for k, s in zip((kh, kw), strides)]
        else:
            ph, pw = _pair(self.padding)
            pads = [(kh - 1 - ph, kh - 1 - ph), (kw - 1 - pw, kw - 1 - pw)]
        xd = F.pad(_dilate(_nchw(x), strides), _torch_pad(pads))   # negative pads crop
        return self._finish(params, _nhwc(F.conv2d(xd, _oihw(W))), state)


@register_layer("depthwise_conv2d")
@dataclass
class DepthwiseConv2D(Conv2D):
    """Depthwise convolution (DepthwiseConvolution2D.java): each input
    channel convolved with ``depth_multiplier`` filters, n_out = in_c *
    depth_multiplier. HWIO ``W`` [kh, kw, 1, in_c * mult]: output channel
    c * mult + m reads input channel c, which is also the channel order of
    torch's ``groups=in_c`` weight [in_c * mult, 1, kh, kw]."""

    depth_multiplier: int = 1

    def output_type(self, input_type: InputType) -> InputType:
        base = super().output_type(input_type)
        return InputType.convolutional(base.height, base.width,
                                       input_type.channels * self.depth_multiplier)

    def init(self, gen, input_type, dtype=torch.float32, device=None):
        in_c = self.n_in if self.n_in is not None else input_type.channels
        kh, kw = _pair(self.kernel)
        out_c = in_c * self.depth_multiplier
        params = {"W": initializers.initialize(
            self.weight_init, gen, (kh, kw, 1, out_c), kh * kw,
            kh * kw * self.depth_multiplier, dtype, device)}
        if self.has_bias:
            params["b"] = torch.full((out_c,), self.bias_init, dtype=dtype, device=device)
        return params

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        x = self.maybe_dropout_input(x, train, rng)
        return self._finish(params, self._conv(x, params["W"], groups=x.shape[-1]), state)


@register_layer("separable_conv2d")
@dataclass
class SeparableConv2D(Conv2D):
    """Depthwise then pointwise convolution (SeparableConvolution2D.java):
    ``dW`` [kh, kw, 1, in_c * mult], ``pW`` [1, 1, in_c * mult, n_out]."""

    depth_multiplier: int = 1

    def init(self, gen, input_type, dtype=torch.float32, device=None):
        in_c = self.n_in if self.n_in is not None else input_type.channels
        kh, kw = _pair(self.kernel)
        mid_c = in_c * self.depth_multiplier
        params = {
            "dW": initializers.initialize(self.weight_init, gen, (kh, kw, 1, mid_c),
                                          kh * kw, kh * kw, dtype, device),
            "pW": initializers.initialize(self.weight_init, gen, (1, 1, mid_c, self.n_out),
                                          mid_c, self.n_out, dtype, device),
        }
        if self.has_bias:
            params["b"] = torch.full((self.n_out,), self.bias_init, dtype=dtype, device=device)
        return params

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        x = self.maybe_dropout_input(x, train, rng)
        y = self._conv(x, params["dW"], groups=x.shape[-1])
        y = _nhwc(F.conv2d(_nchw(y), _oihw(params["pW"])))
        return self._finish(params, y, state)


@register_layer("conv1d")
@dataclass
class Conv1D(FeedForwardLayerConfig):
    """1-D convolution over [batch, time, feat] (Convolution1DLayer.java);
    kernel ``W`` [k, in, out]."""

    kernel: int = 3
    stride: int = 1
    padding: int = 0
    dilation: int = 1
    convolution_mode: str = "truncate"
    has_bias: bool = True

    def output_type(self, input_type: InputType) -> InputType:
        t = input_type.timesteps
        ot = None
        if t is not None:
            ot = _out_size(t, int(self.kernel), int(self.stride), int(self.padding),
                           self.convolution_mode, int(self.dilation))
        return InputType.recurrent(self.n_out, ot)

    def init(self, gen, input_type, dtype=torch.float32, device=None):
        in_c = self.n_in if self.n_in is not None else input_type.size
        k = int(self.kernel)
        params = {"W": initializers.initialize(
            self.weight_init, gen, (k, in_c, self.n_out), k * in_c, k * self.n_out,
            dtype, device)}
        if self.has_bias:
            params["b"] = torch.full((self.n_out,), self.bias_init, dtype=dtype, device=device)
        return params

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        x = self.maybe_dropout_input(x, train, rng)
        k, s, d = int(self.kernel), int(self.stride), int(self.dilation)
        xc = x.permute(0, 2, 1)                      # [B, C, T]
        ((lo, hi),) = _spatial_pads(self.convolution_mode, xc.shape[2:], (k,), (s,),
                                    (int(self.padding),), (d,))
        y = F.conv1d(F.pad(xc, (lo, hi)), params["W"].permute(2, 1, 0), stride=s,
                     dilation=d).permute(0, 2, 1)
        if self.has_bias:
            y = y + params["b"]
        return self.activation_fn()(y), state

    def propagate_mask(self, mask, input_type):
        return _subsample_mask_1d(mask, int(self.kernel), int(self.stride),
                                  int(self.padding), self.convolution_mode,
                                  int(self.dilation))


def _subsample_mask_1d(mask, kernel, stride, padding, mode, dilation=1):
    """A [batch, T] mask at the conv/pooled output length: the mask value
    at each output window's start (the reference's stride-based mask
    reduction for 1-D conv and subsampling layers)."""
    if mask is None:
        return None
    T = mask.shape[1]
    ot = -(-T // stride) if mode == "same" else _out_size(T, kernel, stride, padding, mode,
                                                          dilation)
    idx = torch.clamp(torch.arange(ot, device=mask.device) * stride, 0, T - 1)
    return mask[:, idx]


def _pool(xc, pooling: str, kernel, strides, pads, pnorm: int):
    """``reduce_window`` pooling of channels-first ``xc`` [B, C, *spatial]
    (1 or 2 spatial axes) over explicit (before, after) ``pads``."""
    nd = xc.dim() - 2
    out = [(n + lo + hi - k) // st + 1 for n, (lo, hi), k, st in
           zip(xc.shape[2:], pads, kernel, strides)]
    if min(out) <= 0:   # a window wider than the padded input: an empty
        # output, as reduce_window gives (torch's pooling refuses it)
        return xc.new_empty(tuple(xc.shape[:2]) + tuple(max(o, 0) for o in out))
    area = 1
    for k in kernel:
        area *= k
    avg = F.avg_pool1d if nd == 1 else F.avg_pool2d
    if pooling == "max":
        xp = F.pad(xc, _torch_pad(pads), value=float("-inf"))
        return (F.max_pool1d if nd == 1 else F.max_pool2d)(xp, kernel, strides)
    if pooling in ("avg", "mean"):
        return avg(F.pad(xc, _torch_pad(pads)), kernel, strides)
    if pooling == "sum":
        return avg(F.pad(xc, _torch_pad(pads)), kernel, strides) * area
    if pooling == "pnorm":
        p = float(pnorm)
        s = avg(F.pad(torch.abs(xc) ** p, _torch_pad(pads)), kernel, strides) * area
        return s ** (1.0 / p)
    raise ValueError(f"Unknown pooling '{pooling}'")


@register_layer("subsampling2d")
@dataclass
class Subsampling2D(LayerConfig):
    """Spatial pooling (SubsamplingLayer.java): max | avg | sum | pnorm."""

    kernel: Any = (2, 2)
    stride: Any = (2, 2)
    padding: Any = (0, 0)
    pooling: str = "max"
    pnorm: int = 2
    convolution_mode: str = "truncate"

    def output_type(self, input_type: InputType) -> InputType:
        kh, kw = _pair(self.kernel)
        sh, sw = _pair(self.stride)
        ph, pw = _pair(self.padding)
        oh = _out_size(input_type.height, kh, sh, ph, self.convolution_mode)
        ow = _out_size(input_type.width, kw, sw, pw, self.convolution_mode)
        return InputType.convolutional(oh, ow, input_type.channels)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        kernel, strides = _pair(self.kernel), _pair(self.stride)
        xc = _nchw(x)
        pads = _spatial_pads(self.convolution_mode, xc.shape[2:], kernel, strides,
                             _pair(self.padding))
        return _nhwc(_pool(xc, self.pooling, kernel, strides, pads, self.pnorm)), state

    def propagate_mask(self, mask, input_type):
        return None


@register_layer("subsampling1d")
@dataclass
class Subsampling1D(LayerConfig):
    """Temporal pooling over [batch, time, feat] (Subsampling1DLayer.java)."""

    kernel: int = 2
    stride: int = 2
    padding: int = 0
    pooling: str = "max"
    pnorm: int = 2
    convolution_mode: str = "truncate"

    def output_type(self, input_type: InputType) -> InputType:
        t = input_type.timesteps
        ot = None
        if t is not None:
            ot = _out_size(t, int(self.kernel), int(self.stride), int(self.padding),
                           self.convolution_mode)
        return InputType.recurrent(input_type.size, ot)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        k, s = int(self.kernel), int(self.stride)
        xc = x.permute(0, 2, 1)
        pads = _spatial_pads(self.convolution_mode, xc.shape[2:], (k,), (s,),
                             (int(self.padding),))
        return _pool(xc, self.pooling, (k,), (s,), pads, self.pnorm).permute(0, 2, 1), state

    def propagate_mask(self, mask, input_type):
        return _subsample_mask_1d(mask, int(self.kernel), int(self.stride),
                                  int(self.padding), self.convolution_mode)


@register_layer("upsampling2d")
@dataclass
class Upsampling2D(LayerConfig):
    """Nearest-neighbour upsampling (Upsampling2D.java)."""

    size: Any = (2, 2)

    def output_type(self, input_type: InputType) -> InputType:
        sh, sw = _pair(self.size)
        return InputType.convolutional(input_type.height * sh, input_type.width * sw,
                                       input_type.channels)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        sh, sw = _pair(self.size)
        return x.repeat_interleave(sh, dim=1).repeat_interleave(sw, dim=2), state


@register_layer("upsampling1d")
@dataclass
class Upsampling1D(LayerConfig):
    """Temporal nearest-neighbour upsampling over [B, T, F] (Upsampling1D.java)."""

    size: int = 2

    def output_type(self, input_type: InputType) -> InputType:
        t = input_type.timesteps
        return InputType.recurrent(input_type.size,
                                   t * int(self.size) if t is not None else None)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        return x.repeat_interleave(int(self.size), dim=1), state

    def propagate_mask(self, mask, input_type):
        return None if mask is None else mask.repeat_interleave(int(self.size), dim=1)


def _lr(v) -> Tuple[int, int]:
    """(left, right) from a pair or a symmetric int."""
    if isinstance(v, (tuple, list)):
        return int(v[0]), int(v[1])
    return int(v), int(v)


def _tblr(v) -> Tuple[int, int, int, int]:
    """(top, bottom, left, right) from four values or a symmetric (h, w)."""
    if isinstance(v, (tuple, list)) and len(v) == 4:
        return tuple(int(x) for x in v)
    h, w = _pair(v)
    return (h, h, w, w)


@register_layer("zero_padding1d")
@dataclass
class ZeroPadding1D(LayerConfig):
    """Temporal zero padding over [B, T, F] (ZeroPadding1DLayer.java);
    ``padding`` (left, right) or a symmetric int. A mask pads with ones."""

    padding: Any = (1, 1)

    def output_type(self, input_type: InputType) -> InputType:
        l, r = _lr(self.padding)
        t = input_type.timesteps
        return InputType.recurrent(input_type.size, t + l + r if t is not None else None)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        l, r = _lr(self.padding)
        return F.pad(x, (0, 0, l, r)), state

    def propagate_mask(self, mask, input_type):
        if mask is None:
            return None
        l, r = _lr(self.padding)
        return F.pad(mask, (l, r), value=1.0)


@register_layer("cropping1d")
@dataclass
class Cropping1D(LayerConfig):
    """Temporal cropping over [B, T, F] (Cropping1D.java); ``crop`` (left,
    right) or a symmetric int."""

    crop: Any = (0, 0)

    def output_type(self, input_type: InputType) -> InputType:
        l, r = _lr(self.crop)
        t = input_type.timesteps
        return InputType.recurrent(input_type.size, t - l - r if t is not None else None)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        l, r = _lr(self.crop)
        return x[:, l: x.shape[1] - r, :], state

    def propagate_mask(self, mask, input_type):
        if mask is None:
            return None
        l, r = _lr(self.crop)
        return mask[:, l: mask.shape[1] - r]


@register_layer("zero_padding2d")
@dataclass
class ZeroPadding2D(LayerConfig):
    """Explicit spatial zero padding (ZeroPaddingLayer.java); ``padding``
    (top, bottom, left, right) or a symmetric (h, w)."""

    padding: Any = (1, 1, 1, 1)

    def output_type(self, input_type: InputType) -> InputType:
        t, b, l, r = _tblr(self.padding)
        return InputType.convolutional(input_type.height + t + b, input_type.width + l + r,
                                       input_type.channels)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        t, b, l, r = _tblr(self.padding)
        return F.pad(x, (0, 0, l, r, t, b)), state


@register_layer("cropping2d")
@dataclass
class Cropping2D(LayerConfig):
    """Spatial cropping (Cropping2D.java); ``crop`` (top, bottom, left,
    right) or a symmetric (h, w)."""

    CONSUMES_CONV = True

    crop: Any = (0, 0, 0, 0)

    def output_type(self, input_type: InputType) -> InputType:
        t, b, l, r = _tblr(self.crop)
        return InputType.convolutional(input_type.height - t - b, input_type.width - l - r,
                                       input_type.channels)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        t, b, l, r = _tblr(self.crop)
        return x[:, t: x.shape[1] - b, l: x.shape[2] - r, :], state


@register_layer("space_to_depth")
@dataclass
class SpaceToDepth(LayerConfig):
    """[B, H, W, C] -> [B, H/b, W/b, C*b^2] (SpaceToDepthLayer.java)."""

    CONSUMES_CONV = True

    block: int = 2

    def output_type(self, input_type: InputType) -> InputType:
        b = int(self.block)
        if input_type.height % b or input_type.width % b:
            raise ValueError(
                f"SpaceToDepth: spatial dims {input_type.height}x"
                f"{input_type.width} not divisible by block {b}")
        return InputType.convolutional(input_type.height // b, input_type.width // b,
                                       input_type.channels * b * b)

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        b = int(self.block)
        B, H, W, C = x.shape
        y = x.reshape(B, H // b, b, W // b, b, C).permute(0, 1, 3, 2, 4, 5)
        return y.reshape(B, H // b, W // b, b * b * C), state


@register_layer("depth_to_space")
@dataclass
class DepthToSpace(LayerConfig):
    """[B, H, W, C*b^2] -> [B, H*b, W*b, C], SpaceToDepth's inverse."""

    CONSUMES_CONV = True

    block: int = 2

    def output_type(self, input_type: InputType) -> InputType:
        b = int(self.block)
        if input_type.channels % (b * b):
            raise ValueError(
                f"DepthToSpace: channels {input_type.channels} not divisible "
                f"by block^2 {b * b}")
        return InputType.convolutional(input_type.height * b, input_type.width * b,
                                       input_type.channels // (b * b))

    def apply(self, params, state, x, *, train=False, rng=None, mask=None):
        b = int(self.block)
        B, H, W, C = x.shape
        y = x.reshape(B, H, W, b, b, C // (b * b)).permute(0, 1, 3, 2, 4, 5)
        return y.reshape(B, H * b, W * b, C // (b * b)), state
