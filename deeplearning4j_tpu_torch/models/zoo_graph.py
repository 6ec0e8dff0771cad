"""The zoo's image architectures (PyTorch port of
``models/zoo_graph.py``): AlexNet, VGG16, VGG19, ResNet50, GoogLeNet,
Darknet19, TinyYOLO, InceptionResNetV1 and FaceNetNN4Small2
(deeplearning4j-zoo's zoo/model/*.java). Sequential nets return a
MultiLayerConfiguration, the DAG nets (ResNet50, GoogLeNet,
InceptionResNetV1, FaceNet) a ComputationGraphConfiguration; each builds
the same configuration, and so the same JSON, as the JAX package's. All
NHWC, all plain configuration data.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from deeplearning4j_tpu_torch.nn.graph import (
    ComputationGraphConfiguration,
    ElementWiseVertex,
    MergeVertex,
)
from deeplearning4j_tpu_torch.nn.input_type import InputType
from deeplearning4j_tpu_torch.nn.layers import (
    ActivationLayer,
    BatchNorm,
    Conv2D,
    Dense,
    DropoutLayer,
    GlobalPooling,
    LocalResponseNormalization,
    OutputLayer,
    SpaceToDepth,
    Subsampling2D,
    Yolo2OutputLayer,
    ZeroPadding2D,
)
from deeplearning4j_tpu_torch.nn.model import MultiLayerConfiguration


def AlexNet(height: int = 224, width: int = 224, channels: int = 3,
            num_classes: int = 1000, updater=None, seed: int = 12345,
            dtype: str = "float32") -> MultiLayerConfiguration:
    """AlexNet (zoo/model/AlexNet.java): 5 conv + LRN + 3 dense."""
    return MultiLayerConfiguration(
        layers=(
            Conv2D(n_out=96, kernel=(11, 11), stride=(4, 4), activation="relu"),
            LocalResponseNormalization(),
            Subsampling2D(kernel=(3, 3), stride=(2, 2)),
            Conv2D(n_out=256, kernel=(5, 5), stride=(1, 1), convolution_mode="same",
                   activation="relu"),
            LocalResponseNormalization(),
            Subsampling2D(kernel=(3, 3), stride=(2, 2)),
            Conv2D(n_out=384, kernel=(3, 3), convolution_mode="same", activation="relu"),
            Conv2D(n_out=384, kernel=(3, 3), convolution_mode="same", activation="relu"),
            Conv2D(n_out=256, kernel=(3, 3), convolution_mode="same", activation="relu"),
            Subsampling2D(kernel=(3, 3), stride=(2, 2)),
            Dense(n_out=4096, activation="relu", dropout=0.5),
            Dense(n_out=4096, activation="relu", dropout=0.5),
            OutputLayer(n_out=num_classes, activation="softmax", loss="mcxent"),
        ),
        input_type=InputType.convolutional(height, width, channels),
        updater=updater or {"type": "nesterov", "lr": 1e-2, "momentum": 0.9},
        seed=seed, dtype=dtype,
    )


def _vgg_block(layers, n_convs: int, n_out: int, batch_norm: bool = False):
    for _ in range(n_convs):
        if batch_norm:
            layers.append(Conv2D(n_out=n_out, kernel=(3, 3),
                                 convolution_mode="same",
                                 activation="identity", has_bias=False))
            layers.append(BatchNorm())
            layers.append(ActivationLayer(activation="relu"))
        else:
            layers.append(Conv2D(n_out=n_out, kernel=(3, 3),
                                 convolution_mode="same", activation="relu"))
    layers.append(Subsampling2D(kernel=(2, 2), stride=(2, 2)))


def VGG16(height: int = 224, width: int = 224, channels: int = 3,
          num_classes: int = 1000, updater=None, seed: int = 12345,
          dtype: str = "float32", batch_norm: bool = False,
          fc_dropout: float = 0.0,
          fc_width: int = 4096) -> MultiLayerConfiguration:
    """VGG-16 (zoo/model/VGG16.java).

    ``batch_norm=True`` inserts BatchNorm after every conv (the torchvision
    vgg16_bn variant); ``fc_dropout`` enables the classifier dropout the
    reference ships commented out (VGG16.java:147-149); ``fc_width``
    shrinks the classifier for small inputs/tests (reference: 4096)."""
    layers: list = []
    for n_convs, width_ in ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512)):
        _vgg_block(layers, n_convs, width_, batch_norm=batch_norm)
    layers += [
        Dense(n_out=fc_width, activation="relu", dropout=fc_dropout),
        Dense(n_out=fc_width, activation="relu", dropout=fc_dropout),
        OutputLayer(n_out=num_classes, activation="softmax", loss="mcxent"),
    ]
    return MultiLayerConfiguration(
        layers=tuple(layers),
        input_type=InputType.convolutional(height, width, channels),
        updater=updater or {"type": "nesterov", "lr": 1e-2, "momentum": 0.9},
        seed=seed, dtype=dtype,
    )


def VGG19(height: int = 224, width: int = 224, channels: int = 3,
          num_classes: int = 1000, updater=None, seed: int = 12345,
          dtype: str = "float32") -> MultiLayerConfiguration:
    """VGG-19 (zoo/model/VGG19.java)."""
    layers: list = []
    for n_convs, width_ in ((2, 64), (2, 128), (4, 256), (4, 512), (4, 512)):
        _vgg_block(layers, n_convs, width_)
    layers += [
        Dense(n_out=4096, activation="relu"),
        Dense(n_out=4096, activation="relu"),
        OutputLayer(n_out=num_classes, activation="softmax", loss="mcxent"),
    ]
    return MultiLayerConfiguration(
        layers=tuple(layers),
        input_type=InputType.convolutional(height, width, channels),
        updater=updater or {"type": "nesterov", "lr": 1e-2, "momentum": 0.9},
        seed=seed, dtype=dtype,
    )


# ---------------------------------------------------------------------------
# ResNet-50 (DAG)
# ---------------------------------------------------------------------------

def _conv_bn(g, name: str, inp: str, n_out: int, kernel, stride=(1, 1),
             mode: str = "same", act: str = "relu") -> str:
    g.add_layer(f"{name}_conv", Conv2D(n_out=n_out, kernel=tuple(kernel),
                                       stride=tuple(stride), convolution_mode=mode,
                                       activation="identity", has_bias=False), inp)
    g.add_layer(f"{name}_bn", BatchNorm(), f"{name}_conv")
    if act != "identity":
        g.add_layer(f"{name}_act", ActivationLayer(activation=act), f"{name}_bn")
        return f"{name}_act"
    return f"{name}_bn"


def _bottleneck(g, name: str, inp: str, filters: Tuple[int, int, int],
                stride=(1, 1), downsample: bool = False) -> str:
    f1, f2, f3 = filters
    a = _conv_bn(g, f"{name}_a", inp, f1, (1, 1), stride)
    b = _conv_bn(g, f"{name}_b", a, f2, (3, 3))
    c = _conv_bn(g, f"{name}_c", b, f3, (1, 1), act="identity")
    if downsample:
        short = _conv_bn(g, f"{name}_ds", inp, f3, (1, 1), stride, act="identity")
    else:
        short = inp
    g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), c, short)
    g.add_layer(f"{name}_out", ActivationLayer(activation="relu"), f"{name}_add")
    return f"{name}_out"


def ResNet50(height: int = 224, width: int = 224, channels: int = 3,
             num_classes: int = 1000, updater=None, seed: int = 12345,
             dtype: str = "float32", stem: str = "conv7") -> ComputationGraphConfiguration:
    """ResNet-50 (zoo/model/ResNet50.java): conv7 + 3/4/6/3 bottleneck stages.
    BASELINE config #2.

    ``stem="conv7"`` is the reference-faithful 7x7/s2 stem.
    ``stem="space_to_depth"`` is the MLPerf-style variant: SpaceToDepth(2)
    + a 4x4/s1 conv, the same output shape with a contraction dim of
    4*4*(4*channels) instead of 7*7*channels. A different parameter layout:
    checkpoints are not interchangeable between stems."""
    g = (ComputationGraphConfiguration.builder()
         .add_inputs("in")
         .set_input_types(InputType.convolutional(height, width, channels)))
    if stem == "space_to_depth":
        g.add_layer("stem_s2d", SpaceToDepth(block=2), "in")
        stem_v = _conv_bn(g, "stem", "stem_s2d", 64, (4, 4), (1, 1))
    elif stem == "conv7":
        stem_v = _conv_bn(g, "stem", "in", 64, (7, 7), (2, 2))
    else:
        raise ValueError(f"stem must be 'conv7' or 'space_to_depth', got {stem!r}")
    g.add_layer("stem_pool", Subsampling2D(kernel=(3, 3), stride=(2, 2),
                                           convolution_mode="same"), stem_v)
    x = "stem_pool"
    stages = [
        ("s2", (64, 64, 256), 3, (1, 1)),
        ("s3", (128, 128, 512), 4, (2, 2)),
        ("s4", (256, 256, 1024), 6, (2, 2)),
        ("s5", (512, 512, 2048), 3, (2, 2)),
    ]
    for sname, filters, blocks, stride in stages:
        x = _bottleneck(g, f"{sname}b1", x, filters, stride, downsample=True)
        for i in range(1, blocks):
            x = _bottleneck(g, f"{sname}b{i + 1}", x, filters)
    g.add_layer("avgpool", GlobalPooling(pooling="avg"), x)
    g.add_layer("out", OutputLayer(n_out=num_classes, activation="softmax",
                                   loss="mcxent"), "avgpool")
    g.set_outputs("out")
    g.updater(updater or {"type": "adam", "lr": 1e-3})
    conf = g.build()
    conf.seed = seed
    conf.dtype = dtype
    return conf


# ---------------------------------------------------------------------------
# GoogLeNet / Inception-v1 (DAG)
# ---------------------------------------------------------------------------

def _inception(g, name: str, inp: str, f1: int, f3r: int, f3: int,
               f5r: int, f5: int, fp: int) -> str:
    g.add_layer(f"{name}_1x1", Conv2D(n_out=f1, kernel=(1, 1), activation="relu",
                                      convolution_mode="same"), inp)
    g.add_layer(f"{name}_3x3r", Conv2D(n_out=f3r, kernel=(1, 1), activation="relu",
                                       convolution_mode="same"), inp)
    g.add_layer(f"{name}_3x3", Conv2D(n_out=f3, kernel=(3, 3), activation="relu",
                                      convolution_mode="same"), f"{name}_3x3r")
    g.add_layer(f"{name}_5x5r", Conv2D(n_out=f5r, kernel=(1, 1), activation="relu",
                                       convolution_mode="same"), inp)
    g.add_layer(f"{name}_5x5", Conv2D(n_out=f5, kernel=(5, 5), activation="relu",
                                      convolution_mode="same"), f"{name}_5x5r")
    g.add_layer(f"{name}_pool", Subsampling2D(kernel=(3, 3), stride=(1, 1),
                                              convolution_mode="same"), inp)
    g.add_layer(f"{name}_poolproj", Conv2D(n_out=fp, kernel=(1, 1), activation="relu",
                                           convolution_mode="same"), f"{name}_pool")
    g.add_vertex(f"{name}_merge", MergeVertex(),
                 f"{name}_1x1", f"{name}_3x3", f"{name}_5x5", f"{name}_poolproj")
    return f"{name}_merge"


def GoogLeNet(height: int = 224, width: int = 224, channels: int = 3,
              num_classes: int = 1000, updater=None, seed: int = 12345,
              dtype: str = "float32") -> ComputationGraphConfiguration:
    """GoogLeNet / Inception-v1 (zoo/model/GoogLeNet.java): 9 inception
    modules (aux classifiers omitted, as in the reference's zoo model)."""
    g = (ComputationGraphConfiguration.builder()
         .add_inputs("in")
         .set_input_types(InputType.convolutional(height, width, channels)))
    g.add_layer("c1", Conv2D(n_out=64, kernel=(7, 7), stride=(2, 2), activation="relu",
                             convolution_mode="same"), "in")
    g.add_layer("p1", Subsampling2D(kernel=(3, 3), stride=(2, 2),
                                    convolution_mode="same"), "c1")
    g.add_layer("n1", LocalResponseNormalization(), "p1")
    g.add_layer("c2r", Conv2D(n_out=64, kernel=(1, 1), activation="relu",
                              convolution_mode="same"), "n1")
    g.add_layer("c2", Conv2D(n_out=192, kernel=(3, 3), activation="relu",
                             convolution_mode="same"), "c2r")
    g.add_layer("n2", LocalResponseNormalization(), "c2")
    g.add_layer("p2", Subsampling2D(kernel=(3, 3), stride=(2, 2),
                                    convolution_mode="same"), "n2")
    x = _inception(g, "i3a", "p2", 64, 96, 128, 16, 32, 32)
    x = _inception(g, "i3b", x, 128, 128, 192, 32, 96, 64)
    g.add_layer("p3", Subsampling2D(kernel=(3, 3), stride=(2, 2),
                                    convolution_mode="same"), x)
    x = _inception(g, "i4a", "p3", 192, 96, 208, 16, 48, 64)
    x = _inception(g, "i4b", x, 160, 112, 224, 24, 64, 64)
    x = _inception(g, "i4c", x, 128, 128, 256, 24, 64, 64)
    x = _inception(g, "i4d", x, 112, 144, 288, 32, 64, 64)
    x = _inception(g, "i4e", x, 256, 160, 320, 32, 128, 128)
    g.add_layer("p4", Subsampling2D(kernel=(3, 3), stride=(2, 2),
                                    convolution_mode="same"), x)
    x = _inception(g, "i5a", "p4", 256, 160, 320, 32, 128, 128)
    x = _inception(g, "i5b", x, 384, 192, 384, 48, 128, 128)
    g.add_layer("avgpool", GlobalPooling(pooling="avg"), x)
    g.add_layer("drop", DropoutLayer(dropout=0.4), "avgpool")
    g.add_layer("out", OutputLayer(n_out=num_classes, activation="softmax",
                                   loss="mcxent"), "drop")
    g.set_outputs("out")
    g.updater(updater or {"type": "adam", "lr": 1e-3})
    conf = g.build()
    conf.seed = seed
    conf.dtype = dtype
    return conf


# ---------------------------------------------------------------------------
# Darknet19 / TinyYOLO
# ---------------------------------------------------------------------------

def _dark_conv(n_out: int, kernel=(3, 3)) -> Tuple:
    return (
        Conv2D(n_out=n_out, kernel=tuple(kernel), convolution_mode="same",
               activation="identity", has_bias=False),
        BatchNorm(),
        ActivationLayer(activation="leakyrelu"),
    )


def Darknet19(height: int = 224, width: int = 224, channels: int = 3,
              num_classes: int = 1000, updater=None, seed: int = 12345,
              dtype: str = "float32") -> MultiLayerConfiguration:
    """Darknet-19 (zoo/model/Darknet19.java): 19 conv layers, BN + leaky relu."""
    L: list = []
    pool = lambda: Subsampling2D(kernel=(2, 2), stride=(2, 2))
    L += _dark_conv(32); L.append(pool())
    L += _dark_conv(64); L.append(pool())
    L += _dark_conv(128); L += _dark_conv(64, (1, 1)); L += _dark_conv(128); L.append(pool())
    L += _dark_conv(256); L += _dark_conv(128, (1, 1)); L += _dark_conv(256); L.append(pool())
    L += _dark_conv(512); L += _dark_conv(256, (1, 1)); L += _dark_conv(512)
    L += _dark_conv(256, (1, 1)); L += _dark_conv(512); L.append(pool())
    L += _dark_conv(1024); L += _dark_conv(512, (1, 1)); L += _dark_conv(1024)
    L += _dark_conv(512, (1, 1)); L += _dark_conv(1024)
    L.append(Conv2D(n_out=num_classes, kernel=(1, 1), convolution_mode="same",
                    activation="identity"))
    L.append(GlobalPooling(pooling="avg"))
    from deeplearning4j_tpu_torch.nn.layers import LossLayer

    L.append(LossLayer(activation="softmax", loss="mcxent"))
    return MultiLayerConfiguration(
        layers=tuple(L),
        input_type=InputType.convolutional(height, width, channels),
        updater=updater or {"type": "nesterov", "lr": 1e-3, "momentum": 0.9},
        seed=seed, dtype=dtype,
    )


TINY_YOLO_ANCHORS = ((1.08, 1.19), (3.42, 4.41), (6.63, 11.38),
                     (9.42, 5.11), (16.62, 10.52))


def TinyYOLO(height: int = 416, width: int = 416, channels: int = 3,
             num_classes: int = 20, anchors=TINY_YOLO_ANCHORS, updater=None,
             seed: int = 12345, dtype: str = "float32") -> MultiLayerConfiguration:
    """TinyYOLO v2 (zoo/model/TinyYOLO.java): darknet-tiny backbone + YOLO2
    detection head over a 13x13 grid (for 416 input)."""
    L: list = []
    pool = lambda: Subsampling2D(kernel=(2, 2), stride=(2, 2))
    for n in (16, 32, 64, 128, 256):
        L += _dark_conv(n)
        L.append(pool())
    L += _dark_conv(512)
    L.append(Subsampling2D(kernel=(2, 2), stride=(1, 1), convolution_mode="same"))
    L += _dark_conv(1024)
    L += _dark_conv(1024)
    n_anchors = len(anchors)
    L.append(Conv2D(n_out=n_anchors * (5 + num_classes), kernel=(1, 1),
                    convolution_mode="same", activation="identity"))
    L.append(Yolo2OutputLayer(boxes=tuple(tuple(a) for a in anchors)))
    return MultiLayerConfiguration(
        layers=tuple(L),
        input_type=InputType.convolutional(height, width, channels),
        updater=updater or {"type": "adam", "lr": 1e-3},
        seed=seed, dtype=dtype,
    )


# ---------------------------------------------------------------------------
# InceptionResNetV1 / FaceNetNN4Small2 (face embedding nets)
# ---------------------------------------------------------------------------

def _ir_block(g, name: str, inp: str, scale_filters: Sequence[Tuple[int, tuple]],
              n_out: int) -> str:
    """Inception-resnet residual block: parallel conv towers → 1x1 projection
    → residual add → relu."""
    towers = []
    for ti, tower in enumerate(scale_filters):
        prev = inp
        for li, (f, k) in enumerate(tower):
            lname = f"{name}_t{ti}_{li}"
            g.add_layer(lname, Conv2D(n_out=f, kernel=tuple(k), activation="relu",
                                      convolution_mode="same"), prev)
            prev = lname
        towers.append(prev)
    g.add_vertex(f"{name}_cat", MergeVertex(), *towers)
    g.add_layer(f"{name}_proj", Conv2D(n_out=n_out, kernel=(1, 1),
                                       activation="identity",
                                       convolution_mode="same"), f"{name}_cat")
    g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), f"{name}_proj", inp)
    g.add_layer(f"{name}_out", ActivationLayer(activation="relu"), f"{name}_add")
    return f"{name}_out"


def InceptionResNetV1(height: int = 160, width: int = 160, channels: int = 3,
                      num_classes: int = 1001, embedding_size: int = 128,
                      n_blocks: Tuple[int, int, int] = (5, 10, 5),
                      updater=None, seed: int = 12345,
                      dtype: str = "float32") -> ComputationGraphConfiguration:
    """Inception-ResNet-v1 (zoo/model/InceptionResNetV1.java): stem +
    A/B/C residual inception stages + embedding + softmax head."""
    g = (ComputationGraphConfiguration.builder()
         .add_inputs("in")
         .set_input_types(InputType.convolutional(height, width, channels)))
    g.add_layer("stem1", Conv2D(n_out=32, kernel=(3, 3), stride=(2, 2),
                                activation="relu", convolution_mode="same"), "in")
    g.add_layer("stem2", Conv2D(n_out=64, kernel=(3, 3), activation="relu",
                                convolution_mode="same"), "stem1")
    g.add_layer("stem_pool", Subsampling2D(kernel=(3, 3), stride=(2, 2),
                                           convolution_mode="same"), "stem2")
    g.add_layer("stem3", Conv2D(n_out=128, kernel=(3, 3), stride=(2, 2),
                                activation="relu", convolution_mode="same"), "stem_pool")
    x = "stem3"
    for i in range(n_blocks[0]):  # block35 ("A")
        x = _ir_block(g, f"a{i}", x, [[(32, (1, 1))], [(32, (1, 1)), (32, (3, 3))],
                                      [(32, (1, 1)), (32, (3, 3)), (32, (3, 3))]], 128)
    g.add_layer("red_a", Conv2D(n_out=256, kernel=(3, 3), stride=(2, 2),
                                activation="relu", convolution_mode="same"), x)
    x = "red_a"
    for i in range(n_blocks[1]):  # block17 ("B")
        x = _ir_block(g, f"b{i}", x, [[(64, (1, 1))],
                                      [(64, (1, 1)), (64, (1, 7)), (64, (7, 1))]], 256)
    g.add_layer("red_b", Conv2D(n_out=512, kernel=(3, 3), stride=(2, 2),
                                activation="relu", convolution_mode="same"), x)
    x = "red_b"
    for i in range(n_blocks[2]):  # block8 ("C")
        x = _ir_block(g, f"c{i}", x, [[(128, (1, 1))],
                                      [(128, (1, 1)), (128, (1, 3)), (128, (3, 1))]], 512)
    g.add_layer("avgpool", GlobalPooling(pooling="avg"), x)
    g.add_layer("embedding", Dense(n_out=embedding_size, activation="identity"), "avgpool")
    g.add_layer("out", OutputLayer(n_out=num_classes, activation="softmax",
                                   loss="mcxent"), "embedding")
    g.set_outputs("out")
    g.updater(updater or {"type": "rmsprop", "lr": 1e-3})
    conf = g.build()
    conf.seed = seed
    conf.dtype = dtype
    return conf


def FaceNetNN4Small2(height: int = 96, width: int = 96, channels: int = 3,
                     num_classes: int = 1001, embedding_size: int = 128,
                     updater=None, seed: int = 12345,
                     dtype: str = "float32") -> ComputationGraphConfiguration:
    """FaceNet NN4-small2 (zoo/model/FaceNetNN4Small2.java): inception-style
    face embedding net (center-loss head in the reference's helper variant —
    use CenterLossOutputLayer via transfer surgery if needed)."""
    g = (ComputationGraphConfiguration.builder()
         .add_inputs("in")
         .set_input_types(InputType.convolutional(height, width, channels)))
    g.add_layer("c1", Conv2D(n_out=64, kernel=(7, 7), stride=(2, 2), activation="relu",
                             convolution_mode="same"), "in")
    g.add_layer("p1", Subsampling2D(kernel=(3, 3), stride=(2, 2),
                                    convolution_mode="same"), "c1")
    g.add_layer("n1", LocalResponseNormalization(), "p1")
    g.add_layer("c2r", Conv2D(n_out=64, kernel=(1, 1), activation="relu",
                              convolution_mode="same"), "n1")
    g.add_layer("c2", Conv2D(n_out=192, kernel=(3, 3), activation="relu",
                             convolution_mode="same"), "c2r")
    g.add_layer("n2", LocalResponseNormalization(), "c2")
    g.add_layer("p2", Subsampling2D(kernel=(3, 3), stride=(2, 2),
                                    convolution_mode="same"), "n2")
    x = _inception(g, "i3a", "p2", 64, 96, 128, 16, 32, 32)
    x = _inception(g, "i3b", x, 64, 96, 128, 32, 64, 64)
    g.add_layer("p3", Subsampling2D(kernel=(3, 3), stride=(2, 2),
                                    convolution_mode="same"), x)
    x = _inception(g, "i4a", "p3", 256, 96, 192, 32, 64, 128)
    x = _inception(g, "i4e", x, 160, 112, 224, 24, 64, 64)
    g.add_layer("p4", Subsampling2D(kernel=(3, 3), stride=(2, 2),
                                    convolution_mode="same"), x)
    x = _inception(g, "i5a", "p4", 256, 96, 384, 32, 128, 128)
    x = _inception(g, "i5b", x, 256, 96, 384, 32, 128, 128)
    g.add_layer("avgpool", GlobalPooling(pooling="avg"), x)
    g.add_layer("embedding", Dense(n_out=embedding_size, activation="identity"), "avgpool")
    g.add_layer("out", OutputLayer(n_out=num_classes, activation="softmax",
                                   loss="mcxent"), "embedding")
    g.set_outputs("out")
    g.updater(updater or {"type": "adam", "lr": 1e-3})
    conf = g.build()
    conf.seed = seed
    conf.dtype = dtype
    return conf
