"""Zoo architectures, pretrained-weight loading and class labels (PyTorch
port of ``deeplearning4j_tpu/models``)."""

from deeplearning4j_tpu_torch.models.labels import (
    BaseLabels,
    DarknetLabels,
    ImageNetLabels,
    VOCLabels,
)
from deeplearning4j_tpu_torch.models.pretrained import init_pretrained, pretrained_path
from deeplearning4j_tpu_torch.models.zoo import (
    LeNet5,
    SimpleCNN,
    TextGenerationLSTM,
    TransformerLM,
)
from deeplearning4j_tpu_torch.models.zoo_graph import (
    VGG16,
    VGG19,
    AlexNet,
    Darknet19,
    FaceNetNN4Small2,
    GoogLeNet,
    InceptionResNetV1,
    ResNet50,
    TinyYOLO,
)

__all__ = ["AlexNet", "Darknet19", "FaceNetNN4Small2", "GoogLeNet", "InceptionResNetV1",
           "LeNet5", "ResNet50", "SimpleCNN", "TextGenerationLSTM", "TinyYOLO",
           "TransformerLM", "VGG16", "VGG19", "init_pretrained", "pretrained_path",
           "BaseLabels", "ImageNetLabels", "DarknetLabels", "VOCLabels"]
