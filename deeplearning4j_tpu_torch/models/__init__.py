"""Zoo architectures ported so far."""

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
           "TransformerLM", "VGG16", "VGG19"]
