"""Zoo architectures ported so far."""

from deeplearning4j_tpu_torch.models.zoo import (
    LeNet5,
    SimpleCNN,
    TextGenerationLSTM,
    TransformerLM,
)

__all__ = ["LeNet5", "SimpleCNN", "TextGenerationLSTM", "TransformerLM"]
