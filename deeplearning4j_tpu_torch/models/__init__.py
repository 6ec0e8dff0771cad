"""Zoo architectures ported so far."""

from deeplearning4j_tpu_torch.models.zoo import TextGenerationLSTM, TransformerLM

__all__ = ["TextGenerationLSTM", "TransformerLM"]
