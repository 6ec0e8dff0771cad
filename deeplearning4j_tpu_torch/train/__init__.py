"""Training (PyTorch port of ``deeplearning4j_tpu/train``).

- ``updaters`` — the 10 updaters, LR schedules, gradient normalization;
- ``listeners`` — the training-listener hooks and ``ProfilerListener``;
- ``resilience`` — durable checkpoints, exact resume, the divergence guard
  and the chaos harness; ``checkpoint`` — ``CheckpointListener``;
- ``solvers`` — line search, conjugate gradient, L-BFGS;
- ``earlystopping`` — termination conditions, score calculators, savers,
  ``EarlyStoppingTrainer``;
- ``pretrain`` — layerwise pretraining of AutoEncoder and VAE layers;
- ``elastic`` — ``ElasticTrainer``, elastic data-parallel training over
  the membership runtime, and its CLI (``python -m
  deeplearning4j_tpu_torch.train.elastic worker|launch``);
- ``__main__`` — the trainer CLI, ``python -m deeplearning4j_tpu_torch.train``.
"""


def __getattr__(name):
    # lazy: train.elastic pulls in the parallel package, whose modules reach
    # back into nn.model — an eager import here would cycle
    if name == "ElasticTrainer":
        from deeplearning4j_tpu_torch.train.elastic import ElasticTrainer

        return ElasticTrainer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
