"""Training (PyTorch port of ``deeplearning4j_tpu/train``).

- ``updaters`` — the 10 updaters, LR schedules, gradient normalization;
- ``listeners`` — the training-listener hooks and ``ProfilerListener``;
- ``resilience`` — durable checkpoints, exact resume, the divergence guard
  and the chaos harness; ``checkpoint`` — ``CheckpointListener``;
- ``solvers`` — line search, conjugate gradient, L-BFGS;
- ``earlystopping`` — termination conditions, score calculators, savers,
  ``EarlyStoppingTrainer``;
- ``pretrain`` — layerwise pretraining of AutoEncoder and VAE layers;
- ``__main__`` — the trainer CLI, ``python -m deeplearning4j_tpu_torch.train``.

The elastic trainer arrives with the parallel slice.
"""
