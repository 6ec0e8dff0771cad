"""Training (PyTorch port of ``deeplearning4j_tpu/train``).

- ``updaters`` — the 10 updaters, LR schedules, gradient normalization;
- ``listeners`` — the training-listener hooks;
- ``__main__`` — the trainer CLI, ``python -m deeplearning4j_tpu_torch.train``.

Checkpoint listeners, resilience (divergence guard, chaos, resume), early
stopping and the elastic trainer arrive with later slices.
"""
