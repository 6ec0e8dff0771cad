"""graftlint fixture: numpy-on-tracer true positives."""

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint


def body(x):
    return np.exp(x)                    # BAD: raises on a CUDA tensor


def body_ok(x):
    n = np.shape(x)[0]                  # OK: metadata only
    return torch.exp(x) * n


def run(x):
    return checkpoint(body, x, use_reentrant=False) + checkpoint(
        body_ok, x, use_reentrant=False)
