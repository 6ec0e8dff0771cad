"""graftlint fixture: jit-purity true positives in traced (rerun) bodies."""

import random
import time

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

_CALLS = []


class Noisy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.t = time.time()                      # BAD: wall clock
        return x + torch.rand(x.shape)           # BAD: global generator

    @staticmethod
    def backward(ctx, g):
        _CALLS.append(1)                         # BAD: module-state write
        return g * random.random()               # BAD: Python random


class Seeded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gen):
        return x + torch.rand(x.shape, generator=gen)   # OK: its own generator

    @staticmethod
    def backward(ctx, g):
        return g, None


def remat_body(x):
    return x * float(np.random.rand())           # BAD: global np.random


def block(x):
    return checkpoint(remat_body, x, use_reentrant=False)


def suppressed_body(x):
    return x + torch.randn(x.shape)  # graftlint: disable=jit-purity


def block2(x):
    return checkpoint(suppressed_body, x, use_reentrant=False)
