"""graftlint fixture: the step's own module (allowed to update in place)."""

import torch


def update(params, grads, lr):
    with torch.no_grad():
        for p, g in zip(params, grads):
            p.sub_(lr * g)                  # OK: the step lives here
