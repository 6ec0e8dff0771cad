"""graftlint fixture: step-wiring true positives.

Lives under ``nn/``: the rule patrols ``nn/`` and ``parallel/``, where an
in-place update outside the step's modules forks the step."""

import torch


def hand_rolled_update(params, grads, lr):
    with torch.no_grad():
        for p, g in zip(params, grads):
            p.sub_(lr * g)                  # BAD: a second update path


def copy_back(params, values):
    with torch.no_grad():
        for p, v in zip(params, values):
            p.copy_(v)  # graftlint: disable=step-wiring


def not_an_update(params, grads):
    for p, g in zip(params, grads):
        p.add_(g)                           # OK: no torch.no_grad() block
