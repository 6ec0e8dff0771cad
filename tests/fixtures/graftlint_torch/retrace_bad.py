"""graftlint fixture: retrace-hazard true positives (new signatures per
call, raw library loads, traced bodies reading mutated module state)."""

import ctypes

import torch

from graftlint_torch.nn import aot
from graftlint_torch.nn.aot import AotFunction
from graftlint_torch.ops import _build

_SCALE = {}
_CONST = {"scale": 2.0}


def per_batch_wrappers(model, batches):
    for b in batches:
        fn = aot.wrap(model.forward, "fixture.loop", model)   # BAD: fresh table
        fn(b)


def built_and_called(model, x):
    return AotFunction(model.forward, "fixture.once")(x)     # BAD


def site_lookups(model, batches):
    for b in batches:
        aot.site(model, "fixture.out", model.forward)(b)     # OK: the model's site


def raw_library(path):
    return ctypes.CDLL(path)                                 # BAD: no cache


def cached_library(name):
    return _build.load(name)                                 # OK


def set_scale(v):
    _SCALE["v"] = v


class Scaled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x * _SCALE.get("v", 1.0)                      # BAD: mutated global

    @staticmethod
    def backward(ctx, g):
        return g * _CONST["scale"]                           # OK: never mutated
