"""graftlint fixture: lock-discipline true positives (host-only)."""

import threading

from graftlint_torch.nn import aot

_REGISTRY = {}
_LOCK = threading.Lock()


def register(name, value):
    _REGISTRY[name] = value                 # BAD: no lock held


def register_locked(name, value):
    with _LOCK:
        _REGISTRY[name] = value             # OK


class Worker:
    def __init__(self, model):
        self._fn = aot.site(model, "fixture.locked", model.forward)
        self._lock = threading.Lock()

    def step(self, x):
        with self._lock:
            return self._fn(x).item()       # BAD: a sync under the lock

    def step_released(self, x):
        with self._lock:
            batch = list(x)
        return self._fn(batch)              # OK
