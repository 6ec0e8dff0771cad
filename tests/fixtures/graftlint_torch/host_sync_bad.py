"""graftlint fixture: host-sync true positives in the dispatch path."""

import numpy as np
import torch

from graftlint_torch.nn import aot
from graftlint_torch.ops import _build


class Server:
    def __init__(self, model):
        self.model = model
        self._fn = aot.site(model, "fixture.output", model.forward)

    def serve_item(self, x):
        return self._fn(x).item()               # BAD: a sync per call

    def serve_tolist(self, x):
        out = self._fn(x)
        return out.tolist()                     # BAD

    def serve_cpu(self, x):
        return self._fn(x).cpu()                # BAD: a copy to the host

    def serve_to_cpu(self, x):
        out = self._fn(x)
        return out.to("cpu")                    # BAD

    def serve_asarray(self, x):
        out = self._fn(x)
        return np.asarray(out)                  # BAD

    def serve_float(self, x):
        return float(self._fn(x).sum())         # BAD

    def serve_synchronize(self, x):
        out = self._fn(x)
        torch.cuda.synchronize()                # BAD
        return out

    def serve_mask(self, x):
        out = self._fn(x)
        return out[out > 0]                     # BAD: data-dependent shape

    def serve_nonzero(self, x):
        out = self._fn(x)
        return out.nonzero()                    # BAD

    def serve_clean(self, x):
        return self._fn(x) * 2                  # OK: stays on the device

    def serve_suppressed(self, x):
        return self._fn(x).item()  # graftlint: disable=host-sync


def launch(x):
    lib = _build.load("fixture_kernel")
    out = torch.empty_like(x)
    lib.run(x.data_ptr(), out.data_ptr())
    return out.sum().item()                     # BAD: a kernel wrapper syncs


def not_hot(x):
    return x.sum().item()                       # OK: reaches no dispatch
