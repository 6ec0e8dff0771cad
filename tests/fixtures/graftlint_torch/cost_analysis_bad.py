"""graftlint fixture: cost-analysis-off-hot-path true positives."""

from torch.utils.flop_counter import FlopCounterMode

from graftlint_torch.nn import aot
from graftlint_torch.obs.profile import count_pass


def serve_priced(model, x):
    fn = aot.site(model, "fixture.priced", model.forward)
    out, cost = count_pass(lambda: fn(x))   # BAD: a counting pass per call
    return out


def serve_flops(model, x):
    fn = aot.site(model, "fixture.flops", model.forward)
    with FlopCounterMode(display=False):    # BAD
        return fn(x)


def report(fn):
    return count_pass(fn)                   # OK: not on a dispatch path
