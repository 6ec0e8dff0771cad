"""graftlint fixture: tuner-off-hot-path true positives."""

from graftlint_torch.nn import aot
from graftlint_torch.tune.search import run_trial


def fit_and_tune(model, x):
    fn = aot.site(model, "fixture.step", model.forward)
    run_trial({"x": x})                     # BAD: a trial per batch
    return fn(x)


def offline(spec):
    return run_trial(spec)                  # OK: not on a dispatch path
