"""graftlint fixture: the tuner's trial entry point."""


def run_trial(spec):
    return spec
