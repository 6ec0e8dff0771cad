"""graftlint fixture: the counting pass (names as the port's)."""


def count_pass(fn, device=None, dtype=""):
    return fn(), {}
