"""graftlint fixture: monotonic-clock true positives."""

import time


def age(t0):
    return time.time() - t0                 # BAD: wall clock in arithmetic


def elapsed(t0):
    return time.monotonic() - t0            # OK


def stamp():
    return {"at": time.time()}              # OK: a value, not a duration
