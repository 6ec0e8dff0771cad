"""graftlint fixture: the collectives layer (names as the port's)."""


def all_reduce(t, sub):
    return t
