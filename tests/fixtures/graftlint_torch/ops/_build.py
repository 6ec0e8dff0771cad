"""graftlint fixture: the kernel-library cache (names as the port's)."""

import ctypes

_LIBS = {}


def load(name):
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(name)   # OK: the one cache
    return lib
