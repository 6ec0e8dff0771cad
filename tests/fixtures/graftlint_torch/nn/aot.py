"""graftlint fixture: the dispatch-site layer the torch dialect reads
(names as the port's ``nn/aot.py``)."""


class AotFunction:
    def __init__(self, fn, site, model=None):
        self._fn = fn
        self.site = site

    def __call__(self, *args):
        return self._fn(*args)


def wrap(fn, site, model=None):
    return AotFunction(fn, site, model)


def site(model, name, fn=None):
    fns = model.__dict__.setdefault("_aot_fns", {})
    if name not in fns:
        fns[name] = wrap(fn, name, model)
    return fns[name]
