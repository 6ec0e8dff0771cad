"""graftlint fixture: use-after-donate true positives (the port's in-place
step rewrites the leaves a name bound before it aliases)."""


def read_after_step(model, x, y):
    w = model.params[0]["W"]
    model.fit_batch(x, y)
    return w.sum()                          # BAD: w holds the new values


def alias_of_state(model, data):
    m = model.opt_state[0]["m"].detach()
    model.fit(data)
    return m                                # BAD: detach() still aliases


def cloned_first(model, x, y):
    w = model.params[0]["W"].clone()
    model.fit_batch(x, y)
    return w.sum()                          # OK: a copy


def rebound_after(model, x, y):
    w = model.params[0]["W"]
    model.fit_batch(x, y)
    w = model.params[0]["W"]
    return w                                # OK: read again


def train(model, data):
    model.fit(data)


def through_a_helper(model, data):
    s = model.state
    train(model, data)
    return s                                # BAD: train() steps model


def suppressed(model, x, y):
    w = model.params[0]["W"]
    model.fit_batch(x, y)
    return w  # graftlint: disable=use-after-donate
