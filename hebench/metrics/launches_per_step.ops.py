"""Scheme layer: device activities in the traced window per step (one
batch through one op)."""


def read(r):
    if not r.work:
        return None
    return len(r.traced.spans) / r.steps
