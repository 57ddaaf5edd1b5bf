"""Circuits and codec: device activities in the traced window per request."""


def read(r):
    if not r.work:
        return None
    return len(r.traced.spans) / r.steps
