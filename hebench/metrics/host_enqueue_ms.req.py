"""Circuits and codec host path (circuits/linear_algebra.py, the codec of
models/ckks.py): the median host ms from a request's start to its last
asynchronous call returning, before the wait for the device, over the
requests of the run's untraced part."""

import statistics


def read(r):
    if not r.host_enqueue_s:
        return None
    return 1e3 * statistics.median(r.host_enqueue_s)
