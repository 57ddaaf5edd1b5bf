"""Scheme layer (models/ckks.py): the ops completed in the traced window,
each at its least time (hebench/bounds.op_least_s: the reference
algorithm's work at its n, level, special primes, alpha and batch), as a
share of the window."""

from hebench import bounds


def read(r):
    if r.mix["kind"] != "ckks_ks" or not r.work:
        return None
    c = r.config
    least = sum(bounds.op_least_s(op, c["n"], level, c["special_primes"], c["alpha"],
                                  r.mix["batch"]) for op, level in r.work)
    return 100.0 * least / r.traced.wall_s
