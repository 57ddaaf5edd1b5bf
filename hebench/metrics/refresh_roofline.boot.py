"""Scheme layer (the refresh): the refreshes completed in the traced
window, each at its least time (hebench/bounds_boot.refresh_least_s: the
configuration's key switches, plaintext products and mults at the peaks
of hebench/bounds.py), as a share of the window."""

from hebench import bounds_boot


def read(r):
    if r.mix.get("kind") != "ckks_boot" or not r.units:
        return None
    return 100.0 * r.units * bounds_boot.refresh_least_s(r.config) / r.traced.wall_s
