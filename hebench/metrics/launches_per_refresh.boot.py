"""Scheme layer (the refresh): device activities in the traced window per
refreshed ciphertext, the stage markers left out."""

from hebench.boot_trace import is_marker


def read(r):
    if r.mix.get("kind") != "ckks_boot" or not r.units:
        return None
    return sum(not is_marker(name) for _, _, name in r.traced.spans) / r.units
