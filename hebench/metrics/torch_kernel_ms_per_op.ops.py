"""Modular arithmetic (ops/modarith.py and the int64 chains of models/,
rlwe/, core/): device ms in PyTorch's own kernels (neither copies nor the
program's csrc kernels) per ciphertext op of the traced window."""


def read(r):
    if not r.units:
        return None
    ms = sum(e - s for s, e, name in r.traced.spans if r.classify(name) == "pytorch kernels") / 1e3
    return ms / r.units
