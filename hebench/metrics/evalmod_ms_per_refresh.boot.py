"""Circuits (circuits/bootstrap.py: EvalMod, both halves): device ms a
refresh between the program's evalmod markers and the s2c marker
(hebench/boot_trace.py)."""

from hebench.boot_trace import per_refresh_ms


def read(r):
    return per_refresh_ms(r, "evalmod")
