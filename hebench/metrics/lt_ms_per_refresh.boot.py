"""Circuits (circuits/bootstrap.py: the factored linear transforms): device
ms a refresh inside CoeffToSlot and SlotToCoeff, between the program's
stage markers c2s .. evalmod and s2c .. done (hebench/boot_trace.py)."""

from hebench.boot_trace import per_refresh_ms


def read(r):
    return per_refresh_ms(r, "c2s", "s2c")
