"""The bootstrapping configuration at a tiny ring, registered with
tiny.py's cut of every configuration (TINY, TINY_LIMITS) when imported, so
that tiny.make_root can write it: n=256 with the configuration's primes,
weights, transforms and EvalMod, everything else as stated."""

from __future__ import annotations

import json

from hebench.tests import tiny

CONFIG = "ckks_boot_n65536_h192"
N = 256
tiny.TINY.setdefault(CONFIG, dict(n=N))
# between the sound refresh at n=256 (7.0e-5 and 7.6e-5 on two seeds) and
# the program with its plan diagonals in float32 (1.0e-3 and 1.5e-3,
# kinds/ckks_boot.float32_plans); a refresh that failed reads ~1
tiny.TINY_LIMITS.setdefault("boot_err", 2.0**-11)
tiny.TINY_LIMITS.setdefault("limb_shortfall", 0)


def full_config() -> dict:
    """The configuration as the cell runs it (n=65536)."""
    return json.loads((tiny.REPO / "hebench" / "configs" / f"{CONFIG}.json").read_text())
