"""Key-switching layer (rlwe/rgsw.py, core/basecnv.py; kernels K3, K4):
the least time of the external-product launches of the traced window
(bounds.ext_prod_launch_s at each key switch's digits and limbs: one a
step) over their kernel time in the trace. Nothing is read where the trace
lost a launch or the steps and launches disagree."""

import math

from hebench import bounds


def read(r):
    if r.mix["kind"] != "ckks_ks" or not r.work:
        return None
    spans = [s for s in r.traced.spans if r.classify(s[2]) == "K3/K4"]
    launched = r.launches.get("ext_prod", 0) + r.launches.get("ext_prod_conv", 0)
    if not spans or len(spans) != launched or launched != r.steps:
        return None
    c, n = r.config, r.config["n"]
    least = sum(bounds.ext_prod_launch_s(r.mix["batch"], math.ceil(level / c["alpha"]),
                                         level + c["special_primes"], n)
                for _, level in r.work)
    return 100.0 * least / (sum(e - s for s, e, _ in spans) / 1e6)
