"""Ring layer (ops/ntt.py, core/rns.py; kernels K1, K2): the least time of
the NTT launches of the traced window (bounds.ntt_launch_s at the rows of
each launch, from the program's LAUNCH_ROWS counter) over their kernel
time in the trace. Nothing is read where the stage kernel S ran (its
least time needs shapes the counter does not keep) or the trace and the
counter disagree."""

from hebench import bounds


def read(r):
    if r.launches.get("ntt_stage", 0):
        return None
    spans = [s for s in r.traced.spans if r.classify(s[2]) in ("K1", "K2", "K1/K2 small")]
    launched = r.launches.get("ntt_fwd", 0) + r.launches.get("ntt_inv", 0)
    if not spans or len(spans) != launched:
        return None
    n = r.config["n"]
    least = sum(count * bounds.ntt_launch_s(rows, n, kind == "ntt_inv")
                for kind in ("ntt_fwd", "ntt_inv")
                for rows, count in r.launch_rows.get(kind, {}).items())
    return 100.0 * least / (sum(e - s for s, e, _ in spans) / 1e6)
