"""Codec (ops/fft.py; kernels K5, F): the least time of the FFT launches
of the traced window (bounds.fft_launch_s at the rows of each launch, from
the program's LAUNCH_ROWS counter, of length m = n/2) over their kernel
time in the trace. Nothing is read where F ran (m above one launch) or the
trace and the counter disagree."""

from hebench import bounds


def read(r):
    if r.launches.get("fft_stage", 0):
        return None
    spans = [s for s in r.traced.spans if r.classify(s[2]) in ("K5", "K5 small")]
    if not spans or len(spans) != r.launches.get("fft", 0):
        return None
    m = r.config["n"] // 2
    least = sum(count * bounds.fft_launch_s(rows, m)
                for rows, count in r.launch_rows.get("fft", {}).items())
    return 100.0 * least / (sum(e - s for s, e, _ in spans) / 1e6)
