"""Device: 1 - busy / wall over the traced window, busy the union of the
device activities' intervals."""


def read(r):
    if not r.traced.spans:
        return None
    return 100.0 * (1.0 - r.traced.busy_s / r.traced.wall_s)
