"""device_idle_pct.<kind>: the card's idle share of the traced slice, in %:
one minus the union of its kernel, copy and memset intervals over the
slice's length. One reader for every kind of cell."""


def read(r):
    if r.trace is None:
        return None
    return 100.0 * (1.0 - r.trace["busy_s"] / r.trace["window_s"])
