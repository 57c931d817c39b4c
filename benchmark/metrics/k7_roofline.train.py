"""k7_roofline.train: K7's bound (``benchmark/roofline/counts.py:k7`` at the
trajectory steps the traced batches need, compact or dense as the step
ran it) over the summed device time of its forward kernel in the traced
steps, in %."""

from benchmark.trace import seconds_of

NAMES = ("euler_phased_kernel",)


def read(r):
    if r.trace is None or "k7" not in r.bounds:
        return None
    t = seconds_of(r.trace["by_name"], NAMES)
    return 100.0 * r.bounds["k7"] / t if t > 0 else None
