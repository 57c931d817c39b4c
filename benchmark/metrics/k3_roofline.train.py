"""k3_roofline.train: K3's bound (two forwards and two backwards a step,
``benchmark/roofline/counts.py:k3_fwd``, ``k3_bwd``) over the summed
device time of its kernels by name in the traced steps, in %."""

from benchmark.trace import seconds_of

NAMES = ("splat_dense_fwd_kernel", "splat_dense_bwd_kernel")


def read(r):
    if r.trace is None or "k3" not in r.bounds:
        return None
    t = seconds_of(r.trace["by_name"], NAMES)
    return 100.0 * r.bounds["k3"] / t if t > 0 else None
