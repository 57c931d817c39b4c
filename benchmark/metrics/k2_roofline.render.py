"""k2_roofline.render: K2's bound over its device time in the traced slice,
in %. The bound is ``benchmark/roofline/counts.py:k2`` for each frame of
each traced scene at the reference's crop plan; the time is the summed
device time of K2's kernels by name (the f32 scatter and normalisation,
or the bf16 quarters and their epilogue). K2's copy of the static field
into its accumulator is a device copy with no kernel name, so it is left
out of the time."""

from benchmark.trace import seconds_of

NAMES = ("rows_scatter_kernel", "splat_normalize_kernel", "splat_scatter_quarters_kernel",
         "quarters_epilogue_kernel")


def read(r):
    if r.trace is None or "k2" not in r.bounds:
        return None
    t = seconds_of(r.trace["by_name"], NAMES)
    return 100.0 * r.bounds["k2"] / t if t > 0 else None
