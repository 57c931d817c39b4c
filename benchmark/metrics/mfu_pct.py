"""mfu_pct.<kind>: the reference's flops for the traced slice's work (a
render's scenes at the reference's own crop plan; a training step's G
forward and backward, both discriminator passes and VGG19), counted on
the meta device (``benchmark/flops.py``), over the slice's seconds and the
peak of every card used for the networks' precision (bf16 989 TFLOP/s;
f32 without TF32 67), in %. One reader for every kind of cell."""

from benchmark.roofline.peaks import BF16_FLOPS, FP32_FLOPS


def read(r):
    if r.trace is None or r.flops is None:
        return None
    peak = BF16_FLOPS if r.dtype.startswith("bfloat16") else FP32_FLOPS
    return 100.0 * r.flops / r.trace["window_s"] / (peak * r.chips)
