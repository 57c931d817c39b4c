"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
700 W): the yardstick of every roofline and MFU share."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12  # float32 outside the tensor cores (TF32 off)
# the same cores' rate in lane-instructions: 67e12 counts an FMA as two
# flops, and a round, clamp, compare, select or add is one instruction
LANE_OPS = 33.5e12
BF16_FLOPS = 989e12  # bf16 dense tensor cores


def bound(n_bytes: float, n_ops: float, peak: float = FP32_FLOPS):
    """(least seconds, 'bytes' or 'operations') at the peak rates: each
    input byte read once, each output byte written once."""
    tb, to = n_bytes / HBM_BYTES_PER_S, n_ops / peak
    return max(tb, to), "bytes" if tb >= to else "operations"
