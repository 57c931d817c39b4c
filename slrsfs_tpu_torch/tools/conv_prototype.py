"""The fused conv3x3 → ReLU → conv3x3 kernel (K9) on the card, against its
plain version and cuDNN: the port's counterpart of the ``__main__`` of
``tools/pallas_conv_prototype.py``.

    python -m slrsfs_tpu_torch.tools.conv_prototype [--reps 3]

On the prototype's deterministic inputs (the ``% 17``, ``% 13``, ``% 11``
patterns) it checks the kernel on ``x[:2, :32]`` against
``conv_chain_plain``, then times, at B = 60, 256 x 480, C = F = 128 bf16, the
kernel, the library chain (cuDNN bf16) and the plain chain (float32, TF32
off), with CUDA events, and prints TFLOP/s of the useful work (no halo
recompute), the kernel's issued/useful work ratio, its block's shared
memory (``fused_conv_smem_bytes``, from the kernel's library) and its
registers and spills (from ptxas's report in the build log). A missing card
raises.
"""

from __future__ import annotations

import argparse
import json
import re

import torch

from slrsfs_tpu_torch import kernels
from slrsfs_tpu_torch.engine.init_utils import resolve_device
from slrsfs_tpu_torch.ops.fused_conv import (
    conv_chain_library,
    conv_chain_plain,
    fused_conv3x3_relu_conv3x3,
    work_ratio,
)

SHAPE = dict(B=60, H=256, W=480, C=128, F=128)  # the prototype's (:148-149)


def make_inputs(B: int, H: int, W: int, C: int, F: int, device):
    """x (B, H, W, C), waa (3, 3, C, F), wab (3, 3, F, F) bf16: the
    prototype's ``(arange % k - k // 2) · s`` patterns, the product rounded
    once to bf16 as JAX's bf16 multiply by a weak scalar rounds it."""
    def pattern(shape, k, scale):
        n = 1
        for s in shape:
            n *= s
        v = (torch.arange(n, dtype=torch.int32, device=device) % k) - k // 2
        return (v.to(torch.bfloat16)
                * torch.tensor(scale, dtype=torch.bfloat16, device=device)
                ).reshape(shape)

    return (pattern((B, H, W, C), 17, 0.1), pattern((3, 3, C, F), 13, 0.01),
            pattern((3, 3, F, F), 11, 0.01))


def compare(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """max |got - ref|, max |ref|, and the share of elements more than one
    bf16 ulp (of the larger magnitude of the pair) apart."""
    g, r = got.float(), ref.float()
    diff = (g - r).abs()
    size = torch.maximum(g.abs(), r.abs())
    _, e = torch.frexp(size)
    ulp = torch.ldexp(torch.ones_like(size), e - 8)  # 2^(floor(log2 size) - 7)
    beyond = (diff > ulp) & (size > 0)
    return {"max_abs_err": diff.max().item(), "scale": r.abs().max().item(),
            "beyond_ulp_share": beyond.float().mean().item()}


def within_limits(c: dict) -> bool:
    """At most 2^-7 of max |ref| apart, and at most 0.1 % of elements more
    than one bf16 ulp apart."""
    return (c["max_abs_err"] <= 2.0 ** -7 * c["scale"]
            and c["beyond_ulp_share"] <= 1e-3)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call of ``fn`` over ``reps`` calls (CUDA
    events, after ``warmup`` calls)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_resources(build_log: str) -> dict:
    """Registers per thread at launch and spill bytes of K9's kernel from
    ptxas's ``-v`` report in its build log, the largest over its
    instantiations (one per whole swizzle rows of C and F); empty when the
    log holds no report."""
    res, inside = {}, False
    for line in build_log.splitlines():
        if "entry function" in line:
            inside = "fused_conv_kernel" in line
            if inside:
                res.setdefault("registers", 0)
                res.setdefault("spill_bytes", 0)
            continue
        if not inside:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            res["spill_bytes"] = max(res["spill_bytes"], int(m.group(1)) + int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            res["registers"] = max(res["registers"], int(m.group(1)))
    return res


def bench(reps: int = 3, plain_reps: int = 1, **shape) -> dict:
    """On the card: check the kernel on the prototype's slice, then time
    it, the library chain and the plain chain at the prototype's shape
    (``shape`` overrides its sizes). Returns the check, the times (ms), the
    useful TFLOP/s, the block's resources and the inputs."""
    dev = resolve_device("cuda")
    s = {**SHAPE, **shape}
    x, waa, wab = make_inputs(s["B"], s["H"], s["W"], s["C"], s["F"], dev)
    xs = x[:2, :32].contiguous()
    ref = conv_chain_plain(xs, waa, wab)
    check = compare(fused_conv3x3_relu_conv3x3(xs, waa, wab), ref)
    flop = 2 * s["B"] * s["H"] * s["W"] * 9 * (s["C"] * s["F"] + s["F"] * s["F"])
    ms = {"kernel": cuda_ms(lambda: fused_conv3x3_relu_conv3x3(x, waa, wab), reps),
          "library": cuda_ms(lambda: conv_chain_library(x, waa, wab), reps),
          "plain": cuda_ms(lambda: conv_chain_plain(x, waa, wab), plain_reps)}
    block = {"work_ratio": work_ratio(s["C"], s["F"]),
             "smem_bytes": kernels.FUSED_CONV.query("fused_conv_smem_bytes",
                                                    s["C"], s["F"]),
             **kernel_resources(kernels.FUSED_CONV.build_log)}
    return {"shape": s, "check": check, "ms": ms,
            "tflops": {k: flop / (v * 1e-3) / 1e12 for k, v in ms.items()},
            "block": block, "flop": flop, "inputs": (x, waa, wab)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--reps", type=int, default=3,
                   help="timed calls of the kernel and the library chain")
    a = p.parse_args(argv)
    res = bench(reps=a.reps)
    c = res["check"]
    print(f"correctness on x[:2, :32]: max abs err {c['max_abs_err']:.3g} "
          f"(ref scale {c['scale']:.3g}), {c['beyond_ulp_share']:.2e} of "
          f"elements beyond one bf16 ulp")
    for k, v in res["ms"].items():
        print(f"{k:>16}: {v:9.3f} ms ({res['tflops'][k]:.1f} TFLOP/s)")
    print("block: " + ", ".join(f"{k} {v:.4g}" for k, v in res["block"].items()))
    print(json.dumps({k: res[k] for k in ("shape", "check", "ms", "tflops", "block")}))
    return 0 if within_limits(c) else 1


if __name__ == "__main__":
    raise SystemExit(main())
