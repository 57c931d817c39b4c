"""Probe of the accumulation forms of K7's backward on the card: which
form of the window's add, and which window, the kernel should use.

    python -m slrsfs_tpu_torch.tools.k7_bwd_probe     # from the repository root

Builds ``k7_bwd_probe.cu`` (beside this file) once for each form in
``FORMS`` with the port's nvcc flags into ``build/probe/`` (one nvcc each,
all at once) and runs each, and the port's own ``euler_phased_bwd``, on
``chip_smoke.py:k7_bwd_inputs``' predicted motion of the seeded joint
step (its weights before any step), scene flow and leaving flow, with
seeded random cotangents: each form's largest distance from the plain
version's autograd over the gradient's largest magnitude, and its time on
the card alone (``chip_smoke.device_time``); then each build's registers,
spills and atomic SASS opcodes. A missing card raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np
import torch

from slrsfs_tpu_torch import kernels

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "k7_bwd_probe.cu")
FORMS = (
    ("walk alone", "ACC=0"),
    ("each step into grad, no window", "ACC=5"),
    ("window, two f32 atomicAdd", "ACC=3"),
    ("window, 64-bit CAS loop", "ACC=4"),
    ("window, int32 coarse only", "ACC=1 LB=3"),
    ("window, int32 coarse and fine (the kernel)", "ACC=2 LB=3"),
    ("the same, lanes merged by __match_any_sync", "ACC=2 MATCH=1 LB=3"),
    ("the same, margin 24", "ACC=2 MARGIN=24 LB=2"),
    ("the same, margin 32", "ACC=2 MARGIN=32"),
    ("the same, margin 8", "ACC=2 MARGIN=8 LB=3"),
    ("the same, four rows a thread", "ACC=2 ROWS_STEP=8 LB=3"),
)


def build() -> dict:
    """{form: (CDLL, library path, nvcc's report)}, built all at once."""
    with open(_SRC, "rb") as f:
        src = f.read()
    out_dir = os.path.join(os.path.dirname(kernels.BUILD_DIR), "probe")
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for label, defs in FORMS:
        flags = [*kernels.NVCC_FLAGS, *[f"-D{d}" for d in defs.split()]]
        digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]
        lib = os.path.join(out_dir, f"k7_bwd_probe-{digest}.so")
        proc = subprocess.Popen([kernels.nvcc_path(), *flags, "-o", lib, _SRC],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[label] = (proc, lib)
    built = {}
    for label, (proc, lib) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        dll = ctypes.CDLL(lib)
        dll.k7_bwd_probe.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        dll.k7_bwd_probe.restype = ctypes.c_int
        built[label] = (dll, lib, log)
    return built


def main() -> int:
    import chip_smoke as cs
    from slrsfs_tpu_torch.cli.train import MODEL_TYPE, build as build_trainer
    from slrsfs_tpu_torch.cli.train import stage_options, to_device_batch
    from slrsfs_tpu_torch.config import Options
    from slrsfs_tpu_torch.ops.euler import (
        euler_integrate_phased,
        euler_integrate_phased_plain,
        euler_phased_bwd,
    )

    if not torch.cuda.is_available():
        raise RuntimeError("k7_bwd_probe needs a CUDA device")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    built = build()
    opt = Options(W=cs.W, batch_size=cs.TRAIN_B, freeze_motion=False,
                  **stage_options(MODEL_TYPE, True))
    _, tr = build_trainer(opt, train_max_steps=cs.TRAIN_T, device=dev, seed=cs.SEED)
    batch = to_device_batch(cs.make_motion_train_batch(np.random.default_rng(cs.SEED),
                                                       cs.TRAIN_B, cs.W), dev)
    _, k7_in = cs.embedded_inputs(tr, batch)
    del tr, batch
    torch.cuda.empty_cache()
    cases = cs.k7_bwd_inputs(dev, k7_in)
    T = cs.TRAIN_T
    stream = torch.cuda.current_stream().cuda_stream
    print(f"k7_bwd_probe: {smi}; B={cs.TRAIN_B} {cs.H}x{cs.W} T={T}")
    for label in ("predicted motion (joint step)", "scene flow", "leaving flow"):
        m, tf, tp = cases[label]
        gen = torch.Generator(device=dev).manual_seed(cs.SEED + 191)
        cf = torch.randn(m.shape, generator=gen, device=dev)
        cp = torch.randn(m.shape, generator=gen, device=dev)
        x = m.clone().requires_grad_(True)
        a, b = euler_integrate_phased_plain(x, tf, tp, T)
        want = torch.autograd.grad((a * cf).sum() + (b * cp).sum(), x)[0]
        scale = want.abs().max().item()
        with torch.no_grad():
            out_f, out_p = euler_integrate_phased(m, tf, tp, T)
        B, H, W, _ = m.shape
        g = torch.zeros_like(m)
        calls = {"the port's euler_phased_bwd": lambda: euler_phased_bwd(
            m, tf, tp, out_f, out_p, cf, cp, T)}
        for form, (dll, _, _) in built.items():
            def call(fn=dll.k7_bwd_probe, form=form):
                g.zero_()
                err = fn(m.data_ptr(), tf.data_ptr(), tp.data_ptr(), out_f.data_ptr(),
                         out_p.data_ptr(), cf.data_ptr(), cp.data_ptr(), g.data_ptr(), B, H,
                         W, T, stream)
                if err:
                    raise RuntimeError(f"CUDA error {err} in k7_bwd_probe {form}")
                return g

            calls[form] = call
        for form, call in calls.items():
            got = call()
            torch.cuda.synchronize()
            err = (got - want).abs().max().item() / scale
            ms, _ = cs.device_time(call, reps=20)
            print(f"k7_bwd_probe {label}: {form}: {ms:.4f} ms on the card; max abs "
                  f"{err:.2g} of the gradient's max" + (" (no add: not a gradient)"
                                                        if form == "walk alone" else ""))
    for form, (_, lib, log) in built.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        ops = sorted({op for _, op, _ in cs.sass_of(lib, "probe_kernel")
                      if op.startswith(("ATOM", "RED"))})
        print(f"k7_bwd_probe build {form}: {regs[-2:]}; atomics {ops}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
