"""Probe of the f32 global reduction forms on the card: does an atomic
splat scatter's time follow the count of its reductions or their bytes?

    python -m slrsfs_tpu_torch.tools.red_probe     # from the repository root

Builds ``red_probe.cu`` (beside this file) with the port's nvcc flags into
``build/probe/`` and runs K2's two-ended f32 scatter of ``chip_smoke.py``'s
scene (256², P = 32768 rows of 65 channels, the displacements of frame
t = 30, weights 0.5) with scalar ``red.global.add.f32`` (channel stride 65
and 68), ``red.global.add.v2.f32`` and ``red.global.add.v4.f32`` (stride
68). Each form's sum is held against the plain version (K8's two-ended
plain splat, atol/rtol 1e-5); each is timed on the card alone
(``chip_smoke.device_time``), and the line gives its reductions, the bytes
they carry, and both rates. A missing card raises.

Then the two access patterns that shape K7's backward
(``csrc/euler_phased.cu:euler_phased_bwd``), each timed on the card alone:
(a) 2^20 threads issuing 60 ``red.global.add.v2.f32`` each, all to the
thread's own cell or each to a new cell (lanes on neighbouring cells);
(b) the shared-memory float2 add a block's window would use, 1024 blocks
of 256 threads with a 72 KB window, 60 adds a thread, as two
``atomicAdd(float *)`` or as a 64-bit ``atomicCAS`` loop, with one lane or
four lanes a cell; each (b) kernel's atomic SASS opcodes are read from the
build with the toolkit's ``cuobjdump`` (a native add, or a compare-and-swap
loop). The sums are checked exactly (integers below 2^24).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np
import torch

from slrsfs_tpu_torch import kernels

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "red_probe.cu")
FORMS = ((0, 65, "red.global.add.f32"), (0, 68, "red.global.add.f32"),
         (1, 68, "red.global.add.v2.f32"), (2, 68, "red.global.add.v4.f32"))


def build() -> ctypes.CDLL:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(kernels.NVCC_FLAGS).encode())
    out_dir = os.path.join(os.path.dirname(kernels.BUILD_DIR), "probe")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"red_probe-{digest.hexdigest()[:16]}.so")
    if not os.path.exists(lib):
        subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", lib, _SRC],
                       check=True)
    dll = ctypes.CDLL(lib)
    P_, I_, F_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    dll.red_probe.argtypes = [P_, P_, P_, P_, P_, F_, F_, P_] + [I_] * 6 + [P_]
    dll.red_probe.restype = ctypes.c_int
    dll.red_pattern_probe.argtypes = [P_] + [I_] * 6 + [P_]
    dll.red_pattern_probe.restype = ctypes.c_int
    dll.path = lib
    return dll


def atomic_opcodes(lib: str, function: str) -> list:
    """The distinct atomic and reduction SASS opcodes (ATOM*, RED*) of the
    kernels in ``lib`` whose name contains ``function``."""
    import chip_smoke as cs

    return sorted({op for _, op, _ in cs.sass_of(lib, function)
                   if op.startswith(("ATOM", "RED"))})


def k7_patterns(dll, stream) -> None:
    """Patterns (a) and (b) of K7's backward, printed."""
    import chip_smoke as cs

    dev = torch.device("cuda")
    n, steps = 1 << 20, 60
    acc = torch.zeros((n, 2), device=dev)
    for same, what in ((1, "to the thread's own cell, repeated"),
                       (0, "to a new cell a step, lanes on neighbouring cells")):
        def call():
            err = dll.red_pattern_probe(acc.data_ptr(), 0, n, steps, same, 1, 0, stream)
            if err:
                raise RuntimeError(f"CUDA error {err} in red_pattern_probe (a)")

        acc.zero_()
        call()
        torch.cuda.synchronize()
        cs.check(bool((acc == steps).all()), f"red_probe (a) {what}: wrong sums")
        ms, host_us = cs.device_time(call, reps=20)
        print(f"red_probe (a) {n * steps} red.global.add.v2.f32 {what}: {ms * 1e3:.2f} us "
              f"on the card = {n * steps / ms / 1e6:.1f} G reductions/s (host "
              f"{host_us:.1f} us a call)")
    win, blocks = 96 * 96, 1024
    out = torch.zeros((win, 2), device=dev)
    for form, what, name in ((0, "two atomicAdd(float *)", "shared_probe_kernelILi0"),
                             (1, "a 64-bit atomicCAS loop", "shared_probe_kernelILi1")):
        for share in (1, 4):
            def call():
                err = dll.red_pattern_probe(out.data_ptr(), 1, win, steps, form, share,
                                            blocks, stream)
                if err:
                    raise RuntimeError(f"CUDA error {err} in red_pattern_probe (b)")

            out.zero_()
            call()
            torch.cuda.synchronize()
            cs.check(int(out[:, 0].sum().item()) == blocks * 256 * steps,
                     f"red_probe (b) {what}: wrong sum")
            ms, host_us = cs.device_time(call, reps=20)
            adds = blocks * 256 * steps
            print(f"red_probe (b) {adds} shared float2 adds as {what}, {share} lane(s) a "
                  f"cell, 72 KB windows: {ms * 1e3:.2f} us on the card = "
                  f"{adds / ms / 1e6:.1f} G float2 adds/s (host {host_us:.1f} us a call); "
                  f"SASS {atomic_opcodes(dll.path, name)}")


def main() -> int:
    import chip_smoke as cs
    from slrsfs_tpu_torch.engine.rollout import prepare_scene_sparse
    from slrsfs_tpu_torch.ops.euler import euler_compact_dual_plain
    from slrsfs_tpu_torch.ops.splat import softsplat_sum_at_quad_dual_plain

    if not torch.cuda.is_available():
        raise RuntimeError("red_probe needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    dll = build()
    H, W = cs.H, cs.W
    img_u8, flow_np = cs.synthetic_scene(cs.SEED)
    pos_np, val_np = prepare_scene_sparse(flow_np)
    flow = torch.from_numpy(flow_np).to(dev)
    positions = torch.from_numpy(pos_np).to(dev)
    valid = torch.from_numpy(val_np).to(dev)
    disp_f, disp_b = euler_compact_dual_plain(flow, positions, cs.N_FRAMES - 1, cs.N_FRAMES)
    da, db = disp_f[cs.T_MID].contiguous(), disp_b[cs.T_MID].contiguous()
    u = cs.k2_inputs(dev, np.random.default_rng(cs.SEED + 1), flow, positions,
                     valid)["K2"]["u_mov"]
    P, C1 = u.shape
    want = softsplat_sum_at_quad_dual_plain(u, positions, da, db, 0.5, 0.5, H, W)
    # taps that land in the grid (both ends, valid rows)
    px, py = positions[:, 0].float(), positions[:, 1].float()
    n_taps = 0
    for d in (da, db):
        x0, y0 = torch.floor(px + d[:, 0]), torch.floor(py + d[:, 1])
        for cx, cy in ((x0, y0), (x0 + 1, y0), (x0, y0 + 1), (x0 + 1, y0 + 1)):
            n_taps += int((((cx >= 0) & (cx < W) & (cy >= 0) & (cy < H))
                           & (valid > 0)).sum())
    stream = torch.cuda.current_stream().cuda_stream
    print(f"red_probe: {torch.cuda.get_device_name(0)}; {smi}; P={P} C1={C1} "
          f"{H}x{W} t={cs.T_MID}, {n_taps} taps in the grid")
    for form, stride, name in FORMS:
        acc = torch.zeros((H * W * stride,), device=dev)

        def call():
            err = dll.red_probe(u.data_ptr(), positions.data_ptr(), valid.data_ptr(),
                                da.data_ptr(), db.data_ptr(), 0.5, 0.5, acc.data_ptr(),
                                P, C1, stride, H, W, form, stream)
            if err:
                raise RuntimeError(f"CUDA error {err} in red_probe form {form}")

        call()
        got = acc.reshape(H, W, stride)[..., :C1]
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        cs.check(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
                 f"red_probe {name} stride {stride}: max abs {err}")
        ms, host_us = cs.device_time(call, reps=50)
        vec = 1 << form
        n_red = n_taps * -(-C1 // vec)
        n_bytes = n_red * vec * 4
        print(f"red_probe {name} stride {stride}: {n_red} reductions of {vec * 4} B "
              f"({n_bytes / 1e6:.1f} MB) in {ms * 1e3:.2f} us on the card = "
              f"{n_red / ms / 1e6:.1f} G reductions/s, {n_bytes / ms / 1e9:.2f} TB/s "
              f"(host {host_us:.1f} us a call); max abs {err:.3g} vs plain")
    k7_patterns(dll, stream)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
