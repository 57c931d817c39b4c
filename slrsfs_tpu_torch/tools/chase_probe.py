"""Probe of the dependent-gather chain under K1 and K4: the least time an
Euler integrator's trajectories can take on the card when each step's
gather waits for the one before it.

    python -m slrsfs_tpu_torch.tools.chase_probe     # from the repository root

Builds ``chase_probe.cu`` (beside this file) with the port's nvcc flags into
``build/probe/`` and chases ``chip_smoke.py``'s scene: a 256² field whose
cell c holds the cells one step of +M and of -M lead to (rounded, clamped),
60 dependent float2 gathers a thread, started at K1's P = 32768 moving
pixels in both directions (65,536 threads; 32,768 with every other pixel)
and at every pixel in both directions (K4's dense dual form, 131,072
threads), each with and without an 8-byte store per step, and the
stores alone (8 bytes a thread, or 16 bytes by half the threads); and
K1's chase on a still field, where each gather after the first hits L1.
Each chase is
held against the same chase on the host and timed on the card alone
(``chip_smoke.device_time``); the line gives the time, the time per step,
and the share of K1's or K4's time the chain alone would take.
``chip_smoke.py`` runs ``latency_bound`` for K1's and K4's latency bound
(the chase without stores at the kernel's own starts and steps). A
missing card raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import torch

from slrsfs_tpu_torch import kernels

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chase_probe.cu")


def _lib_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(kernels.NVCC_FLAGS).encode())
    out_dir = os.path.join(os.path.dirname(kernels.BUILD_DIR), "probe")
    os.makedirs(out_dir, exist_ok=True)
    return os.path.join(out_dir, f"chase_probe-{digest.hexdigest()[:16]}.so")


def start_build():
    """Start nvcc for the probe unless it is built; returns the job for
    ``finish_build`` (so that a caller can build it beside the kernels)."""
    lib = _lib_path()
    if os.path.exists(lib):
        return None, lib
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.Popen([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-o", tmp, _SRC],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return (proc, tmp), lib


def finish_build(job) -> ctypes.CDLL:
    started, lib = job
    if started is not None:
        proc, tmp = started
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {_SRC}:\n{out}")
        os.replace(tmp, lib)
    dll = ctypes.CDLL(lib)
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    dll.chase_probe.argtypes = [P_, P_, P_, I_, I_, I_, P_]
    dll.chase_probe.restype = ctypes.c_int
    return dll


def next_cells(flow: torch.Tensor) -> torch.Tensor:
    """(H·W, 2) int32: the cell one step of +M and of -M leads to from each
    cell, rounded half to even and clamped to the frame."""
    H, W, _ = flow.shape
    ys, xs = torch.meshgrid(torch.arange(H, device=flow.device),
                            torch.arange(W, device=flow.device), indexing="ij")
    cells = []
    for sign in (1.0, -1.0):
        x = torch.round(xs + sign * flow[..., 0]).long().clamp(0, W - 1)
        y = torch.round(ys + sign * flow[..., 1]).long().clamp(0, H - 1)
        cells.append((y * W + x).reshape(-1))
    return torch.stack(cells, -1).to(torch.int32).contiguous()


def starts(cells: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) int32 start cells: ``cells`` (K,) spread over each half of the
    n threads (every K / (n / 2)-th cell), +M half first."""
    half = n // 2
    pick = cells[torch.arange(half, device=cells.device) * cells.numel() // half]
    return torch.cat([pick, pick]).to(torch.int32).contiguous()


def chase_host(field_bits: torch.Tensor, start: torch.Tensor, steps: int) -> torch.Tensor:
    """The no-store chase on tensors: (n, 2) int32 bits of the last float2."""
    n = start.numel()
    col = (torch.arange(n, device=start.device) >= n // 2).long()
    i = start.long()
    v = field_bits[i]
    for _ in range(steps):
        v = field_bits[i]
        i = v.gather(1, col[:, None])[:, 0].long()
    return v


def chase_ms(dll, field_bits: torch.Tensor, start: torch.Tensor, steps: int,
             store: int, timer) -> float:
    """Device ms of one chase (``timer`` is ``chip_smoke.device_time``):
    ``store`` 0 the chain alone, 1 with an 8-byte store a step, 2 the
    stores alone, 3 the same bytes by half the threads in 16-byte stores;
    the chain alone is first held against ``chase_host``."""
    n = start.numel()
    out = torch.empty((steps if store else 1, n, 2), dtype=torch.float32,
                      device=start.device)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = dll.chase_probe(field_bits.data_ptr(), start.data_ptr(), out.data_ptr(),
                              n // 2 if store == 3 else n, steps, store, stream)
        if err:
            raise RuntimeError(f"CUDA error {err} in chase_probe")

    if not store:
        call()
        got = out[0].view(torch.int32)
        if not torch.equal(got, chase_host(field_bits, start, steps)):
            raise RuntimeError("chase_probe: the card's chase differs from the host's")
    ms, _ = timer(call, reps=50)
    return ms


def latency_bound(dll, flow: torch.Tensor, cells: torch.Tensor, steps: int,
                  timer) -> float:
    """Device ms of the chain alone for trajectories starting at ``cells``
    (K,) in both directions (2K threads), ``steps`` dependent gathers each
    and no stores: the least time of an integrator whose steps each wait
    for the gather before."""
    field = next_cells(flow)
    return chase_ms(dll, field, starts(cells, 2 * cells.numel()), steps, 0, timer)


def main() -> int:
    import chip_smoke as cs
    from slrsfs_tpu_torch.engine.rollout import prepare_scene_sparse

    if not torch.cuda.is_available():
        raise RuntimeError("chase_probe needs a CUDA device")
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    dll = finish_build(start_build())
    H, W, T = cs.H, cs.W, cs.N_FRAMES
    _, flow_np = cs.synthetic_scene(cs.SEED)
    flow = torch.from_numpy(flow_np).to(dev)
    pos = torch.from_numpy(prepare_scene_sparse(flow_np)[0]).to(dev)
    moving = (pos[:, 1].long() * W + pos[:, 0].long())
    grid = torch.arange(H * W, device=dev)
    field = next_cells(flow)
    print(f"chase_probe: {torch.cuda.get_device_name(0)}; {smi}; {H}x{W} field "
          f"({H * W * 8 / 1024:.0f} KB), {T} dependent float2 gathers a thread")
    # every cell leads to itself: each gather after the first hits L1
    ms = chase_ms(dll, next_cells(torch.zeros_like(flow)), starts(moving, 2 * moving.numel()),
                  T, 0, cs.device_time)
    print(f"chase_probe K1 moving pixels on a still field (each cell leads to itself), "
          f"{2 * moving.numel()} threads, no store: {ms * 1e3:.2f} us on the card = "
          f"{ms * 1e6 / T:.1f} ns a step")
    for label, cells, n in (("K1 moving pixels", moving, 2 * moving.numel()),
                            ("K1 moving pixels, every other", moving, moving.numel()),
                            ("K4 every pixel", grid, 2 * grid.numel())):
        start = starts(cells, n)
        for store, what in ((0, "no store"), (1, "a store a step"),
                            (2, "the stores alone"),
                            (3, "the stores alone, 16 bytes by half the threads")):
            ms = chase_ms(dll, field, start, T, store, cs.device_time)
            gb = T * n * 8 / 1e9
            rate = f", {gb / ms:.2f} TB/s" if store else ""
            print(f"chase_probe {label}, {n} threads, {what}: {ms * 1e3:.2f} us on "
                  f"the card = {ms * 1e6 / T:.1f} ns a step{rate}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
