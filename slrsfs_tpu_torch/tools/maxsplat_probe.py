"""Probe beside K6a and K6b: the launch floor.

Builds ``maxsplat_probe.cu`` (beside this file) with the port's nvcc flags
into ``build/probe/`` and binds ``launch_floor(dll)``: one empty kernel of
one warp on the current stream. Timed on the card alone
(``chip_smoke.py:device_time``), it is the least time any one launch
takes: at 256² it exceeds K6a's and K6b's bytes bounds, so it is what "how
far from the best" can mean there.

A missing card raises; nothing is built at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import torch

from slrsfs_tpu_torch import kernels

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "maxsplat_probe.cu")


def _lib_path() -> str:
    digest = hashlib.sha256(" ".join(kernels.NVCC_FLAGS).encode())
    for path in kernels.source_files(_SRC):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    out_dir = os.path.join(os.path.dirname(kernels.BUILD_DIR), "probe")
    os.makedirs(out_dir, exist_ok=True)
    return os.path.join(out_dir, f"maxsplat_probe-{digest.hexdigest()[:16]}.so")


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
    dll.launch_floor.argtypes = [ctypes.c_void_p]
    dll.launch_floor.restype = ctypes.c_int
    return dll


def build() -> ctypes.CDLL:
    return finish_build(start_build())


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA error {err} ({kernels.error_text(err)}) launching {what}")


def launch_floor(dll) -> None:
    """One empty kernel on the current stream."""
    _check(dll.launch_floor(torch.cuda.current_stream().cuda_stream), "launch_floor")

