"""Build and bind the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled on first use by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface and loaded with ``ctypes``. The
library lands in ``build/kernels/`` at the repository root, named after its
source and a hash of the source, the headers it includes from ``csrc/``
(``splat_window.cuh``, the window scatter of ``splat.cu`` and
``splat_dense.cu``; ``splat_quarters.cuh``, K2's bf16 quarters and the
bf16 helpers both use; ``maxwarp_corners.cuh``, the corners and float
atomic max of ``maxwarp.cu`` and ``maxsplat.cu``)
and the flags, so a changed source or header never loads a stale build;
nvcc's report (ptxas's registers and spills) is kept beside it and read
again when a later process loads the library. Several entry points may
share one source; it is built once: ``euler.cu`` holds K1
(``euler_compact_dual``) and K4 (``euler_all``), ``splat.cu`` K2's two
epilogues (``splat_dual_normalize``,
``splat_dual_normalize_slr``, f32 or bf16 accumulation) and K8
(``splat_sum_at``), ``maxwarp.cu`` K5 (``maximum_warp_norm_sparse``) and K6
(``maximum_warp_norm_splat``), ``maxsplat.cu`` K6's two halves for any
channel count, K6a (``max_splat``) and K6b (``inverse_max_gather``),
``splat_dense.cu`` K3's forward and backward
in float32 and in bf16 (``splat_dense_fwd_bf16``, ``splat_dense_bwd_bf16``),
``euler_phased.cu`` K7's forward (``euler_phased``) and backward
(``euler_phased_bwd``);
``fused_conv.cu`` is K9 (``fused_conv3x3_relu_conv3x3``). Nothing is
compiled at import: this module imports on a host without CUDA.

Every C entry point launches on the stream it is given (the wrapper passes
``torch.cuda.current_stream()``) and returns a CUDA error code
(``cudaGetLastError()`` after its launches, or the cooperative launch's
own); a non-zero code raises here, with the runtime's description. The
kernels' own limits are checked by their wrappers before anything is
allocated or launched (``check_sides``, ``check_shared_memory``), so that
they raise a ``ValueError`` that names the limit. Each :class:`Kernel`
counts its launches so that a run can show that the main path went
through it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from typing import Dict, List, Optional, Sequence

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "build", "kernels")
# -fmad=false keeps the plain versions' rounding: without it nvcc may fuse a
# multiply and an add that PyTorch rounds separately
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def source_files(path: str) -> List[str]:
    """``path`` and every header it includes with ``#include "..."`` from
    its own directory, recursively, each once: the files a build depends
    on, the source first and the headers by name."""
    seen, todo = set(), [path]
    while todo:
        p = todo.pop()
        if p in seen:
            continue
        seen.add(p)
        with open(p) as f:
            for name in _INCLUDE.findall(f.read()):
                q = os.path.join(os.path.dirname(p), name)
                if os.path.exists(q):
                    todo.append(q)
    return [path] + sorted(seen - {path})


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def error_text(err: int) -> str:
    """The CUDA runtime's description of error code ``err``."""
    import torch

    return str(torch.cuda.CudaError(err)).rsplit(" (", 1)[0]


def check_sides(kernel: str, H: int, W: int, limit: int, why: str) -> None:
    """Raise a ``ValueError`` naming ``kernel``'s limit unless H and W are
    both below ``limit`` (``why``: what sets it)."""
    if H >= limit or W >= limit:
        raise ValueError(f"{kernel} takes H and W below {limit} ({why}); got "
                         f"H={H}, W={W}")


def check_shared_memory(kernel: str, need: int, most: int, what: str) -> None:
    """Raise a ``ValueError`` naming ``kernel``'s limit when a block needs
    ``need`` bytes of shared memory for ``what`` and the card gives at most
    ``most``."""
    if need > most:
        raise ValueError(f"{kernel} stages {what} in {need} bytes of shared memory a "
                         f"block, above the card's {most}")


class Kernel:
    """One ``.cu`` source, its C entry point and its launch count."""

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence):
        self.name = name
        self.source = source  # path relative to the repository root
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.build_log = ""
        self.build_seconds: Optional[float] = None
        self._fn = None
        self._lib = None

    @property
    def _src_path(self) -> str:
        return os.path.join(_CSRC, os.path.basename(self.source))

    def _lib_path(self) -> str:
        digest = hashlib.sha256()
        for path in source_files(self._src_path):
            with open(path, "rb") as f:
                digest.update(os.path.basename(path).encode() + b"\0" + f.read())
        digest.update(" ".join(NVCC_FLAGS).encode())
        stem = os.path.splitext(os.path.basename(self.source))[0]
        return os.path.join(BUILD_DIR, f"{stem}-{digest.hexdigest()[:16]}.so")

    def _start_build(self):
        """Start nvcc unless the library exists; returns (Popen, tmp, lib)."""
        lib = self._lib_path()
        if os.path.exists(lib):
            return None, None, lib
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, self._src_path]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        return proc, tmp, lib

    def _finish_build(self, proc, tmp: str, lib: str, t0: float) -> None:
        log = os.path.splitext(lib)[0] + ".log"
        if proc is not None:
            out, _ = proc.communicate()
            self.build_log = out
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {self.source}:\n{out}")
            with open(log, "w") as f:
                f.write(out)
            os.replace(tmp, lib)
        elif os.path.exists(log):  # nvcc's report from the earlier build
            with open(log) as f:
                self.build_log = f.read()
        self.build_seconds = time.perf_counter() - t0
        self._lib = ctypes.CDLL(lib)
        fn = getattr(self._lib, self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._fn = fn

    def load(self) -> None:
        if self._fn is None:
            t0 = time.perf_counter()
            self._finish_build(*self._start_build(), t0)

    def launch(self, *args) -> None:
        """Call the C entry point; raises on a non-zero CUDA error code."""
        self.load()
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(f"CUDA error {err} ({error_text(err)}) launching "
                               f"{self.name}")
        self.launches += 1

    def query(self, symbol: str, *args: int) -> int:
        """Call another C function of the same library, one that takes and
        returns ints and launches nothing (not counted)."""
        self.load()
        fn = getattr(self._lib, symbol)
        fn.argtypes = [_I] * len(args)
        fn.restype = ctypes.c_int
        return fn(*args)


EULER = Kernel(
    "euler_compact_dual", "slrsfs_tpu_torch/csrc/euler.cu",
    "euler_compact_dual",
    # motion, positions, disp_f, disp_b, P, H, W, n_fwd, n_bwd, stream
    [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P])

EULER_ALL = Kernel(
    "euler_all", "slrsfs_tpu_torch/csrc/euler.cu", "euler_all",
    # motion, positions (NULL: dense grid), disp_f, disp_b (NULL: +M only),
    # vis_f, vis_b (NULL: no visibility), R, H, W, n_fwd, n_bwd, last_only,
    # stream
    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])

SPLAT = Kernel(
    "splat_dual_normalize", "slrsfs_tpu_torch/csrc/splat.cu",
    "splat_dual_normalize",
    # u_mov, positions, valid, disp_a, disp_b, w_a, w_b, u_static, acc, out,
    # P, C1, H, W, out_bf16, acc_bf16, stream
    [_P, _P, _P, _P, _P, _F, _F, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])

SPLAT_SLR = Kernel(
    "splat_dual_normalize_slr", "slrsfs_tpu_torch/csrc/splat.cu",
    "splat_dual_normalize_slr",
    # as SPLAT
    [_P, _P, _P, _P, _P, _F, _F, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])

SPLAT_SUM_AT = Kernel(
    "splat_sum_at", "slrsfs_tpu_torch/csrc/splat.cu", "splat_sum_at",
    # u, positions, disp_a, disp_b (NULL: one end), w_a, w_b, out, quarters
    # (bf16 scratch), P, C, H, W, acc_bf16, stream
    [_P, _P, _P, _P, _F, _F, _P, _P, _I, _I, _I, _I, _I, _P])

MAXWARP_SPARSE = Kernel(
    "maximum_warp_norm_sparse", "slrsfs_tpu_torch/csrc/maxwarp.cu",
    "maximum_warp_norm_sparse",
    # z, static_mask, z_mov, positions, valid, disp, mx, zmax_dense,
    # zmax_mov, P, H, W, stream
    [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P])

MAXWARP_SPLAT = Kernel(
    "maximum_warp_norm_splat", "slrsfs_tpu_torch/csrc/maxwarp.cu",
    "maximum_warp_norm_splat",
    # z, flow, mx, out, B, H, W, stream
    [_P, _P, _P, _P, _I, _I, _I, _P])

MAX_SPLAT = Kernel(
    "max_splat", "slrsfs_tpu_torch/csrc/maxsplat.cu", "max_splat",
    # inp, flow, out, B, H, W, C, stream
    [_P, _P, _P, _I, _I, _I, _I, _P])

INVERSE_MAX_GATHER = Kernel(
    "inverse_max_gather", "slrsfs_tpu_torch/csrc/maxsplat.cu",
    "inverse_max_gather",
    # maxmap, flow, init, out, B, H, W, C, stream
    [_P, _P, _P, _P, _I, _I, _I, _I, _P])

SPLAT_DENSE_FWD = Kernel(
    "splat_dense_fwd", "slrsfs_tpu_torch/csrc/splat_dense.cu",
    "splat_dense_fwd",
    # inp, flow, out, B, H, W, C, stream
    [_P, _P, _P, _I, _I, _I, _I, _P])

SPLAT_DENSE_BWD = Kernel(
    "splat_dense_bwd", "slrsfs_tpu_torch/csrc/splat_dense.cu",
    "splat_dense_bwd",
    # inp, flow, g, grad_inp, grad_flow, B, H, W, C, stream;
    # splat_dense_bwd_smem_bytes(C) is the block's shared memory and
    # splat_dense_bwd_smem_most() the card's most a block
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P])

SPLAT_DENSE_FWD_BF16 = Kernel(
    "splat_dense_fwd_bf16", "slrsfs_tpu_torch/csrc/splat_dense.cu",
    "splat_dense_fwd_bf16",
    # inp (bf16), flow, out (bf16, zeroed), B, H, W, C, stream
    [_P, _P, _P, _I, _I, _I, _I, _P])

SPLAT_DENSE_BWD_BF16 = Kernel(
    "splat_dense_bwd_bf16", "slrsfs_tpu_torch/csrc/splat_dense.cu",
    "splat_dense_bwd_bf16",
    # inp (bf16), flow, g (bf16), grad_inp (bf16), grad_flow, B, H, W, C,
    # stream; splat_dense_bwd_bf16_window_cells(C) is its window
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P])

EULER_PHASED = Kernel(
    "euler_phased", "slrsfs_tpu_torch/csrc/euler_phased.cu", "euler_phased",
    # motion, positions, valid, t_fwd, t_bwd, out_f, out_p, B, R, H, W,
    # n_steps, stream
    [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P])

EULER_PHASED_BWD = Kernel(
    "euler_phased_bwd", "slrsfs_tpu_torch/csrc/euler_phased.cu", "euler_phased_bwd",
    # motion, t_fwd, t_bwd, out_f, out_p, cot_f, cot_p (NULL: zero), grad,
    # B, H, W, n_steps, stream
    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P])

FUSED_CONV = Kernel(
    "fused_conv3x3_relu_conv3x3", "slrsfs_tpu_torch/csrc/fused_conv.cu",
    "fused_conv3x3_relu_conv3x3",
    # x, packed weights (ops/fused_conv.py:pack_weights), out, B, H, W, C,
    # F, stream; fused_conv_smem_bytes(C, F) is the block's shared memory
    [_P, _P, _P, _I, _I, _I, _I, _I, _P])

KERNELS: List[Kernel] = [EULER, EULER_ALL, SPLAT, SPLAT_SLR, SPLAT_SUM_AT,
                         MAXWARP_SPARSE, MAXWARP_SPLAT, MAX_SPLAT,
                         INVERSE_MAX_GATHER, SPLAT_DENSE_FWD,
                         SPLAT_DENSE_BWD, SPLAT_DENSE_FWD_BF16, SPLAT_DENSE_BWD_BF16,
                         EULER_PHASED, EULER_PHASED_BWD, FUSED_CONV]


def build_all() -> Dict[str, float]:
    """Compile every source not yet built, one nvcc per source, all at once.
    Returns seconds per kernel (build and load)."""
    t0 = time.perf_counter()
    jobs = {}
    for k in KERNELS:
        if k._fn is None and k.source not in jobs:
            jobs[k.source] = k._start_build()
    for k in KERNELS:
        if k._fn is None:
            # a sibling entry of an already started source only loads
            k._finish_build(*jobs.pop(k.source, (None, None, k._lib_path())),
                            t0)
    return {k.name: k.build_seconds for k in KERNELS}


def reset_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def counts() -> Dict[str, int]:
    return {k.name: k.launches for k in KERNELS}
