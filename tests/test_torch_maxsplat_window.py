"""K6a's window and K6b's runs on the host (slrsfs_tpu_torch, CPU), and the
stage profiler's device.

K6a (``max_splat``, csrc/maxsplat.cu) at one channel places splat_window.cuh's
window over each 8 x 16 tile's corners, takes each window cell's max in
shared memory and reduces it into the output once; a corner outside the
window is reduced alone. ``ops/splat.py:dense_window_misses`` repeats the
window rule on the host: here it is run with K6a's tile and window
(``ops/maxwarp.py``, held against the kernel's source) on an integer shift
and a smooth field (no miss), a scattered flow (most corners miss) and the
Euler sentinel (no corner at all). K6b's lanes, and K6a's flush, walk an
index as (row, column) without a division a step; a Python transcription
of that walk is checked against divmod here, which guards the
transcription only. The kernels themselves are held bit for bit against
their plain versions on a card (tests/test_torch_gpu.py, chip_smoke.py
phase 25), which is what covers the kernels' walks.

``engine/profiler.py:StageProfiler`` defaults to the card, as every entry
point of the port does, and refuses a host without one; ``"cpu"`` is its
host-clock mode."""

import os
import re
import time

import numpy as np
import pytest
import torch

from slrsfs_tpu_torch import kernels
from slrsfs_tpu_torch.engine.profiler import StageProfiler
from slrsfs_tpu_torch.ops import maxwarp
from slrsfs_tpu_torch.ops.splat import dense_window_misses

torch.set_num_threads(1)

B, H, W = 2, 32, 32
TILE, CAP = maxwarp.MAX_SPLAT_TILE, maxwarp.MAX_SPLAT_WINDOW_CELLS


def _flow(kind: str, seed: int = 0) -> torch.Tensor:
    """(B, H, W, 2) f32: an integer shift, a smooth fractional field, or
    targets drawn uniformly over the grid."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    if kind == "integer shift":
        flow = np.broadcast_to(np.float32([3.0, -2.0]), (B, H, W, 2))
    elif kind == "smooth":
        flow = np.broadcast_to(np.stack([1.5 * np.sin(yy / 17.0) + 0.37,
                                         0.8 * np.cos(xx / 29.0) - 0.41], -1), (B, H, W, 2))
    else:
        flow = np.stack([rng.uniform(0.0, W - 1.0, (B, H, W)) - xx,
                         rng.uniform(0.0, H - 1.0, (B, H, W)) - yy], -1)
    return torch.from_numpy(np.ascontiguousarray(flow, dtype=np.float32))


def test_k6a_geometry_is_the_kernels():
    """MAX_SPLAT_TILE and MAX_SPLAT_WINDOW_CELLS are csrc/maxsplat.cu's
    kTileY, kTileX and kCells, and the source takes the window rule from
    splat_window.cuh (its build hash covers it); on a card chip_smoke.py
    phase 25 also holds them against the library's report."""
    with open(kernels.MAX_SPLAT._src_path) as f:
        src = f.read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert (const("kTileY"), const("kTileX")) == TILE and const("kCells") == CAP
    assert "splat_window::place_window(" in src
    assert os.path.join(os.path.dirname(kernels.MAX_SPLAT._src_path), "splat_window.cuh") \
        in kernels.source_files(kernels.MAX_SPLAT._src_path)


@pytest.mark.parametrize("kind", ["integer shift", "smooth"])
def test_k6a_window_holds_every_corner_of_a_coherent_flow(kind):
    """A tile's 512 corners meet in a few cells inside its window: no
    corner is reduced alone."""
    n_in, n_miss = dense_window_misses(_flow(kind), TILE, CAP)
    assert n_in > 0.75 * 4 * B * H * W and n_miss == 0


def test_k6a_window_misses_most_corners_of_a_scattered_flow():
    n_in, n_miss = dense_window_misses(_flow("scattered"), TILE, CAP)
    assert n_in == 4 * B * H * W  # every target inside, away from the edges
    assert n_miss > n_in / 2


def test_k6a_sentinel_contributes_no_corner():
    """The Euler sentinel max(H, W) + 1 puts all four corners off the grid:
    such pixels count no corner and move no window."""
    flow = _flow("smooth")
    n_in, n_miss = dense_window_misses(flow, TILE, CAP)
    flow[:, 8:16, 0:16] = max(H, W) + 1  # a whole 8 x 16 tile of each sample
    # those pixels' corners were all inside the grid: 4 a pixel go
    assert dense_window_misses(flow, TILE, CAP) == (n_in - 4 * B * 8 * 16, 0) and n_miss == 0
    flow[:, 17, 5] = max(H, W) + 1  # one pixel of a tile
    assert dense_window_misses(flow, TILE, CAP) == (n_in - 4 * B * (8 * 16 + 1), 0)
    assert dense_window_misses(torch.full_like(flow, max(H, W) + 1), TILE, CAP) == (0, 0)


def _walk(n: int, width: int, start: int, step: int):
    """A transcription of csrc/maxsplat.cu's walk without a division a
    step: index e from ``start`` by ``step`` below n as (row, column) of
    rows of ``width``, by q = step // width rows and rem columns a step
    (K6b's lanes over a run of C floats; K6a's flush, lanes over the
    window's cells)."""
    q, rem = step // width, step - (step // width) * width
    i, c = start // width, start - (start // width) * width
    for e in range(start, n, step):
        yield e, i, c
        i += q
        c += rem
        if c >= width:
            c -= width
            i += 1


@pytest.mark.parametrize("step", [32])
def test_kernel_walks_match_division(step):
    """The transcribed walk gives divmod(e, width) at every step, for every
    start a lane takes, and together the starts cover each index once: K6b
    at C = 1..69, 128 and 256 over its run of about 256 floats a warp,
    K6a's flush over windows 1..40 cells wide. It guards the transcription
    only; the GPU tests hold the kernels' results bit for bit."""
    for width in list(range(1, 70)) + [128, 256]:
        n = (32 if width == 1 else max(1, min(32, 256 // width))) * width + 3
        seen = []
        for start in range(step):
            for e, i, c in _walk(n, width, start, step):
                assert (i, c) == divmod(e, width), (width, start, e)
                seen.append(e)
        assert sorted(seen) == list(range(n))


def test_stage_profiler_defaults_to_the_card():
    """No silent host-clock timing of queued card work: on a host without a
    card the default raises with the CLIs' hint."""
    if torch.cuda.is_available():
        assert StageProfiler().cuda
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StageProfiler()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StageProfiler(torch.device("cuda"))


def test_stage_profiler_cpu_times_by_the_host_clock():
    prof = StageProfiler("cpu")
    assert not prof.cuda
    for _ in range(2):
        with prof.stage("t_decoder"):
            time.sleep(0.01)
    assert len(prof.times["t_decoder"]) == 2 and prof.sums()["t_decoder"] >= 0.02
