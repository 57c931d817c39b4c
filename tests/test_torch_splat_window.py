"""The f32 window scatter's host side (slrsfs_tpu_torch), on the CPU.

K2, K8 and K3's forward place a window of cells over each unit's corners
(csrc/splat_window.cuh): the corners that meet in one window cell are
summed in registers and reduced into the cell once, and each corner
outside the window is reduced into its cell alone. K3's backward stages
the g rows of such a window (csrc/splat_dense.cu) and takes a tile with a
corner outside it pixel by pixel. ``ops/splat.py:place_windows`` repeats the kernel's
window rule in integers so that the share of those misses is counted on
the host; here it is held against a literal transcription of
``place_window`` over each unit, at ragged shapes, for both tilings. The
kernels' libraries are built from a source and the headers it includes:
``kernels.py`` hashes them all, so a changed header never loads a stale
build."""

import math

import numpy as np
import pytest
import torch

from slrsfs_tpu_torch import kernels
from slrsfs_tpu_torch.ops import splat as port_splat

torch.set_num_threads(1)


def _place_window(xs, ys, cap):
    """csrc/splat_window.cuh:place_window, line for line."""
    bx0, bx1, by0, by1 = min(xs), max(xs), min(ys), max(ys)
    sx, sy, n = sum(xs), sum(ys), len(xs)
    bw, bh = bx1 - bx0 + 1, by1 - by0 + 1
    lw = min(bw, math.isqrt(cap))
    rows = min(bh, cap // lw)
    lw = min(bw, cap // rows)
    ox = bx0 if bw <= lw else min(max(sx // n - lw // 2, bx0), bx1 - lw + 1)
    oy = by0 if bh <= rows else min(max(sy // n - rows // 2, by0), by1 - rows + 1)
    return ox, oy, lw, rows


def _unit_misses(points, cap):
    """(corners in the grid, outside the window) of one unit's in-grid
    corners ``points``."""
    if not points:
        return 0, 0
    if cap < 1:
        return len(points), len(points)
    xs, ys = zip(*points)
    ox, oy, lw, rows = _place_window(xs, ys, cap)
    return len(points), sum(not (0 <= x - ox < lw and 0 <= y - oy < rows)
                            for x, y in points)


def _corners(x, y, dx, dy, H, W):
    ox, oy = np.float32(x) + np.float32(dx), np.float32(y) + np.float32(dy)
    x0, y0 = math.floor(ox), math.floor(oy)
    return [(cx, cy) for cx, cy in ((x0, y0), (x0 + 1, y0), (x0, y0 + 1), (x0 + 1, y0 + 1))
            if 0 <= cx < W and 0 <= cy < H]


@pytest.mark.parametrize("cap", [0, 1, 7, 94, 1024])
@pytest.mark.parametrize("spread", [1.5, 40.0])
def test_dense_window_misses_follow_the_kernels_rule(spread, cap):
    H, W, ty, tx = 13, 19, 4, 8
    rng = np.random.default_rng(int(spread) + cap)
    flow = rng.uniform(-spread, spread, (2, H, W, 2)).astype(np.float32)
    flow[1, :3, :5] = max(H, W) + 1  # the OOB sentinel
    got = port_splat.dense_window_misses(torch.from_numpy(flow), (ty, tx), cap)
    n_in = n_miss = 0
    for b in range(2):
        for y0 in range(0, H, ty):
            for x0 in range(0, W, tx):
                pts = [c for y in range(y0, min(y0 + ty, H)) for x in range(x0, min(x0 + tx, W))
                       for c in _corners(x, y, *flow[b, y, x], H, W)]
                i, m = _unit_misses(pts, cap)
                n_in, n_miss = n_in + i, n_miss + m
    assert got == (n_in, n_miss)
    assert n_in > 0


@pytest.mark.parametrize("cap", [0, 9, 62])
@pytest.mark.parametrize("spread", [0.8, 6.0])
def test_dense_window_units_follow_the_kernels_rule(spread, cap):
    """K3's backward takes a 4 x 8 tile lanes over pixels when its window
    holds every in-grid corner of the tile, else pixel by pixel: the host
    counts the tiles of the second kind as a literal loop over the tiles
    does, on a ragged grid with sentinels and all-sentinel tiles."""
    H, W, ty, tx = 14, 21, 4, 8
    rng = np.random.default_rng(int(10 * spread) + cap)
    flow = rng.uniform(-spread, spread, (3, H, W, 2)).astype(np.float32)
    flow[2, :8, :16] = max(H, W) + 1  # four tiles with no corner in the grid
    flow[1, ::3] = np.round(flow[1, ::3])
    got = port_splat.dense_window_units(torch.from_numpy(flow), (ty, tx), cap)
    units = missing = 0
    for b in range(3):
        for y0 in range(0, H, ty):
            for x0 in range(0, W, tx):
                pts = [c for y in range(y0, min(y0 + ty, H)) for x in range(x0, min(x0 + tx, W))
                       for c in _corners(x, y, *flow[b, y, x], H, W)]
                units += 1
                missing += _unit_misses(pts, cap)[1] > 0
    assert got == (units, missing)
    if cap == 0:  # no window: every tile with a corner in the grid
        assert missing == units - 4


@pytest.mark.parametrize("cap", [0, 5, 94])
@pytest.mark.parametrize("ends", [1, 2])
def test_rows_window_misses_follow_the_kernels_rule(ends, cap):
    H, W, P, run = 11, 17, 45, 8
    rng = np.random.default_rng(ends * 10 + cap)
    pos = np.stack([rng.integers(0, W, P), rng.integers(0, H, P)], -1).astype(np.int32)
    val = (rng.uniform(size=P) > 0.2).astype(np.float32)
    disps = [rng.normal(0, 2.0, (P, 2)).astype(np.float32) for _ in range(ends)]
    disps[0][::6] = max(H, W) + 1
    got = port_splat.rows_window_misses(
        torch.from_numpy(pos), torch.from_numpy(val), [torch.from_numpy(d) for d in disps],
        H, W, run, cap)
    n_in = n_miss = 0
    for d in disps:
        for r0 in range(0, P, run):
            pts = [c for p in range(r0, min(r0 + run, P)) if val[p] != 0
                   for c in _corners(pos[p, 0], pos[p, 1], *d[p], H, W)]
            i, m = _unit_misses(pts, cap)
            n_in, n_miss = n_in + i, n_miss + m
    assert got == (n_in, n_miss)
    no_valid = port_splat.rows_window_misses(
        torch.from_numpy(pos), None, [torch.from_numpy(d) for d in disps], H, W, run, cap)
    assert no_valid[0] >= n_in


def test_a_smooth_unit_fits_its_window():
    """A 4 x 8 grid moved by a quarter pixel is one 4 x 8 tile: 105 of its
    128 corners stay in the grid (the rest fall off the right and bottom
    edges) and fill its 32 cells, which a window of 32 cells holds whole
    and one of 31 does not."""
    flow = torch.full((1, 4, 8, 2), 0.25)
    assert port_splat.dense_window_misses(flow, (4, 8), 32) == (105, 0)
    assert port_splat.dense_window_misses(flow, (4, 8), 31)[1] > 0


@pytest.mark.parametrize("name", ["splat.cu", "splat_dense.cu"])
def test_the_build_hash_covers_the_window_header(name):
    files = kernels.source_files(kernels.os.path.join(kernels._CSRC, name))
    # both sources also include the bf16 quarters (splat_quarters.cuh)
    assert [kernels.os.path.basename(f) for f in files] == [
        name, "splat_quarters.cuh", "splat_window.cuh"]


def test_a_changed_header_changes_the_library(tmp_path, monkeypatch):
    (tmp_path / "a.cu").write_text('#include "b.cuh"\n#include <cuda_runtime.h>\nint a;\n')
    (tmp_path / "b.cuh").write_text('#pragma once\n#include "c.cuh"\n')
    (tmp_path / "c.cuh").write_text("int c = 1;\n")
    (tmp_path / "d.cuh").write_text("int d = 1;\n")
    monkeypatch.setattr(kernels, "_CSRC", str(tmp_path))
    k = kernels.Kernel("a", "pkg/csrc/a.cu", "a", [])
    assert [p.rsplit("/", 1)[1] for p in kernels.source_files(k._src_path)] == [
        "a.cu", "b.cuh", "c.cuh"]
    first = k._lib_path()
    (tmp_path / "d.cuh").write_text("int d = 2;\n")  # not included: same build
    assert k._lib_path() == first
    (tmp_path / "c.cuh").write_text("int c = 2;\n")  # included by b.cuh: new build
    second = k._lib_path()
    assert second != first and second.endswith(".so")
    assert kernels.os.path.basename(second).startswith("a-")
