"""Bytes and operations of K2, K3 and K7 from their shapes, copied from
``chip_smoke.py`` (``k2_times``, ``k3_fwd_times``, ``k3_bwd_times``,
``k7_times``, ``k7_gathers``). Each returns ``peaks.bound``'s (least
seconds, which bound) for one call; every one of these is bound by bytes
at the benchmark's shapes except K7, whose bound is its lane-instructions.
"""

from __future__ import annotations

import torch

from benchmark.roofline.peaks import LANE_OPS, bound


def k2(n_valid: int, P: int, h: int, w: int, C1: int, elem_bytes: int):
    """K2 (``splat_dual_normalize``), one frame: the moving rows, positions
    and both displacements of the valid rows, the valid flags of all rows,
    the static identity in and the f32 field out; per valid row and end a
    scale and 4 multiply-adds a channel, per output a division."""
    C = C1 - 1
    return bound(n_valid * (C1 * elem_bytes + 8 + 16) + P * 4
                 + h * w * C1 * elem_bytes + h * w * C * 4,
                 2 * n_valid * C1 * (1 + 4 * 2) + h * w * C)


def k3_fwd(B: int, H: int, W: int, C: int):
    """K3's forward in f32: inp and flow in, out out; per pixel ~20
    operations of corner math and per channel 4 multiplies and 4 adds."""
    n = B * H * W
    return bound(n * C * 4 * 2 + n * 8, n * (8 * C + 20))


def k3_bwd(B: int, H: int, W: int, C: int):
    """K3's backward in f32: inp, flow and g in, grad_inp and grad_flow out;
    per channel and corner 2 multiply-adds."""
    n = B * H * W
    return bound(n * C * 4 * 3 + n * 8 * 2, n * (16 * C + 40))


def k7(B: int, H: int, W: int, steps: int):
    """K7's forward: motion and counts in, both displacement fields out;
    ~20 lane-instructions a trajectory step, for the steps these inputs
    need (``k7_steps``)."""
    return bound(B * H * W * 8 + B * 8 + 2 * B * H * W * 8, steps * 20, peak=LANE_OPS)


@torch.no_grad()
def k7_steps(m: torch.Tensor, tf_b, tp_b, T: int, pos=None, val=None) -> int:
    """The trajectory steps K7's loops run on these inputs (the grid's
    pixels, or the rows of ``pos`` whose ``val`` is not 0): for each
    trajectory whose source moves and each phase that latches, its steps up
    to and including the first that leaves the frame."""
    B, H_, W_, _ = m.shape
    total = torch.zeros((), dtype=torch.int64, device=m.device)
    ys, xs = torch.meshgrid(torch.arange(H_, device=m.device),
                            torch.arange(W_, device=m.device), indexing="ij")
    grid = torch.stack([xs, ys], -1).reshape(-1, 2).to(m.dtype)
    for b in range(B):
        mb = m[b].reshape(-1, 2)
        src = grid if pos is None else pos[b][val[b] != 0].to(m.dtype)
        tf, tp = int(tf_b[b]), int(tp_b[b])
        for sign, steps, latches in ((1.0, tf, 1 <= tf <= T),
                                     (-1.0, tf + tp - max(tf, 0), tp > 0 and 1 <= tf + tp <= T)):
            if not latches:
                continue
            d = src.clone()
            at = src.long()
            moving = (mb[at[:, 1] * W_ + at[:, 0]] != 0).any(1)
            for _ in range(steps):
                total += moving.sum()
                ix = torch.round(d[:, 0]).long().clamp(0, W_ - 1)
                iy = torch.round(d[:, 1]).long().clamp(0, H_ - 1)
                nd = d + mb[iy * W_ + ix] * sign
                inside = ~((nd[:, 0] > W_ - 1) | (nd[:, 0] < 0) | (nd[:, 1] > H_ - 1)
                           | (nd[:, 1] < 0))
                d = torch.where(moving[:, None], nd, d)
                moving = moving & inside
    return int(total)
