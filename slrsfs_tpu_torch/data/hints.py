"""Sparse-motion hint synthesis (PyTorch port of ``slrsfs_tpu/data/hints.py``),
on tensors, so that it runs on the renderer's device.

Reference algorithm (``test_animating/test_motion_4eval_rawsize_threshold.py
:163-219`` at inference, ``data/eulerian_data_motion_hint.py:218-292``
offline):

1. moving mask = motion speed > 0.2161635;
2. k-means over the (x, y) coordinates of the moving pixels → k centroid
   pixels (k = 5);
3. Gaussian-RBF densification: each centroid's motion spread with weight
   exp(-(d/σ)²), normalised by the weights' sum and masked to the moving
   region (σ = H/5).

The JAX package clusters with scikit-learn's ``KMeans(n_clusters=k,
n_init=10, random_state=seed)``; ``kmeans`` here is the same algorithm
(k-means++ seeding with 2 + ⌊ln k⌋ candidates a centre, Lloyd iterations
to a centre shift of 1e-4 of the points' mean per-axis variance or until
no label changes, 300 at most, empty clusters moved to the farthest
points, the lowest inertia of ``n_init`` runs kept) in float64 on any
device, without scikit-learn. Its random draws come from a numpy
generator built from ``seed``, on the host, so a run on the card picks the
centroids a run on the CPU picks: the points are integer pixels, so every
sum it decides on (the seeding potential, the centres' sums, the
inertia's) is exact in float64 in any order. Its draws are not
scikit-learn's, so on a region with several near-equal optima the two may
settle in different ones; on separated clusters they agree.
``synthesize_hint_online`` is the training-time variant of the motion GAN's
dataset (k and σ drawn per sample, reference
``eulerian_data_motion_hint.py:120-160``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

Tensor = torch.Tensor

SPEED_THRESHOLD = 0.2161635  # reference :128, test_motion_4eval_rawsize_threshold.py:174


def moving_mask_threshold(motion: Tensor) -> Tensor:
    """motion (H, W, 2) float32 → float32 mask (H, W): speed above
    ``SPEED_THRESHOLD``."""
    speed = torch.sqrt(motion[..., 0] * motion[..., 0] + motion[..., 1] * motion[..., 1])
    return (speed > SPEED_THRESHOLD).to(torch.float32)


def _sq_dist(pts: Tensor, centres: Tensor) -> Tensor:
    """(n, k) squared distances, elementwise (the same rounding on every
    device)."""
    d = pts[:, None, :] - centres[None, :, :]
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]


def _kmeans_pp(pts: Tensor, k: int, rng: np.random.Generator) -> Tensor:
    """k-means++ seeding (scikit-learn ``_kmeans_plusplus``): the first
    centre a uniform draw, each next the best of 2 + ⌊ln k⌋ candidates
    drawn in proportion to the squared distance to the nearest centre."""
    n = pts.shape[0]
    trials = 2 + int(math.log(k))
    centres = pts[int(rng.integers(n))][None]
    closest = _sq_dist(pts, centres)[:, 0]
    for _ in range(1, k):
        cum = torch.cumsum(closest, 0)
        pot = float(cum[-1])
        draws = torch.tensor(rng.random(trials) * pot, dtype=pts.dtype,
                             device=pts.device)
        ids = torch.searchsorted(cum, draws).clamp_(max=n - 1)
        cand = torch.minimum(closest[:, None], _sq_dist(pts, pts[ids]))
        best = int(np.argmin(cand.sum(0).cpu().numpy()))
        closest = cand[:, best].contiguous()
        centres = torch.cat([centres, pts[ids[best]][None]])
    return centres


def _lloyd(pts: Tensor, centres: Tensor, tol: float, max_iter: int = 300):
    """Lloyd iterations (scikit-learn ``_kmeans_single_lloyd``) → (labels
    (n,), inertia): each pass labels every point by its nearest centre and
    moves each centre to its points' mean; it stops when no label changed
    or the centres moved by at most ``tol`` in all (then relabels). An
    empty cluster takes the point farthest from its centre."""
    k = centres.shape[0]
    labels_old = None
    strict = False
    for _ in range(max_iter):
        d = _sq_dist(pts, centres)
        labels = torch.argmin(d, 1)
        counts = torch.bincount(labels, minlength=k).to(pts.dtype)
        sums = torch.zeros_like(centres).index_add_(0, labels, pts)
        empty = torch.nonzero(counts == 0)[:, 0].tolist()
        if empty:
            far = torch.topk(d.gather(1, labels[:, None])[:, 0], len(empty)).indices
            for j, i in zip(empty, far.tolist()):
                sums[labels[i]] -= pts[i]
                counts[labels[i]] -= 1
                sums[j], counts[j] = pts[i], 1
        new = sums / counts[:, None]
        shift = float(((new - centres) ** 2).sum())
        centres = new
        if labels_old is not None and torch.equal(labels, labels_old):
            strict = True
            break
        if shift <= tol:
            break
        labels_old = labels
    if not strict:
        labels = torch.argmin(_sq_dist(pts, centres), 1)
    return labels, _inertia(pts, labels, k)


def _cluster_sums(pts: Tensor, labels: Tensor, k: int):
    """Per cluster (count, coordinate sums, sums of squares) on the host;
    exact for integer points."""
    counts = torch.bincount(labels, minlength=k).cpu().numpy().astype(np.float64)
    s = torch.zeros((k, 2), dtype=pts.dtype, device=pts.device).index_add_(0, labels, pts)
    q = torch.zeros((k, 2), dtype=pts.dtype, device=pts.device).index_add_(
        0, labels, pts * pts)
    return counts, s.cpu().numpy(), q.cpu().numpy()


def _inertia(pts: Tensor, labels: Tensor, k: int) -> float:
    """The summed squared distance of each point to its cluster's mean,
    Σ (Σx² − (Σx)²/n), from exact sums in a fixed order on the host."""
    counts, s, q = _cluster_sums(pts, labels, k)
    return float(sum((q[j] - s[j] ** 2 / counts[j]).sum()
                     for j in range(k) if counts[j]))


def kmeans(pts: Tensor, k: int, seed: int = 0, n_init: int = 10) -> Tensor:
    """Cluster labels (n,) of the points (n, 2) float64: the run of lowest
    inertia among ``n_init`` k-means++ / Lloyd runs, drawn from
    ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    n = pts.shape[0]
    s, q = pts.sum(0).cpu().numpy(), (pts * pts).sum(0).cpu().numpy()
    tol = 1e-4 * float(np.mean(q / n - (s / n) ** 2))  # mean per-axis variance
    best, best_inertia = None, None
    for _ in range(n_init):
        labels, inertia = _lloyd(pts, _kmeans_pp(pts, k, rng), tol)
        if best_inertia is None or inertia < best_inertia:
            best, best_inertia = labels, inertia
    return best


def kmeans_hint_pixels(mask: Tensor, n_hints: int, seed: int = 0) -> np.ndarray:
    """Cluster the moving pixels' coordinates; (n, 2) int64 (x, y) centroid
    pixels on the host (each cluster's mean, cast with ``int()``,
    reference :139-144)."""
    ys, xs = torch.nonzero(mask, as_tuple=True)
    pts = torch.stack([xs, ys], 1).to(torch.float64)
    labels = kmeans(pts, n_hints, seed)
    counts, s, _ = _cluster_sums(pts, labels, n_hints)
    out = np.zeros((n_hints, 2), np.int64)
    for i in range(n_hints):
        out[i] = [int(s[i, 0] / counts[i]), int(s[i, 1] / counts[i])]
    return out


def densify_hints(motion: Tensor, hint_xy, sigma: float, mask: Tensor) -> Tensor:
    """Gaussian-RBF densification (reference :146-160) in float64. motion
    (H, W, 2), hint_xy (n, 2) int (x, y), mask (H, W) → float32 (H, W, 2)
    on motion's device."""
    H, W, _ = motion.shape
    f64 = dict(dtype=torch.float64, device=motion.device)
    gy, gx = torch.meshgrid(torch.arange(H, **f64), torch.arange(W, **f64),
                            indexing="ij")
    num = torch.zeros((H, W, 2), **f64)
    den = torch.zeros((H, W, 1), **f64)
    for x, y in np.asarray(hint_xy).tolist():
        dist = torch.sqrt((gx - x) ** 2 + (gy - y) ** 2)
        w = torch.exp(-((dist / sigma) ** 2))[..., None]
        num += w * motion[int(y), int(x)].to(torch.float64)
        den += w
    den[den == 0.0] = 1.0
    return (num / den * mask[..., None]).to(torch.float32)


def synthesize_hint(motion: Tensor, n_hints: int = 5, sigma: Optional[float] = None,
                    seed: int = 0, min_moving: int = 5) -> Tuple[Tensor, Tensor]:
    """motion (H, W, 2) float32 → (hint field (H, W, 2), moving mask (H, W)),
    both float32 on motion's device; the inference configuration (k = 5,
    σ = H/5) by default. Fewer than ``min_moving`` moving pixels give a
    zero hint."""
    H = motion.shape[0]
    mask = moving_mask_threshold(motion)
    if float(mask.sum()) < min_moving:
        return torch.zeros_like(motion), mask
    if sigma is None:
        sigma = H / 5.0
    hints = kmeans_hint_pixels(mask, n_hints, seed)
    return densify_hints(motion, hints, sigma, mask), mask


def synthesize_hint_online(motion: Tensor, rng: np.random.Generator
                           ) -> Tuple[Tensor, Tensor]:
    """The training-time variant (reference :132-160): k ∈ [1, 5] and
    σ ∈ [H/(2k), 2H/k) drawn from ``rng``, then the k-means seed; fewer
    than 10 moving pixels give a zero hint. motion (H, W, 2) float32 →
    (hint field (H, W, 2), moving mask (H, W))."""
    H = motion.shape[0]
    mask = moving_mask_threshold(motion)
    if float(mask.sum()) < 10:
        return torch.zeros_like(motion), mask
    k = int(1 + rng.integers(5))
    sigma = float(rng.integers(H // (k * 2), max(H // (k * 2) + 1, int(H / (k / 2.0)))))
    hints = kmeans_hint_pixels(mask, k, int(rng.integers(2 ** 31)))
    return densify_hints(motion, hints, sigma, mask), mask
