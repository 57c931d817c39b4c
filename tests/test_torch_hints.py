"""The port's hint synthesis against the JAX package's (which clusters with
scikit-learn), on numpy-seeded motion fields:

* the moving mask: exact;
* the RBF densification of the same centroids: 1e-6;
* the centroid pixels on five separated moving blobs: equal (the order of
  the clusters aside), and ``synthesize_hint`` as a whole there: the same
  mask, the field within 1e-6;
* one contiguous irregular moving region, where k-means has near-equal
  optima: the port's inertia within 1e-3 (relative) of scikit-learn's;
* fewer than 5 moving pixels: a zero hint, as in JAX.

That the clustering picks the same centroids on the card as on the CPU
is held by chip_smoke.py on its 768² scene."""

import numpy as np
import pytest
import torch

from slrsfs_tpu.data import hints as jax_hints
from slrsfs_tpu_torch.data import hints as port_hints

torch.set_num_threads(1)


def blobs_motion(H: int = 64, W: int = 80, seed: int = 0) -> np.ndarray:
    """Five separated discs of smooth motion above the speed threshold,
    still (exactly 0) elsewhere, with a little noise on the moving pixels."""
    rng = np.random.default_rng(seed)
    motion = np.zeros((H, W, 2), np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    centres = [(0.2, 0.2), (0.2, 0.75), (0.55, 0.5), (0.85, 0.2), (0.85, 0.8)]
    for i, (cy, cx) in enumerate(centres):
        disc = (yy - cy * H) ** 2 + (xx - cx * W) ** 2 < (0.09 * min(H, W)) ** 2 * (1 + i % 2)
        motion[disc] = [1.0 + 0.3 * i, -0.5 + 0.2 * i]
    moving = np.any(motion != 0, -1)
    motion[moving] += rng.normal(0, 0.05, (int(moving.sum()), 2)).astype(np.float32)
    return motion


def region_mask(H: int = 96, W: int = 96, seed: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    mask = np.zeros((H, W), np.float32)
    mask[20:70, 10:80] = 1.0
    mask[rng.random((H, W)) < 0.1] = 0.0
    return mask


def _pixels(a) -> list:
    return sorted(map(tuple, np.asarray(a).tolist()))


def test_moving_mask_matches_jax():
    m = (np.random.default_rng(3).standard_normal((33, 41, 2)) * 0.2).astype(np.float32)
    want = jax_hints.moving_mask_threshold(m)
    got = port_hints.moving_mask_threshold(torch.from_numpy(m)).numpy()
    assert 0 < want.mean() < 1
    np.testing.assert_array_equal(got, want)


def test_densify_hints_matches_jax():
    m = blobs_motion()
    mask = jax_hints.moving_mask_threshold(m)
    xy = np.array([[5, 9], [40, 31], [77, 60], [12, 50], [60, 3]])
    want = jax_hints.densify_hints(m, xy, 64 / 5.0, mask)
    got = port_hints.densify_hints(torch.from_numpy(m), xy, 64 / 5.0,
                                   torch.from_numpy(mask)).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 7])
def test_kmeans_on_separated_blobs_matches_sklearn(seed):
    m = blobs_motion(seed=seed)
    mask = jax_hints.moving_mask_threshold(m)
    want = jax_hints.kmeans_hint_pixels(mask, 5, seed)
    got = port_hints.kmeans_hint_pixels(torch.from_numpy(mask), 5, seed)
    assert got.dtype == np.int64 and got.shape == (5, 2)
    assert _pixels(got) == _pixels(want)


def test_synthesize_hint_on_blobs_matches_jax():
    m = blobs_motion()
    want_hint, want_mask = jax_hints.synthesize_hint(m)
    got_hint, got_mask = port_hints.synthesize_hint(torch.from_numpy(m))
    np.testing.assert_array_equal(got_mask.numpy(), want_mask)
    np.testing.assert_allclose(got_hint.numpy(), want_hint, rtol=0, atol=1e-6)
    assert np.abs(want_hint).max() > 0.5


def test_kmeans_inertia_on_a_region_near_sklearn():
    from sklearn.cluster import KMeans

    ys, xs = np.nonzero(region_mask())
    pts = np.stack([xs, ys], 1).astype(np.float64)
    want = KMeans(n_clusters=5, n_init=10, random_state=0).fit(pts).inertia_
    labels = port_hints.kmeans(torch.from_numpy(pts), 5, seed=0)
    got = port_hints._inertia(torch.from_numpy(pts), labels, 5)
    assert abs(got - want) <= 1e-3 * want, (got, want)


def test_too_few_moving_pixels_give_a_zero_hint():
    m = np.zeros((16, 16, 2), np.float32)
    m[3, 4] = [1.0, 0.0]
    m[9, 9] = [0.0, -2.0]
    want_hint, want_mask = jax_hints.synthesize_hint(m)
    got_hint, got_mask = port_hints.synthesize_hint(torch.from_numpy(m))
    assert not got_hint.any() and not want_hint.any()
    np.testing.assert_array_equal(got_mask.numpy(), want_mask)
