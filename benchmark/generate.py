"""The benchmark's traffic generators, driven by the mix files of
``benchmark/traffic/``. Both are seeded and use NumPy alone.

Every seed gets the same set of sizes: the band geometries and the frame
indices are listed in the mix file (or spread evenly over a range it
gives), and the seed picks only the image content, the flow's phases and
noise, and the order. So two seeds ask for the same work in another order.

``scene_pool``: CLAW-like scenes for the render sweep. Each is a W² image
and a smooth flow (the ``synthetic_scene`` field of ``chip_smoke.py``, with
seeded phases) inside a band of the listed geometry; elsewhere the flow is
estimation noise below the sparsifier's eps, so the render's default
sparsifier zeroes it (``tools/make_scenes.py``'s scene shape).

``batch_pool``: training batches of B samples at W², each sample a smooth
motion band of the listed area over noise below eps, random images in
[-1, 1] at N(0, 0.25), the (start, middle, end) frame indices, and what
the model type adds (``benchmark/models/<model_type>.train.py``
``batch_extras``: SLR's rock mask and mean video).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """A generator for one named use of a run's seed (any whole number)."""
    return np.random.default_rng([seed % (1 << 63), stream])


def smooth_flow(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """(h, w, 2) float32: ``chip_smoke.py:synthetic_scene``'s field with
    seeded phases, plus N(0, 0.05) noise."""
    ph = rng.uniform(0.0, 2.0 * np.pi, 3)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    flow = np.stack([1.5 * np.sin(yy / 17.0 + ph[0]) + 0.6 * np.cos(xx / 23.0 + ph[1]),
                     0.8 * np.cos(xx / 29.0 + ph[2]) + 0.3], axis=-1)
    flow += rng.normal(0.0, 0.05, flow.shape)
    return flow.astype(np.float32)


def sub_eps_noise(rng: np.random.Generator, h: int, w: int, eps: float) -> np.ndarray:
    """(h, w, 2) float32 motion slower than 0.9 eps, in random directions:
    what a flow estimator leaves on still pixels."""
    theta = rng.uniform(0.0, 2.0 * np.pi, (h, w)).astype(np.float32)
    speed = rng.uniform(0.0, 0.9 * eps, (h, w)).astype(np.float32)
    return np.stack([speed * np.cos(theta), speed * np.sin(theta)], -1)


def band_box(size: int, band) -> Tuple[int, int, int, int]:
    """(r0, r1, c0, c1) of a band [area, cols, row_offset, col_offset]:
    ``cols`` of the width, ``area / cols`` of the height, placed at the
    given fractions of the free rows and columns."""
    area, cols, roff, coff = band
    rows = min(0.95, area / cols)
    nr, nc = int(rows * size), int(cols * size)
    r0 = int(roff * (size - nr))
    c0 = int(coff * (size - nc))
    return r0, r0 + nr, c0, c0 + nc


def banded_flow(rng: np.random.Generator, size: int, band, eps: float) -> np.ndarray:
    """A smooth flow inside ``band`` over sub-eps noise elsewhere."""
    flow = sub_eps_noise(rng, size, size, eps)
    r0, r1, c0, c1 = band_box(size, band)
    flow[r0:r1, c0:c1] = smooth_flow(rng, size, size)[r0:r1, c0:c1]
    return flow


def balanced_order(rng: np.random.Generator, n: int, groups: int, cycles: int) -> List[int]:
    """``cycles`` passes over ``n`` slots sorted by size into ``groups``
    equal groups: each block of ``groups`` consecutive entries holds one
    slot of every group, so any prefix of the order asks for about the same
    mix of sizes. Slots are indices of a list sorted from small to large."""
    per = n // groups
    order: List[int] = []
    for _ in range(cycles):
        cols = [rng.permutation(per) + g * per for g in range(groups)]
        for i in range(per):
            block = [int(c[i]) for c in cols]
            order += [block[j] for j in rng.permutation(groups)]
    return order


def scene_pool(mix: Dict, seed: int) -> Dict:
    """The render sweep's scenes and order: {"images": [(W, W, 3) float32
    in [-1, 1]], "flows": [(W, W, 2) float32], "areas": [moving share of
    each band], "order": [scene index, ...]}. The bands are sorted by area."""
    size, n_frames = mix["W"], mix["n_frames"]
    eps = mix["sparsify_eps_times_n"] / n_frames
    bands = sorted(mix["bands"], key=lambda b: b[0])
    rng = rng_for(seed, 1)
    images, flows, areas = [], [], []
    for band in bands:
        cells = size // 16
        coarse = rng.uniform(0, 255, (cells, cells, 3))
        img = np.kron(coarse, np.ones((16, 16, 1))) + rng.normal(0, 8, (size, size, 3))
        img_u8 = np.clip(img, 0, 255).astype(np.uint8)
        images.append((img_u8.astype(np.float32) / 255.0 - 0.5) / 0.5)
        flows.append(banded_flow(rng, size, band, eps))
        r0, r1, c0, c1 = band_box(size, band)
        areas.append((r1 - r0) * (c1 - c0) / float(size * size))
    order = balanced_order(rng, len(bands), mix["order_groups"], mix["order_cycles"])
    return {"images": images, "flows": flows, "areas": areas, "order": order}


def rock_mask(size: int) -> np.ndarray:
    """(size, size) float32: one polygon over about a quarter of the frame."""
    from PIL import Image, ImageDraw

    poly = Image.new("L", (size, size), 0)
    ImageDraw.Draw(poly).polygon([(0.1 * size, 0.45 * size), (0.6 * size, 0.5 * size),
                                  (0.55 * size, 0.95 * size), (0.05 * size, 0.9 * size)],
                                 outline=1, fill=1)
    return np.asarray(poly, np.float32)


def batch_pool(mix: Dict, seed: int, extras: Callable = None) -> Dict:
    """The training cell's batches and their order: {"batches": [numpy
    batch, ...], "order": [batch index, ...], "areas": [moving share of
    each sample's band]}. Every batch holds one sample of each listed
    band, so every batch has the same largest moving set. ``extras(rng,
    B, size)`` gives each batch's further inputs, drawn from the pool's
    generator after its images."""
    B, size, T = mix["batch_size"], mix["W"], mix["n_steps"]
    eps = mix["sparsify_eps_times_t"] / T
    bands = mix["bands"]
    if len(bands) != B:
        raise ValueError(f"the mix lists {len(bands)} bands for a batch of {B}")
    lo, hi = mix["middle_index_range"]
    middles = np.linspace(lo, hi, B).round().astype(np.int32)
    rng = rng_for(seed, 2)
    batches = []
    for _ in range(mix["pool"]):
        rows = rng.permutation(B)
        motions = np.stack([banded_flow(rng, size, bands[i], eps) for i in rows])
        idx = np.zeros((B, 3), np.int32)
        idx[:, 1] = rng.permutation(middles)
        idx[:, 2] = T - 1
        batch = {"images": [(rng.standard_normal((B, size, size, 3)) * 0.25).astype(np.float32)
                            for _ in range(3)],
                 "index": idx, "motions": motions}
        if extras is not None:
            batch.update(extras(rng, B, size))
        batches.append(batch)
    order = [int(i) for i in rng.permutation(mix["pool"])]
    areas = []
    for band in bands:
        r0, r1, c0, c1 = band_box(size, band)
        areas.append((r1 - r0) * (c1 - c0) / float(size * size))
    return {"batches": batches, "order": order, "areas": areas}
