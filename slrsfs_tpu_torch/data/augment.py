"""Free-form occlusion mask augmentation, on the host (port of
``slrsfs_tpu/data/augment.py``; reference ``random_ff_mask``,
animating_softmax_splating.py:413-443).

Random polyline brush strokes drawn with ``cv2.line``; in training the
splatted features are multiplied by the keep-mask ``1 - mask`` with
probability ``random_ff_mask_rate``, so the partial-conv decoder learns to
fill synthetic holes. The models read it as ``batch['ff_mask']``. Both
functions draw from a numpy ``Generator`` in the JAX package's order, so
the same generator state gives the same mask.
"""

from __future__ import annotations

import numpy as np


def random_ff_mask(rng: np.random.Generator, h: int, w: int, max_vertices: int = 8,
                   max_angle: float = 4.0, max_length: int = 40,
                   max_brush_width: int = 10) -> np.ndarray:
    """(h, w) float32 stroke mask in {0, 1}, 1 where occluded."""
    import cv2

    mask = np.zeros((h, w), np.float32)
    num_v = 5 + int(rng.integers(max_vertices))
    for i in range(num_v):
        start_x = int(rng.integers(w))
        start_y = int(rng.integers(h))
        for _ in range(1 + int(rng.integers(5))):
            angle = 0.01 + rng.random() * max_angle
            if i % 2 == 0:
                angle = 2 * np.pi - angle
            length = int(rng.integers(max_length)) + 1
            brush = int(rng.integers(max_brush_width)) + 1
            end_x = int(start_x + length * np.sin(angle))
            end_y = int(start_y + length * np.cos(angle))
            # the reference passes (y, x) to cv2.line (:440); kept
            cv2.line(mask, (start_y, start_x), (end_y, end_x), 1.0, brush)
            start_x, start_y = end_x, end_y
    return mask


def ff_keep_mask(rng: np.random.Generator, h: int, w: int, rate: float = 0.5,
                 **kw) -> np.ndarray:
    """(h, w, 1) float32 keep-mask: ``1 - random_ff_mask`` with probability
    ``rate``, else all ones (reference :680-688)."""
    if rng.random() < rate:
        return (1.0 - random_ff_mask(rng, h, w, **kw))[..., None]
    return np.ones((h, w, 1), np.float32)
