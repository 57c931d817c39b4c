"""Inference flow transform (the ``params=None, mode='nearest'`` form of
``slrsfs_tpu/data/transforms.py:transform_flow``, which the render CLI uses)."""

from __future__ import annotations

import numpy as np


def transform_flow(flow: np.ndarray, out_w: int, speed: float = 1.0) -> np.ndarray:
    """Scale a (H, W, 2) motion field to out_w² output pixels and resize it
    with torch ``F.interpolate``'s default 'nearest' rule (src = floor(dst ·
    in/out)), as the reference inference scripts do (test_baseline_4eval.py:173-184)."""
    flow = np.asarray(flow, np.float32)
    h, w = flow.shape[:2]
    scale = np.array([out_w / w, out_w / h], np.float32)
    flow = flow * scale * speed
    ys = np.floor(np.arange(out_w) * (h / out_w)).astype(int)
    xs = np.floor(np.arange(out_w) * (w / out_w)).astype(int)
    return flow[ys][:, xs]
