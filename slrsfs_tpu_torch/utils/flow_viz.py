"""Middlebury .flo reading (copy of ``slrsfs_tpu/utils/flow_viz.py:read_flo``)."""

from __future__ import annotations

import numpy as np

FLO_TAG = 202021.25


def read_flo(path: str) -> np.ndarray:
    """Read a Middlebury .flo file → (H, W, 2) float32."""
    with open(path, "rb") as f:
        tag = np.frombuffer(f.read(4), np.float32)[0]
        if tag != FLO_TAG:
            raise ValueError(f"bad .flo magic in {path}: {tag}")
        w = int(np.frombuffer(f.read(4), np.int32)[0])
        h = int(np.frombuffer(f.read(4), np.int32)[0])
        data = np.frombuffer(f.read(h * w * 2 * 4), np.float32)
    return data.reshape(h, w, 2).copy()
