"""Rock-label rasterisation (port of ``slrsfs_tpu/data/masks.py``, reference
``data/eulerian_data_balanced1_mask.py:103-124``): each entry of a label's
``step_1.result`` is a ``pointList`` polygon, drawn by PIL with outline and
fill 1; the polygons are unioned.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import numpy as np
from PIL import Image, ImageDraw


def rasterize_rock_label(label_path: str,
                         fallback_hw: Tuple[int, int]) -> np.ndarray:
    """(H, W) float32 mask in {0, 1}; zeros of ``fallback_hw`` when the
    label file is absent."""
    if not os.path.exists(label_path):
        return np.zeros(fallback_hw, np.float32)
    with open(label_path) as f:
        label = json.load(f)
    width, height = label["width"], label["height"]
    mask = np.zeros((height, width), np.float32)
    for result in label["step_1"]["result"]:
        polygon = [(p["x"], p["y"]) for p in result["pointList"]]
        m = Image.new("L", (width, height), 0)
        ImageDraw.Draw(m).polygon(polygon, outline=1, fill=1)
        mask += np.asarray(m, np.float32)
    return np.clip(mask, 0.0, 1.0)


def transform_mask(mask: np.ndarray, out_w: int, params: Optional[Dict]
                   ) -> np.ndarray:
    """The training crop and flip of a (H, W) mask, then a nearest resize
    to ``out_w``² (reference :155-163)."""
    if params is not None:
        x, y = params["crop_pos"]
        cs = params["crop_size"]
        mask = mask[y:y + cs, x:x + cs]
        if params["flip"]:
            mask = mask[:, ::-1]
    h, w = mask.shape
    ys = np.floor(np.arange(out_w) * (h / out_w)).astype(int)
    xs = np.floor(np.arange(out_w) * (w / out_w)).astype(int)
    return np.ascontiguousarray(mask[ys][:, xs], dtype=np.float32)
