"""Host-side image and flow transforms (PIL for resize parity; port of
``slrsfs_tpu/data/transforms.py``, reference ``utils/utils.py:264-337``):
a random square crop, bicubic resize to W², h-flip with the flow's x
negated, optional colour jitter (PIL's ImageEnhance brightness, contrast
and colour, then a hue shift in HSV), normalise to [-1, 1].
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
from PIL import Image, ImageEnhance


def get_params(rng: np.random.RandomState, size: Tuple[int, int],
               crop_size: int, no_flip: bool = False,
               color_jitter: bool = False) -> Dict:
    """Crop position, flip and colour jitter of one training sample. Draws
    the numbers the JAX ``get_params`` draws from the same ``rng``, in its
    order: the crop, the flip (drawn under ``no_flip`` too), the jitter
    switch only with ``color_jitter``, then the four jitter parameters."""
    w, h = size
    x = rng.randint(0, max(0, w - crop_size) + 1)
    y = rng.randint(0, max(0, h - crop_size) + 1)
    flip = (rng.rand() > 0.5) and not no_flip
    cj = (rng.rand() > 0.5) if color_jitter else False
    return {"crop_pos": (int(x), int(y)), "crop_size": int(crop_size),
            "flip": bool(flip), "colorjitter": bool(cj),
            "colorjitter_params": {
                "brightness": float(rng.rand() * 0.2 + 1.0),
                "contrast": float(rng.rand() * 0.2 + 1.0),
                "saturation": float(rng.rand() * 0.2 + 1.0),
                "hue": float(rng.rand() * 0.05)}}


def _color_jitter(img: Image.Image, p: Dict) -> Image.Image:
    img = ImageEnhance.Brightness(img).enhance(p["brightness"])
    img = ImageEnhance.Contrast(img).enhance(p["contrast"])
    img = ImageEnhance.Color(img).enhance(p["saturation"])
    if p["hue"]:
        hsv = np.array(img.convert("HSV"), np.int16)
        hsv[..., 0] = (hsv[..., 0] + int(p["hue"] * 255)) % 256
        img = Image.fromarray(hsv.astype(np.uint8), "HSV").convert("RGB")
    return img


def transform_image(img: Image.Image, out_w: int,
                    params: Optional[Dict]) -> np.ndarray:
    """Train transform (crop → bicubic resize → flip → colour jitter →
    normalise) or, with ``params=None``, the validation transform (bilinear
    resize only, reference eulerian_data.py:47-53). Returns (W, W, 3)
    float32 NHWC in [-1, 1]."""
    img = img.convert("RGB")
    if params is None:
        img = img.resize((out_w, out_w), Image.BILINEAR)
    else:
        x, y = params["crop_pos"]
        cs = params["crop_size"]
        if img.size[0] > cs or img.size[1] > cs:
            img = img.crop((x, y, x + cs, y + cs))
        img = img.resize((out_w, out_w), Image.BICUBIC)
        if params["flip"]:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        if params["colorjitter"]:
            img = _color_jitter(img, params["colorjitter_params"])
    arr = np.asarray(img, np.float32) / 255.0
    return (arr - 0.5) / 0.5


def transform_flow(flow: np.ndarray, out_w: int, params: Optional[Dict] = None,
                   mode: str = "nearest", speed: float = 1.0) -> np.ndarray:
    """Crop/flip/scale/resize a (H, W, 2) motion field (reference
    eulerian_data.py:80-97 for training, test_baseline_4eval.py:173-184 for
    inference). Values scale by out_w / source size so displacements stay
    in output pixels; a flip negates x. ``mode`` 'bilinear' is cv2's
    INTER_LINEAR (torch's half-pixel bilinear, the training transform);
    'nearest' is torch ``F.interpolate``'s default rule, src = floor(dst ·
    in/out), which the render CLI uses."""
    flow = np.asarray(flow, np.float32)
    if params is not None:
        x, y = params["crop_pos"]
        cs = params["crop_size"]
        flow = flow[y:y + cs, x:x + cs]
        scale = np.array([out_w / cs, out_w / cs], np.float32)
        if params["flip"]:
            flow = flow[:, ::-1].copy()
            flow[..., 0] *= -1
    else:
        scale = np.array([out_w / flow.shape[1], out_w / flow.shape[0]],
                         np.float32)
    flow = flow * scale * speed
    if mode == "bilinear":
        import cv2

        return cv2.resize(flow, (out_w, out_w), interpolation=cv2.INTER_LINEAR)
    h, w = flow.shape[:2]
    ys = np.floor(np.arange(out_w) * (h / out_w)).astype(int)
    xs = np.floor(np.arange(out_w) * (w / out_w)).astype(int)
    return flow[ys][:, xs]
