"""Middlebury .flo I/O and the optical-flow colour wheel (port of
``slrsfs_tpu/utils/flow_viz.py``; reference ``utils/flow_utils.py``
readFlow/writeFlow :8-58, flow2img :73-205)."""

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


def write_flo(path: str, flow: np.ndarray) -> None:
    """Write (H, W, 2) float32 → Middlebury .flo: the tag, width, height,
    then the rows."""
    flow = np.asarray(flow, np.float32)
    if flow.ndim != 3 or flow.shape[-1] != 2:
        raise ValueError(f"a .flo holds (H, W, 2) flow, got {flow.shape}")
    with open(path, "wb") as f:
        f.write(np.float32(FLO_TAG).tobytes())
        f.write(np.int32(flow.shape[1]).tobytes())
        f.write(np.int32(flow.shape[0]).tobytes())
        f.write(np.ascontiguousarray(flow).tobytes())


def _color_wheel() -> np.ndarray:
    """The Middlebury colour wheel, (55, 3) in [0, 255]: red-yellow 15,
    yellow-green 6, green-cyan 4, cyan-blue 11, blue-magenta 13,
    magenta-red 6."""
    segments = ((15, 0, 1, True), (6, 1, 0, False), (4, 1, 2, True),
                (11, 2, 1, False), (13, 2, 0, True), (6, 0, 2, False))
    rows = []
    for n, full, ramp, rising in segments:
        seg = np.zeros((n, 3))
        seg[:, full] = 255
        step = np.floor(255 * np.arange(n) / n)
        seg[:, ramp] = step if rising else 255 - step
        rows.append(seg)
    return np.concatenate(rows)


def flow_to_image(flow: np.ndarray) -> np.ndarray:
    """(H, W, 2) flow → (H, W, 3) uint8 colour-wheel image, normalised by
    the largest magnitude; non-finite vectors are black."""
    u = flow[..., 0].astype(np.float64)
    v = flow[..., 1].astype(np.float64)
    bad = ~(np.isfinite(u) & np.isfinite(v))
    u = np.where(bad, 0, u)
    v = np.where(bad, 0, v)
    maxrad = max(np.sqrt(u ** 2 + v ** 2).max(), 1e-8)
    u, v = u / maxrad, v / maxrad

    wheel = _color_wheel() / 255.0
    n = wheel.shape[0]
    rad = np.sqrt(u ** 2 + v ** 2)
    fk = (np.arctan2(-v, -u) / np.pi + 1.0) / 2.0 * (n - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % n
    f = fk - k0
    col = (1 - f)[..., None] * wheel[k0] + f[..., None] * wheel[k1]
    inside = (rad <= 1)[..., None]
    col = np.where(inside, 1 - rad[..., None] * (1 - col), col * 0.75)
    col = np.where(bad[..., None], 0, col)
    return np.floor(255.0 * col).astype(np.uint8)
