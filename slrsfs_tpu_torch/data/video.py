"""Random-access video frames on OpenCV and the mean-video tool (port of
``slrsfs_tpu/data/video.py``): short training clips are decoded
sequentially up to the highest requested index and cached;
``compute_mean_video`` is reference ``data/average_gt_video.py``."""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


class VideoReader:
    """(H, W, 3) uint8 RGB frames of a video file."""

    def __init__(self, path: str):
        import cv2

        self.path = path
        self._cv2 = cv2
        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            raise IOError(f"cannot open video: {path}")
        self._n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.height = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        self.width = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        cap.release()
        self._cache: Dict[int, np.ndarray] = {}
        self._next = 0
        self._cap = None

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, idx: int) -> np.ndarray:
        if idx < 0:
            idx += self._n
        if idx not in self._cache:
            cv2 = self._cv2
            if self._cap is None or idx < self._next:
                if self._cap is not None:
                    self._cap.release()
                self._cap = cv2.VideoCapture(self.path)
                self._next = 0
            while self._next <= idx:
                ok, frame = self._cap.read()
                if not ok:
                    raise IndexError(f"frame {idx} beyond end of {self.path}")
                self._cache[self._next] = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB)
                self._next += 1
        return self._cache[idx]

    def close(self) -> None:
        if self._cap is not None:
            self._cap.release()
            self._cap = None
        self._cache.clear()


def compute_mean_video(video_path: str,
                       max_frames: Optional[int] = None) -> np.ndarray:
    """The temporal mean of a video's frames (at most ``max_frames``),
    summed in float64, → (H, W, 3) uint8 (reference
    ``data/average_gt_video.py``)."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    acc, n = None, 0
    try:
        while max_frames is None or n < max_frames:
            ok, frame = cap.read()
            if not ok:
                break
            f = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB).astype(np.float64)
            acc = f if acc is None else acc + f
            n += 1
    finally:
        cap.release()
    if acc is None:
        raise IOError(f"no frames in {video_path}")
    return np.clip(acc / n, 0, 255).astype(np.uint8)


def write_mean_videos(data_dir: str, out_dir: str, split: str = "train") -> None:
    """``<data_dir>/<split>/<scene>_gt.mp4`` → ``<out_dir>/<scene>.png``, the
    mean video of each scene (SLR's background target)."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    vids = sorted(x for x in os.listdir(os.path.join(data_dir, split))
                  if x.endswith("_gt.mp4"))
    for v in vids:
        mean = compute_mean_video(os.path.join(data_dir, split, v))
        Image.fromarray(mean).save(os.path.join(out_dir, v[:-len("_gt.mp4")] + ".png"))
