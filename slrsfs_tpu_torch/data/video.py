"""Random-access video frames on OpenCV (port of
``slrsfs_tpu/data/video.py:VideoReader``): short training clips are
decoded sequentially up to the highest requested index and cached."""

from __future__ import annotations

from typing import Dict

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
