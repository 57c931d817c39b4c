"""The stage-1 training dataset (port of ``slrsfs_tpu/data/datasets.py`` for
the ``eulerian_data`` variant, reference ``data/eulerian_data.py``).

Scene layout on disk, as the reference dataset release:
``<root>/<split>/XXXXX_YYYYY_gt.mp4`` and ``..._motion.{npz,npy,pth}``.
A sample is a (start, middle, end) frame triplet (start ∈ [0, N/3),
end ∈ [2N/3, N), middle ∈ [start, end)), a random square crop of up to
720², bicubic resize to W², an h-flip with the flow's x negated. Sampling
is a pure function of (seed, split, epoch, index) and draws the numbers the
JAX dataset draws. The mask, mean-video, hint and free-form-mask variants
come with their stages.
"""

from __future__ import annotations

import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np
from PIL import Image

from slrsfs_tpu_torch.config import Options
from slrsfs_tpu_torch.data.tensors import load_compressed_tensor, motion_to_hw2
from slrsfs_tpu_torch.data.transforms import (
    get_params,
    transform_flow,
    transform_image,
)
from slrsfs_tpu_torch.data.video import VideoReader

VARIANTS = ("eulerian_data",)
# decode threads and extra batches in flight (cv2, PIL and numpy release
# the GIL for the heavy parts)
WORKERS = 2
PREFETCH = 2


class LiquidDataset:
    """Per-sample dicts of NHWC numpy arrays; ``batches`` collates them."""

    def __init__(self, root: str, opt: Options, variant: str = "eulerian_data",
                 split: str = "train", seed: int = 0):
        if variant not in VARIANTS:
            raise NotImplementedError(
                f"dataset {variant!r} is not ported yet (ported: {VARIANTS}; "
                "ROADMAP §1, \"The rest of training\")")
        if opt.random_ff_mask:
            raise NotImplementedError(
                "the free-form occlusion mask is not ported yet (ROADMAP §1, "
                "\"The rest of training\")")
        self.root = root
        self.opt = opt
        self.seed = seed
        self.epoch = 0
        self._set_split(split)

    def _set_split(self, split: str) -> None:
        self.split = split
        self.isval = split != "train"
        d = os.path.join(self.root, split)
        self.scenes = sorted(x[:-7] for x in os.listdir(d) if x.endswith("_gt.mp4"))
        if not self.scenes:
            raise FileNotFoundError(f"no *_gt.mp4 scenes under {d}")

    def __len__(self) -> int:
        return max(2 ** 15, len(self.scenes))  # eulerian_data.py:59-60

    def totrain(self, epoch: int) -> None:
        self.epoch = epoch
        self._set_split("train")

    def toval(self, epoch: int) -> None:
        self.epoch = epoch
        self._set_split("validation")

    def _sample_rng(self, index: int) -> np.random.RandomState:
        """The JAX dataset's per-sample stream (datasets.py:96-105)."""
        mix = (self.seed * 0x9E3779B1 + self.epoch * 0x85EBCA77
               + index * 0xC2B2AE3D + (0x27D4EB2F if self.isval else 0)
               ) & 0x7FFFFFFF
        return np.random.RandomState(mix)

    def _load_motion(self, scene: str) -> np.ndarray:
        base = os.path.join(self.root, self.split, scene + "_motion")
        for ext in (".npz", ".npy", ".pth"):
            if os.path.exists(base + ext):
                return motion_to_hw2(load_compressed_tensor(base + ext))
        raise FileNotFoundError(base + ".{npz,npy,pth}")

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        W = self.opt.W
        rng = self._sample_rng(index)
        scene = self.scenes[rng.randint(len(self.scenes))]
        video = VideoReader(os.path.join(self.root, self.split, scene + "_gt.mp4"))
        try:
            # the reference crops 720² of its 1280x720 frames
            # (eulerian_data.py:26-27,63); smaller videos crop their short side
            crop = min(720, video.height, video.width)
            params = None if self.isval else get_params(
                rng, (video.width, video.height), crop)
            N = len(video)
            start = rng.randint(0, max(N // 3, 1))
            end = rng.randint(N // 3 * 2, N)
            middle = rng.randint(start, end)
            images = [transform_image(Image.fromarray(video[t]), W, params)
                      for t in (start, middle, end)]
        finally:
            video.close()
        flow = transform_flow(self._load_motion(scene), W, params,
                              mode="bilinear")
        return {"images": images, "motions": flow,
                "index": np.asarray([start, middle, end], np.int32)}

    def batches(self, batch_size: int, num_batches: Optional[int] = None
                ) -> Iterator[Dict]:
        """Collated batches in a fixed order, ``WORKERS`` threads decoding
        ahead (at most ``PREFETCH + WORKERS`` batches in flight)."""

        def make(i):
            samples = [self[i * batch_size + j] for j in range(batch_size)]
            return {"images": [np.stack([s["images"][v] for s in samples])
                               for v in range(3)],
                    "motions": np.stack([s["motions"] for s in samples]),
                    "index": np.stack([s["index"] for s in samples])}

        total = num_batches if num_batches is not None else len(self) // batch_size
        with ThreadPoolExecutor(max_workers=WORKERS) as ex:
            inflight: deque = deque()
            nxt = 0
            while nxt < total and len(inflight) < PREFETCH + WORKERS:
                inflight.append(ex.submit(make, nxt))
                nxt += 1
            while inflight:
                batch = inflight.popleft().result()
                if nxt < total:
                    inflight.append(ex.submit(make, nxt))
                    nxt += 1
                yield batch


def get_dataset(opt: Options, root: str, split: str = "train",
                **kw) -> LiquidDataset:
    return LiquidDataset(root, opt, variant=opt.dataset, split=split, **kw)
