"""The training datasets (port of ``slrsfs_tpu/data/datasets.py``), the
reference's six loader variants (registry ``options/options.py:36-120``):

* ``eulerian_data``: three views and the motion (stage 1,
  ``data/eulerian_data.py``);
* ``eulerian_data_balanced1_mask``: plus the rock mask, the mean video and
  shallow-scene oversampling (stage 3);
* ``eulerian_data_bg``: two views by a biased draw and the mean video
  (stage 2, ``eulerian_data_bg.py``);
* ``eulerian_data_hint``: plus the precomputed ``*_sparse_motion.flo``
  hints (the embedded-motion stages);
* ``eulerian_data_mask_hint``: the hints and the rock mask;
* ``eulerian_data_motion_hint``: one view, the motion and hints
  synthesised online (``data/hints.py:synthesize_hint_online``) when
  ``use_online_hint``, else read from the ``.flo`` (the motion GAN).

Scene layout on disk, as the reference dataset release:
``<root>/<split>/XXXXX_YYYYY_gt.mp4`` and ``..._motion.{npz,npy,pth}``,
``<root>/avr_image/XXXXX_YYYYY.png`` (the mean video),
``<rock_label_root>/XXXXX_YYYYY.png.json`` (default ``<root>/rock_label``)
and ``<root>/imageset_shallow.npy`` (the shallow scenes' names). A sample is
a (start, middle, end) frame triplet (start ∈ [0, N/3), end ∈ [2N/3, N),
middle ∈ [start, end)), a random square crop of up to 720², bicubic resize
to W², an h-flip with the flow's x negated; the mask takes the same crop
and flip and a nearest resize. Sampling is a pure function of (seed,
split, epoch, index) and draws the numbers the JAX dataset draws, in its
order. Hints (``..._sparse_motion.flo``, or synthesised) take the flow's
crop, flip and bilinear resize. With ``random_ff_mask`` a training sample
(never a validation one) also carries ``ff_mask`` (W, W, 1), the
free-form occlusion keep-mask of ``data/augment.py``.
"""

from __future__ import annotations

import os
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np
from PIL import Image

from slrsfs_tpu_torch.config import Options
from slrsfs_tpu_torch.data.masks import rasterize_rock_label, transform_mask
from slrsfs_tpu_torch.data.tensors import load_compressed_tensor, motion_to_hw2
from slrsfs_tpu_torch.data.transforms import (
    get_params,
    transform_flow,
    transform_image,
)
from slrsfs_tpu_torch.data.video import VideoReader
from slrsfs_tpu_torch.utils.flow_viz import read_flo

VARIANTS = ("eulerian_data", "eulerian_data_balanced1_mask", "eulerian_data_bg",
            "eulerian_data_hint", "eulerian_data_motion_hint",
            "eulerian_data_mask_hint")
# decode threads and extra batches in flight (cv2, PIL and numpy release
# the GIL for the heavy parts)
WORKERS = 2
PREFETCH = 2


class LiquidDataset:
    """Per-sample dicts of NHWC numpy arrays; ``batches`` collates them."""

    def __init__(self, root: str, opt: Options, variant: str = "eulerian_data",
                 split: str = "train", seed: int = 0,
                 rock_label_root: Optional[str] = None, no_flip: bool = False):
        if variant not in VARIANTS:
            raise ValueError(f"unknown dataset {variant!r}; known: {VARIANTS}")
        self.root = root
        self.opt = opt
        self.seed = seed
        self.no_flip = no_flip
        self.epoch = 0
        self.rock_label_root = rock_label_root or os.path.join(root, "rock_label")
        self.with_mask = "mask" in variant
        self.with_mean = ("mask" in variant or "bg" in variant or opt.use_mean_video
                          or opt.MVloss > 0.0)
        self.with_hint = "hint" in variant
        self.online_hint = variant == "eulerian_data_motion_hint" and opt.use_online_hint
        self.single_view = "motion_hint" in variant
        self.two_view = variant == "eulerian_data_bg"
        # shallow-scene oversampling list (eulerian_data_balanced1_mask.py:75-85)
        self.shallow: Optional[np.ndarray] = None
        shallow_path = os.path.join(root, "imageset_shallow.npy")
        if "balanced" in variant and os.path.exists(shallow_path):
            self.shallow = np.load(shallow_path, allow_pickle=True)
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

    def _pick_scene(self, rng: np.random.RandomState) -> str:
        """A shallow scene with odds (balanced_weight − 1)/balanced_weight
        when the list exists and the split is train, else any scene."""
        if (self.shallow is not None and not self.isval
                and rng.randint(self.opt.balanced_weight) > 0):
            return str(self.shallow[rng.randint(len(self.shallow))])
        return self.scenes[rng.randint(len(self.scenes))]

    def _load_motion(self, scene: str) -> np.ndarray:
        base = os.path.join(self.root, self.split, scene + "_motion")
        for ext in (".npz", ".npy", ".pth"):
            if os.path.exists(base + ext):
                return motion_to_hw2(load_compressed_tensor(base + ext))
        raise FileNotFoundError(base + ".{npz,npy,pth}")

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        W = self.opt.W
        rng = self._sample_rng(index)
        scene = self._pick_scene(rng)
        video = VideoReader(os.path.join(self.root, self.split, scene + "_gt.mp4"))
        try:
            # the reference crops 720² of its 1280x720 frames
            # (eulerian_data.py:26-27,63); smaller videos crop their short side
            crop = min(720, video.height, video.width)
            params = None if self.isval else get_params(
                rng, (video.width, video.height), crop, no_flip=self.no_flip)
            N = len(video)
            start = rng.randint(0, max(N // 3, 1))
            end = rng.randint(N // 3 * 2, N)
            middle = rng.randint(start, end)
            if self.two_view:
                # the biased two-view draw (eulerian_data_bg.py:81-82)
                pair = rng.randint(0, N, size=2)
                start, end = int(pair.min()), int(pair.max())
                middle = end
            views = ([start] if self.single_view else
                     [start, end] if self.two_view else [start, middle, end])
            images = [transform_image(Image.fromarray(video[t]), W, params)
                      for t in views]
        finally:
            video.close()
        motion = self._load_motion(scene)
        item = {"images": images,
                "motions": transform_flow(motion, W, params, mode="bilinear"),
                "index": np.asarray([start, middle, end], np.int32)}
        if self.with_mean:
            mv = Image.open(os.path.join(self.root, "avr_image", scene + ".png"))
            item["mean_video"] = transform_image(mv, W, params)
        if self.with_mask:
            raw = rasterize_rock_label(
                os.path.join(self.rock_label_root, scene + ".png.json"),
                motion.shape[:2])
            item["mask_rock"] = transform_mask(raw, W, params)[..., None]
        if self.with_hint:
            if self.online_hint:
                import torch

                from slrsfs_tpu_torch.data.hints import synthesize_hint_online

                hint_raw, _ = synthesize_hint_online(
                    torch.from_numpy(motion), np.random.default_rng(rng.randint(2 ** 31)))
                hint_raw = hint_raw.numpy()
            else:
                hint_raw = read_flo(os.path.join(self.root, self.split,
                                                 scene + "_sparse_motion.flo"))
            item["hints"] = transform_flow(hint_raw, W, params, mode="bilinear")
        if self.opt.random_ff_mask and not self.isval:
            # the free-form occlusion keep-mask on the splatted features,
            # training batches only (reference --random_ff_mask and its rate,
            # train_options.py:569-574; JAX datasets.py:177-185)
            from slrsfs_tpu_torch.data.augment import ff_keep_mask

            item["ff_mask"] = ff_keep_mask(np.random.default_rng(rng.randint(2 ** 31)), W, W,
                                           rate=self.opt.random_ff_mask_rate)
        return item

    def batches(self, batch_size: int, num_batches: Optional[int] = None
                ) -> Iterator[Dict]:
        """Collated batches in a fixed order, ``WORKERS`` threads decoding
        ahead (at most ``PREFETCH + WORKERS`` batches in flight)."""

        def make(i):
            samples = [self[i * batch_size + j] for j in range(batch_size)]
            return {k: [np.stack([s[k][v] for s in samples])
                        for v in range(len(samples[0][k]))]
                    if k == "images" else np.stack([s[k] for s in samples])
                    for k in samples[0]}

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
    """The dataset ``opt.dataset`` names (reference ``options/options.py:
    36-120``); an unknown name is a ``ValueError``."""
    return LiquidDataset(root, opt, variant=opt.dataset, split=split, **kw)
