"""The rest of the port's data API against the JAX package on the CPU:
``get_params`` with ``no_flip`` and ``color_jitter``, ``transform_image``'s
colour jitter, ``LiquidDataset(no_flip=...)``, ``save_motion`` and
``lz4f.compress``.

The random stream is the contract: in all four combinations of the two
flags both packages draw the same numbers in the same order from one
``RandomState`` (JAX draws the flip under ``no_flip`` too, the jitter
switch only with ``color_jitter``, and the four jitter parameters always),
so the dicts, the images (bit for bit, PIL on both sides) and the stream's
state after the call are equal. Files each package writes are read by the
other."""

import dataclasses
import itertools
import pickle

import numpy as np
import pytest
import torch
from PIL import Image

from slrsfs_tpu.config import Options as JaxOptions
from slrsfs_tpu.data import lz4f as jax_lz4f
from slrsfs_tpu.data import tensors as jax_tensors
from slrsfs_tpu.data import transforms as jax_transforms
from slrsfs_tpu.data.datasets import LiquidDataset as JaxLiquidDataset
from slrsfs_tpu_torch.config import Options
from slrsfs_tpu_torch.data import lz4f, tensors, transforms
from slrsfs_tpu_torch.data.datasets import LiquidDataset

torch.set_num_threads(1)

FLAGS = list(itertools.product([False, True], repeat=2))  # (no_flip, color_jitter)


def _same_state(a: np.random.RandomState, b: np.random.RandomState) -> bool:
    sa, sb = a.get_state(), b.get_state()
    return np.array_equal(sa[1], sb[1]) and sa[2:] == sb[2:]


@pytest.mark.parametrize("no_flip,color_jitter", FLAGS)
def test_get_params_and_transform_image_match_jax(no_flip, color_jitter):
    """Twelve draws on a 50 x 36 image cropped to 30 and resized to 24: the
    same dict, the same image and the same stream state; with the jitter on,
    both outcomes of its switch and of the flip occur."""
    img = Image.fromarray(np.random.default_rng(1).integers(
        0, 255, (36, 50, 3), dtype=np.uint8))
    seen = set()
    for seed in range(12):
        rj, rp = np.random.RandomState(seed), np.random.RandomState(seed)
        want = jax_transforms.get_params(rj, (50, 36), 30, no_flip=no_flip,
                                         color_jitter=color_jitter)
        got = transforms.get_params(rp, (50, 36), 30, no_flip=no_flip,
                                    color_jitter=color_jitter)
        assert got == want
        assert _same_state(rj, rp)
        seen.add((got["flip"], got["colorjitter"]))
        np.testing.assert_array_equal(transforms.transform_image(img, 24, got),
                                      jax_transforms.transform_image(img, 24, want))
    assert {f for f, _ in seen} == ({False} if no_flip else {False, True})
    assert {c for _, c in seen} == ({False, True} if color_jitter else {False})


def test_color_jitter_changes_the_image():
    """The jitter is not a no-op: each enhancement and the hue shift move
    the pixels, as JAX's ``_color_jitter`` does."""
    img = Image.fromarray(np.random.default_rng(2).integers(
        0, 255, (16, 16, 3), dtype=np.uint8))
    params = {"brightness": 1.15, "contrast": 1.1, "saturation": 1.05, "hue": 0.04}
    got = np.asarray(transforms._color_jitter(img, params))
    np.testing.assert_array_equal(
        got, np.asarray(jax_transforms._color_jitter(img, params)))
    assert not np.array_equal(got, np.asarray(img))


def test_liquid_dataset_no_flip_matches_jax(fixture_root):
    """``LiquidDataset(no_flip=True)``: samples identical to JAX's, and no
    training sample flipped (the flow's x is never negated: the fixture's
    motion is +1 in x)."""
    jopt = JaxOptions(W=32)
    opt = Options(**dataclasses.asdict(jopt))
    jd = JaxLiquidDataset(fixture_root, jopt, split="train", seed=5, no_flip=True)
    pd = LiquidDataset(fixture_root, opt, split="train", seed=5, no_flip=True)
    for i in range(4):
        want, got = jd[i], pd[i]
        for v in range(3):
            np.testing.assert_array_equal(got["images"][v], want["images"][v])
        for k in set(want) - {"images", "isval"}:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert (got["motions"][..., 0] >= 0).all()


def test_save_motion_round_trips_between_packages(tmp_path):
    flow = np.random.default_rng(3).standard_normal((6, 9, 2)).astype(np.float32)
    mine, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    tensors.save_motion(mine, flow)
    jax_tensors.save_motion(theirs, flow)
    np.testing.assert_array_equal(jax_tensors.load_compressed_tensor(mine), flow)
    np.testing.assert_array_equal(tensors.load_compressed_tensor(theirs), flow)
    assert list(np.load(mine).files) == list(np.load(theirs).files) == ["flow"]
    with pytest.raises(ValueError, match="H, W, 2"):
        tensors.save_motion(str(tmp_path / "bad.npz"), flow[..., :1])


def test_lz4_compress_round_trips_between_packages(tmp_path):
    """A reference-style motion file (an lz4 frame of a pickled (2, H, W)
    tensor) written by each package's ``compress`` loads through the other
    package's ``load_compressed_tensor``."""
    if not (lz4f.available() and jax_lz4f.available()):
        pytest.skip("no liblz4 on this host")
    flow = np.random.default_rng(4).standard_normal((2, 5, 7)).astype(np.float32)
    blob = pickle.dumps(torch.from_numpy(flow))
    for compress, load in ((lz4f.compress, jax_tensors.load_compressed_tensor),
                           (jax_lz4f.compress, tensors.load_compressed_tensor)):
        path = str(tmp_path / f"{compress.__module__}_motion.pth")
        frame = compress(blob)
        assert frame[:4] == b"\x04\x22\x4d\x18"
        with open(path, "wb") as f:
            f.write(frame)
        np.testing.assert_array_equal(load(path), flow)
    assert lz4f.decompress(jax_lz4f.compress(blob)) == blob
