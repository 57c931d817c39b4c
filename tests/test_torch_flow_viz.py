"""The port's host tools against the JAX package's: Middlebury .flo files
written by either package read back by the other bit for bit, the colour
wheel and ``flow_to_image`` uint8-equal (NaN and inf vectors and a still
field included), and ``compute_mean_video``/``write_mean_videos`` equal on a
cv2-written mp4."""

import os

import numpy as np
import pytest
from PIL import Image

from slrsfs_tpu.data import video as jvideo
from slrsfs_tpu.utils import flow_viz as jfv
from slrsfs_tpu_torch.data import video as tvideo
from slrsfs_tpu_torch.utils import flow_viz as tfv


def _flow(seed, h=23, w=31):
    return (np.random.default_rng(seed).standard_normal((h, w, 2)) * 3).astype(np.float32)


def test_flo_round_trips_both_ways(tmp_path):
    flow = _flow(1)
    tfv.write_flo(str(tmp_path / "port.flo"), flow)
    jfv.write_flo(str(tmp_path / "jax.flo"), flow)
    assert (tmp_path / "port.flo").read_bytes() == (tmp_path / "jax.flo").read_bytes()
    assert np.array_equal(jfv.read_flo(str(tmp_path / "port.flo")), flow)
    assert np.array_equal(tfv.read_flo(str(tmp_path / "jax.flo")), flow)
    with pytest.raises(ValueError):
        tfv.write_flo(str(tmp_path / "bad.flo"), flow[..., :1])


def test_color_wheel_matches_jax():
    assert np.array_equal(tfv._color_wheel(), jfv._color_wheel())


@pytest.mark.parametrize("case", ["random", "nonfinite", "still", "unit_circle"])
def test_flow_to_image_is_uint8_equal(case):
    flow = _flow(2)
    if case == "nonfinite":
        flow[3, 4] = np.nan
        flow[5, :, 1] = np.inf
        flow[7, 2, 0] = -np.inf
    elif case == "still":
        flow[:] = 0.0
    elif case == "unit_circle":  # every angle at the largest radius
        a = np.linspace(-np.pi, np.pi, flow.shape[0] * flow.shape[1])
        flow = np.stack([np.cos(a), np.sin(a)], -1).reshape(flow.shape).astype(np.float32)
    got = tfv.flow_to_image(flow)
    assert got.dtype == np.uint8 and got.shape == flow.shape[:2] + (3,)
    assert np.array_equal(got, jfv.flow_to_image(flow))
    if case == "nonfinite":
        assert (got[3, 4] == 0).all() and (got[5] == 0).all()


def _write_mp4(path, frames):
    import cv2

    h, w = frames[0].shape[:2]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30, (w, h))
    for f in frames:
        vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    vw.release()


def test_mean_videos_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    split = tmp_path / "data" / "train"
    split.mkdir(parents=True)
    for name in ("s1", "s2"):
        _write_mp4(str(split / f"{name}_gt.mp4"),
                   [rng.integers(0, 256, (32, 48, 3)).astype(np.uint8) for _ in range(7)])
    (split / "ignored.mp4").write_bytes(b"")
    path = str(split / "s1_gt.mp4")
    for max_frames in (None, 3):
        got = tvideo.compute_mean_video(path, max_frames)
        assert got.dtype == np.uint8 and got.shape == (32, 48, 3)
        assert np.array_equal(got, jvideo.compute_mean_video(path, max_frames))
    assert not np.array_equal(tvideo.compute_mean_video(path, 3),
                              tvideo.compute_mean_video(path))
    tvideo.write_mean_videos(str(tmp_path / "data"), str(tmp_path / "port"))
    jvideo.write_mean_videos(str(tmp_path / "data"), str(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == ["s1.png", "s2.png"]
    for name in ("s1.png", "s2.png"):
        assert np.array_equal(np.asarray(Image.open(tmp_path / "port" / name)),
                              np.asarray(Image.open(tmp_path / "jax" / name)))
    with pytest.raises(IOError):
        tvideo.compute_mean_video(str(split / "ignored.mp4"))
