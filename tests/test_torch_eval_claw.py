"""The port's CLAW directory evaluation (``slrsfs_tpu_torch/eval/
eval_claw.py``, ``cli/eval.py``) against the JAX package's on the CPU, on a
tiny cv2-written fixture in the CLAW layout: two scenes of 9 frames at
48x64 (9 is the fewest I3D takes), one more scene with a stray file in its
PredImg (skipped by both), GT mp4s, input JPEGs and the motion as .flo
(scene a) and .npz (scene b); every weight from one seeded .pth set.
Plain and fluid, ``eval_fvd_dir``, ``compare_metrics`` and ``cli/eval.main
--device cpu`` with every weight flag: the same JSON keys, values within
1e-5 relative (a std within 1e-5 of its metric's mean), TotalFVD within
1e-4 relative (measured: 2.9e-7 and 3.0e-7)."""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from slrsfs_tpu.cli import eval as jcli
from slrsfs_tpu.eval import eval_claw as jclaw
from slrsfs_tpu.eval import metrics as jm
from slrsfs_tpu_torch.cli import eval as tcli
from slrsfs_tpu_torch.eval import eval_claw as tclaw
from slrsfs_tpu_torch.eval import i3d as ti3d
from slrsfs_tpu_torch.eval import metrics as tm
from slrsfs_tpu_torch.eval.random_weights import write_random_weights
from slrsfs_tpu_torch.utils.flow_viz import write_flo

torch.set_num_threads(1)

N, H, W = 9, 48, 64


def _write_mp4(path, frames):
    import cv2

    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30, (W, H))
    for f in frames:
        vw.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    vw.release()


@pytest.fixture(scope="module")
def claw(tmp_path_factory):
    root = tmp_path_factory.mktemp("claw")
    rng = np.random.default_rng(21)
    pred, gt, inp = (root / "pred" / "PredImg_root", root / "gt", root / "input")
    for d in (pred, gt, inp):
        d.mkdir(parents=True)
    for name in ("a", "b", "c"):
        base = rng.integers(0, 256, (H, W, 3)).astype(np.int16)
        frames = [np.clip(base + rng.integers(-30, 31, base.shape), 0, 255).astype(np.uint8)
                  for _ in range(N)]
        _write_mp4(str(gt / f"{name}.mp4"), frames)
        (pred / name / "PredImg").mkdir(parents=True)
        for t, f in enumerate(frames):
            p = np.clip(f.astype(np.int16) + rng.integers(-20, 21, f.shape), 0, 255)
            Image.fromarray(p.astype(np.uint8)).save(pred / name / "PredImg" / f"{t:06d}.png")
        Image.fromarray(base.astype(np.uint8)).save(inp / f"{name}_input.jpg", quality=95)
        flow = np.zeros((H // 2, W // 2, 2), np.float32)
        flow[: H // 4] = rng.normal(0, 2, (H // 4, W // 2, 2))
        if name == "b":
            np.savez(inp / f"{name}_motion.npz", flow.transpose(2, 0, 1)[None])
        else:
            write_flo(str(inp / f"{name}_motion.flo"), flow)
    (pred / "c" / "PredImg" / "stray.txt").write_text("not a frame")
    weights = write_random_weights(str(root / "weights"), seed=5)
    return {"pred": str(pred), "gt": str(gt), "inp": str(inp), "root": root,
            "weights": weights}


def _flags(claw):
    w = claw["weights"]
    return ["--n-frames", str(N), "--vgg16-pth", w["vgg16"], "--alexnet-pth",
            w["alexnet"], "--lpips-pth", w["lpips_alex"], "--i3d-pth", w["i3d"]]


FLUID = ["--fluid", "--flow-dir", "{inp}", "--input-dir", "{inp}"]


@pytest.fixture(scope="module")
def jax_runs(claw, tmp_path_factory):
    """The JAX package's plain eval_claw_dir and its CLI with --fluid and
    every weight flag (eager JAX scores ~0.5 s a frame: each runs once)."""
    out = tmp_path_factory.mktemp("jax_runs")
    w = claw["weights"]
    plain = jclaw.eval_claw_dir(
        claw["pred"], claw["gt"], jm.PerceptualMetrics(w["vgg16"], w["alexnet"],
                                                       w["lpips_alex"]),
        n_frames=N, out_json=str(out / "plain.json"))
    fluid = [f.format(inp=claw["inp"]) for f in FLUID]
    jcli.main([claw["pred"], claw["gt"], *fluid, *_flags(claw), "--out",
               str(out / "fluid.json")])
    return {"plain": plain, "fluid": json.load(open(out / "fluid.json"))}


def _close(got, want, rtol):
    """Every key and scene of ``want`` in ``got``, each value within
    ``rtol`` relative; a std within ``rtol`` of its metric's mean (its
    error is bounded by the frames' errors, not by its own size)."""
    assert set(got) == set(want)
    for k, w in want.items():
        ref = want[k[:-len("_std")]] if k.endswith("_std") else w
        if isinstance(w, dict):
            assert set(got[k]) == set(w), k
            for s in w:
                assert abs(got[k][s] - w[s]) <= rtol * abs(ref[s]), (k, s, got[k][s], w[s])
        else:
            assert abs(got[k] - w) <= rtol * abs(ref), (k, got[k], w)


@pytest.mark.parametrize("fluid", [False, True])
def test_eval_claw_dir_matches_jax(claw, jax_runs, fluid, tmp_path):
    w = claw["weights"]
    metrics = tm.PerceptualMetrics(w["vgg16"], w["alexnet"], w["lpips_alex"], device="cpu")
    got = tclaw.eval_claw_dir(claw["pred"], claw["gt"], metrics, fluid=fluid,
                              flow_dir=claw["inp"], input_dir=claw["inp"], n_frames=N,
                              out_json=str(tmp_path / "port.json"))
    want = dict(jax_runs["fluid" if fluid else "plain"])
    want.pop("TotalFVD", None)
    _close(got, want, 1e-5)
    assert sorted(got["LPIPS"]) == ["a", "b"]  # c has a stray file
    assert json.load(open(tmp_path / "port.json")) == got
    if fluid:  # the composite moves the scores
        assert got["TotalPSNR"] != jax_runs["plain"]["TotalPSNR"]


def test_eval_claw_dir_default_path_and_gating(claw, jax_runs):
    """metrics None: PSNR and SSIM on the given device, the other keys
    empty dicts (as JAX's without weights); the default out_json beside
    pred_dir, as in JAX."""
    got = tclaw.eval_claw_dir(claw["pred"], claw["gt"], device="cpu", n_frames=N)
    path = os.path.join(claw["pred"], "..", "metric.json")
    assert json.load(open(path)) == got
    want = {k: (v if k.removesuffix("_std").removeprefix("Total") in ("PSNR", "SSIM") else {})
            for k, v in jax_runs["plain"].items()}
    _close(got, want, 1e-5)


def test_eval_fvd_dir_matches_jax(claw, jax_runs):
    """The JAX CLI's TotalFVD is its eval_fvd_dir over the same scenes."""
    got = tclaw.eval_fvd_dir(claw["pred"], claw["gt"],
                             ti3d.FVD(claw["weights"]["i3d"], device="cpu"), n_frames=N)
    want = jax_runs["fluid"]["TotalFVD"]
    assert np.isfinite(got) and got > 0
    assert abs(got - want) <= 1e-4 * abs(want), (got, want)


def test_compare_metrics_matches_jax(tmp_path):
    a = {"LPIPS": {"x": 0.3, "y": 0.1, "z": 0.2}, "PSNR": {"x": 20.0}}
    b = {"LPIPS": {"x": 0.1, "y": 0.4}, "PSNR": {"x": 21.0}}
    for name, d in (("a", a), ("b", b)):
        with open(tmp_path / f"{name}.json", "w") as f:
            json.dump(d, f)
    pa, pb = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    for key in ("LPIPS", "PSNR", "SSIM"):
        got = tclaw.compare_metrics(pa, pb, key)
        want = jclaw.compare_metrics(pa, pb, key)
        assert got == want and list(got) == list(want)


def test_eval_cli_matches_jax(claw, jax_runs, tmp_path, capsys):
    """cli/eval.main --fluid --device cpu with all four weight flags: one
    file holding the metrics and TotalFVD, as the JAX CLI's; it prints the
    aggregate keys."""
    fluid = [f.format(inp=claw["inp"]) for f in FLUID]
    capsys.readouterr()
    got = tcli.main([claw["pred"], claw["gt"], *fluid, *_flags(claw), "--out",
                     str(tmp_path / "port.json"), "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.split("do not eval c\n")[-1])
    assert json.load(open(tmp_path / "port.json")) == got
    want = dict(jax_runs["fluid"])
    fvd = (got.pop("TotalFVD"), want.pop("TotalFVD"))
    assert abs(fvd[0] - fvd[1]) <= 1e-4 * abs(fvd[1]), fvd
    _close(got, want, 1e-5)
    assert set(printed) == {k for k in jax_runs["fluid"]
                            if k.startswith("Total") and not isinstance(jax_runs["fluid"][k], dict)}
