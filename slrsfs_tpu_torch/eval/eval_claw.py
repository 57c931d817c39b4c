"""CLAW-protocol directory evaluation → metric.json (PyTorch port of
``slrsfs_tpu/eval/eval_claw.py``; reference ``evaluation/animation/
eval_CLAW.py`` and ``eval_CLAW_fluid.py``).

Scans ``<pred_dir>/<scene>/PredImg/%06d.png`` (exactly ``n_frames`` files)
against ``<gt_dir>/<scene>.mp4``, resizes each GT frame to the prediction's
size with PIL's bilinear filter, scores PSNR/SSIM/Perceptual/LPIPS a frame
at a time on the metrics' device, and writes each scene's mean and std and
the aggregate Total* keys. The fluid variant composites the prediction
over the input image outside the moving region (speed > 0.1·mean) before
scoring. Decoding and resizing stay on the host.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
from PIL import Image

from slrsfs_tpu_torch.data.tensors import load_compressed_tensor, motion_to_hw2
from slrsfs_tpu_torch.data.video import VideoReader
from slrsfs_tpu_torch.eval.metrics import PerceptualMetrics
from slrsfs_tpu_torch.utils.flow_viz import read_flo

N_FRAMES = 60
KEYS = ("LPIPS", "Perceptual", "PSNR", "SSIM")


def _img01(path: str) -> np.ndarray:
    return np.asarray(Image.open(path).convert("RGB"), np.float32)[None] / 255.0


def _gt01(frame: np.ndarray, size_hw) -> np.ndarray:
    img = Image.fromarray(frame).resize((size_hw[1], size_hw[0]), Image.BILINEAR)
    return np.asarray(img, np.float32)[None] / 255.0


def _scenes(pred_dir: str, gt_dir: str, n_frames: int, gt_suffix: str) -> List[str]:
    """The scenes with a GT video and exactly ``n_frames`` PredImg files."""
    return sorted(
        x for x in os.listdir(pred_dir)
        if os.path.exists(os.path.join(pred_dir, x, "PredImg", "000000.png"))
        and os.path.exists(os.path.join(gt_dir, x + gt_suffix))
        and len(os.listdir(os.path.join(pred_dir, x, "PredImg"))) == n_frames)


def _fluid_mask(scene: str, flow_dir: str, size_hw) -> np.ndarray:
    """(1, H, W, 1) float32: 1 where the scene's motion, resized to the
    prediction by cv2's bilinear filter, moves faster than 0.1 of its mean
    speed."""
    import cv2

    flo_path = os.path.join(flow_dir, scene + "_motion.flo")
    if os.path.exists(flo_path):
        flow = read_flo(flo_path)
    else:  # the eulerian layout's motion tensors
        for suf in ("_motion.pth", "_motion.npz"):
            cand = os.path.join(flow_dir, scene + suf)
            if os.path.exists(cand):
                flow = motion_to_hw2(load_compressed_tensor(cand))
                break
        else:
            raise FileNotFoundError(f"no motion file for {scene} under {flow_dir}")
    fl = cv2.resize(flow, (size_hw[1], size_hw[0]), interpolation=cv2.INTER_LINEAR)
    speed = np.sqrt(fl[..., 0] ** 2 + fl[..., 1] ** 2)
    return (speed > speed.mean() * 0.1).astype(np.float32)[None, ..., None]


def eval_claw_dir(pred_dir: str, gt_dir: str,
                  metrics: Optional[PerceptualMetrics] = None,
                  fluid: bool = False,
                  flow_dir: Optional[str] = None,
                  input_dir: Optional[str] = None,
                  n_frames: int = N_FRAMES,
                  out_json: Optional[str] = None,
                  gt_suffix: str = ".mp4", device="cuda") -> Dict:
    """Score every complete scene of ``pred_dir`` and write ``out_json``
    (default ``<pred_dir>/../metric.json``, or ``metric_fluid.json``).
    ``metrics`` defaults to PSNR and SSIM on ``device``; gt_suffix ".mp4"
    is the CLAW layout, "_gt.mp4" the eulerian_data one (reference
    eval_eulerian_data.py:84)."""
    metrics = metrics or PerceptualMetrics(device=device)
    scenes = _scenes(pred_dir, gt_dir, n_frames, gt_suffix)
    skipped = [x for x in os.listdir(pred_dir)
               if os.path.isdir(os.path.join(pred_dir, x)) and x not in scenes]
    for s in skipped:
        print(f"do not eval {s}")

    results: Dict = {}
    for k in KEYS:
        results[f"Total{k}"] = {}
        results[f"Total{k}_std"] = {}
        results[k] = {}
        results[f"{k}_std"] = {}
    all_vals: Dict[str, list] = {k: [] for k in KEYS}

    for scene in scenes:
        vr = VideoReader(os.path.join(gt_dir, scene + gt_suffix))
        vid_vals: Dict[str, list] = {k: [] for k in KEYS}
        if fluid:
            p0 = _img01(os.path.join(pred_dir, scene, "PredImg", "000000.png"))
            mask = _fluid_mask(scene, flow_dir, p0.shape[1:3])
            inp = Image.open(os.path.join(input_dir, scene + "_input.jpg"))
            inp = inp.resize((p0.shape[2], p0.shape[1]), Image.BILINEAR)
            input_img = np.asarray(inp, np.float32)[None] / 255.0
        try:
            for t in range(n_frames):
                pred = _img01(os.path.join(pred_dir, scene, "PredImg", f"{t:06d}.png"))
                gt = _gt01(vr[t], pred.shape[1:3])
                if fluid:
                    pred = pred * mask + input_img * (1.0 - mask)
                m = metrics.all_metrics(pred, gt)
                for k in KEYS:
                    if k in m:
                        vid_vals[k].append(m[k])
                        all_vals[k].append(m[k])
        finally:
            vr.close()
        for k in KEYS:
            if vid_vals[k]:
                results[k][scene] = float(np.mean(vid_vals[k]))
                results[f"{k}_std"][scene] = float(np.std(vid_vals[k]))

    for k in KEYS:
        if all_vals[k]:
            results[f"Total{k}"] = float(np.mean(all_vals[k]))
            results[f"Total{k}_std"] = float(np.std(all_vals[k]))

    if out_json is None:
        out_json = os.path.join(pred_dir, "..",
                                "metric_fluid.json" if fluid else "metric.json")
    with open(out_json, "w") as f:
        json.dump(results, f)
    return results


def eval_fvd_dir(pred_dir: str, gt_dir: str, fvd,
                 n_frames: int = N_FRAMES, gt_suffix: str = ".mp4") -> float:
    """FVD over the scene set: one ``n_frames`` video per scene, generated
    (the PredImg stack) against real (the GT frames resized to the
    prediction's size). ``fvd``: an available :class:`~.i3d.FVD`, which
    runs on its own device."""
    real, gen = [], []
    for scene in _scenes(pred_dir, gt_dir, n_frames, gt_suffix):
        vr = VideoReader(os.path.join(gt_dir, scene + gt_suffix))
        try:
            pred = np.concatenate([
                _img01(os.path.join(pred_dir, scene, "PredImg", f"{t:06d}.png"))
                for t in range(n_frames)])
            gt = np.concatenate([_gt01(vr[t], pred.shape[1:3])
                                 for t in range(n_frames)])
        finally:
            vr.close()
        gen.append(pred)
        real.append(gt)
    return fvd.score(real, gen)


def compare_metrics(json_a: str, json_b: str, key: str = "LPIPS") -> Dict:
    """Per-scene ``key`` of ``json_a`` less ``json_b``'s, ascending
    (reference evaluation/animation/compare_metric.py)."""
    with open(json_a) as f:
        a = json.load(f)
    with open(json_b) as f:
        b = json.load(f)
    out = {scene: a[key][scene] - b[key][scene]
           for scene in a.get(key, {}) if scene in b.get(key, {})}
    return dict(sorted(out.items(), key=lambda kv: kv[1]))
