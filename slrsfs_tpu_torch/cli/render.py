"""Render an animated video from a still image and a motion field, on the GPU:

    python -m slrsfs_tpu_torch.cli.render IMAGE FLOW SAVE_DIR [--ckpt CKPT] ...

PyTorch port of ``slrsfs_tpu/cli/render.py`` for the single-layer baseline
(``model_type=softmax_splating``) and the SLR two-layer model
(``softmax_splating_2layers_alpha_seperate``), with any Z-norm the
checkpoint's options select (v2 included). Protocol:
the input is resized to W² (PIL bilinear) and normalised to [-1, 1]; the
flow is scaled by W/source · speed and nearest-resized
(test_baseline_4eval.py:161-184); an optional align.json rescales it by
frame/N (:198-202); frames go to <save_dir>/<name>/<key>/%06d.png at the
output size (raw, or half the input image) and into one mp4 per key: PredImg
for the baseline, PredImg, FluidImg and CompositeFluidAlpha plus BGImg.png
for SLR. --alpha-region (a grayscale image) keeps the SLR composite inside
the region. Flow editing: --speed, --rotate (degrees) and --flow-scale.
--crop-decode auto (the default) splats and decodes each frame on the
moving region's window only and pastes it onto one full-frame static decode
(exact; engine/rollout.py, crop decode section); --profile-stages prints
the reference's stage times for the scene (engine/stage_profile.py).
--motion-ckpt renders motion from sparse hints (the reference's
test_motion_4eval_rawsize_threshold.py:163-219): the given flow only seeds
a speed-threshold mask and five k-means/RBF hints (data/hints.py), and a
motion regressor's checkpoint (models/motion.py) predicts the dense motion
that the render then animates, both on the renderer's device.
--shard-frames renders each scene's frames in contiguous blocks over the
ranks of a torch.distributed group, one GPU a rank (``torchrun
--nproc_per_node=K -m slrsfs_tpu_torch.cli.render ...``; without
torchrun's environment, one rank), and rank 0 writes the files.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from slrsfs_tpu_torch.engine.init_utils import no_tf32, resolve_device, settle
from slrsfs_tpu_torch.engine.profiler import count, span

# Decode-chunk budget in decoded pixels x frames: the decoder's live
# activations scale with decode_batch x window area, so the auto chooser
# caps their product. From chip_smoke.py's peak-memory reading on an NVIDIA
# H100 80GB HBM3 (700 W limit): a float32 decode chunk of 60 frames at
# 256^2 adds 14.68 GiB, 4008 bytes per pixel-frame (bfloat16: 1290), so half
# of the card's 79.2 GiB holds 10.6 M float32 pixel-frames.
DECODE_PX_BUDGET = 10_000_000
# An SLR chunk runs the fluid and the alpha decoder one after the other and
# also holds the 65-channel splat field, the accumulator and the outputs. A
# whole float32 SLR render with 60-frame chunks at 256^2 adds 15.86 GiB,
# 4332 bytes per pixel-frame (bfloat16: 1482; same card and script), so half
# of the card holds 9.8 M float32 pixel-frames.
DECODE_PX_BUDGET_SLR = 9_500_000
DTYPES = ("float32", "bfloat16", "bfloat16-fast")


def edit_flow(flow: np.ndarray, rotate_deg: float = 0.0,
              scale: float = 1.0) -> np.ndarray:
    """Rotate motion vectors by an angle and scale their magnitude."""
    if rotate_deg:
        th = np.deg2rad(rotate_deg)
        c, s = np.cos(th), np.sin(th)
        u = flow[..., 0] * c - flow[..., 1] * s
        v = flow[..., 0] * s + flow[..., 1] * c
        flow = np.stack([u, v], -1).astype(np.float32)
    return flow * scale


def auto_decode_batch(n_frames: int, area: int, slr: bool = False,
                      cap: int = 60) -> int:
    """Largest divisor of ``n_frames`` (<= cap) whose decode chunk fits the
    budget for a decode window of ``area`` pixels."""
    budget = DECODE_PX_BUDGET_SLR if slr else DECODE_PX_BUDGET
    db = max(1, min(cap, n_frames, budget // max(1, area)))
    while n_frames % db:
        db -= 1
    return db


def _load_flow(path: str) -> np.ndarray:
    from slrsfs_tpu_torch.data.tensors import load_compressed_tensor, motion_to_hw2
    from slrsfs_tpu_torch.utils.flow_viz import read_flo

    if path.endswith(".flo"):
        return read_flo(path)
    return motion_to_hw2(load_compressed_tensor(path))


def to_u8(frames: torch.Tensor, image: bool = True) -> torch.Tensor:
    """[-1, 1] frames (``image``) or [0, 1] alpha maps → uint8 [0, 255],
    rounded, on the frames' device."""
    v = frames.to(torch.float32)
    if image:
        v = v * 0.5 + 0.5
    return (v.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def outputs_to_u8(outs) -> dict:
    """{key: uint8 numpy} of a rollout's outputs: a tensor is PredImg; keys
    with 'Img' are [-1, 1] images, the others [0, 1] alpha maps. The copies
    to the host are the timed span ``render.d2h``."""
    if torch.is_tensor(outs):
        outs = {"PredImg": outs}
    u8 = {k: to_u8(v, image="Img" in k) for k, v in outs.items()}
    with span("render.d2h", timed=True):
        return {k: v.cpu().numpy() for k, v in u8.items()}


def load_regressor(path: str, W: int):
    """The ``MotionRegressor`` of a reference-style motion checkpoint
    (``SPADE_unet_mask_motion`` or ``unet_motion``, JAX cli/render.py:
    149-157), or the embedded regressor of a fluid checkpoint of the
    embedded-motion stages (``motion_regressor.motion_predictor.*``, built
    from its ``motion_model_type``), at W² on the CPU, in eval mode."""
    from slrsfs_tpu_torch.io.checkpoint import load_checkpoint, load_model_state, motion_state
    from slrsfs_tpu_torch.models.motion import MOTION_MODEL_TYPES, MotionRegressor

    sd, opt = load_checkpoint(path)
    if opt.model_type not in MOTION_MODEL_TYPES and not motion_state(sd):
        raise ValueError(f"motion checkpoint {path}: model_type {opt.model_type!r} is "
                         f"not a motion regressor ({', '.join(MOTION_MODEL_TYPES)}) and "
                         f"holds no embedded one")
    regressor = MotionRegressor(opt.replace(W=W, motionW=W, motionH=W)).eval()
    load_model_state(regressor, motion_state(sd))
    return regressor


class SceneRenderer:
    """Model and device state shared across scenes.

    ``frames()`` renders in memory; ``render()`` adds the file protocol
    (image/flow loading, PNG and mp4 output). The PNGs and mp4s are written
    on a background thread while the next scene renders, at most two scenes
    pending; ``finish()`` waits for them.

    ``shard_frames`` (JAX cli/render.py:160-169) forms or joins the mesh of
    every rank (``parallel.mesh.make_mesh``; each rank on ``cuda:LOCAL_RANK``
    or, with device 'cpu', a gloo rank), replicates rank 0's weights and
    renders through the frame-sharded rollouts: this rank's N / world
    frames, gathered on every rank. N % world != 0 is a ``ValueError``;
    only rank 0 writes files; ``profile_stages`` is ignored, as in JAX.
    ``close()`` also destroys a group that the renderer formed."""

    def __init__(self, ckpt: str = None, W: int = 256, n_frames: int = 60,
                 dtype: str = "float32", decode_batch: int = None,
                 seed: int = 0, motion_ckpt: str = None,
                 opt_overrides: dict = None, shard_frames: bool = False,
                 sparsify_eps: float = None, crop_decode: str = "auto",
                 p_bucket_ratio: float = None, profile_stages: bool = False,
                 device="cuda"):
        from slrsfs_tpu_torch.config import Options
        from slrsfs_tpu_torch.io.checkpoint import (
            RENDER_MODEL_TYPES,
            load_checkpoint,
            load_model_state,
        )
        from slrsfs_tpu_torch.models import get_model
        from slrsfs_tpu_torch.models.baseline import init_random_weights
        from slrsfs_tpu_torch.models.slr import SLR_MODEL_TYPE

        if dtype not in DTYPES:
            raise ValueError(f"unknown dtype {dtype!r}")
        if crop_decode not in ("auto", "off"):
            raise ValueError(f"unknown crop_decode {crop_decode!r}")
        self.mesh = None
        if shard_frames:
            from slrsfs_tpu_torch.parallel.mesh import make_mesh

            self.mesh = make_mesh(device=device)
            if n_frames % self.mesh.world:
                self.mesh.close()
                raise ValueError(f"n_frames={n_frames} must divide over "
                                 f"{self.mesh.world} ranks")
            self.device = self.mesh.device
        else:
            self.device = resolve_device(device)

        if ckpt:
            sd, opt = load_checkpoint(ckpt)
            opt = opt.replace(W=W)
        else:  # random weights (smoke/benchmark mode)
            opt = Options(W=W, bn_noise_misc=True, **(opt_overrides or {}))
        if opt.model_type not in RENDER_MODEL_TYPES:
            raise ValueError(
                f"model_type {opt.model_type!r} is not a render model "
                f"({', '.join(RENDER_MODEL_TYPES)}); pass a motion "
                f"regressor's checkpoint as motion_ckpt (--motion-ckpt)")
        self.opt = opt
        self.slr = opt.model_type == SLR_MODEL_TYPE
        model = get_model(opt).eval()
        if ckpt:
            load_model_state(model, sd)
            model = model.to(self.device)
        else:
            # settle at 64² whatever the render size, n = 6, zero noise, as
            # the JAX renderer does (slrsfs_tpu/cli/render.py:177-191)
            init_random_weights(model, seed)
            model = model.to(self.device)
            small = np.random.default_rng(seed + 2).standard_normal(
                (1, 64, 64, 3)).astype(np.float32) * 0.25
            settle(model, (torch.from_numpy(small).to(self.device),), n=6)
        # 'bfloat16': bf16 networks, f32 splat; 'bfloat16-fast' also
        # accumulates the splat in bf16 (JAX cli/render.py:112-116)
        self.compute_dtype = (torch.bfloat16 if dtype.startswith("bfloat16")
                              else torch.float32)
        self.splat_dtype = (torch.bfloat16 if dtype == "bfloat16-fast"
                            else torch.float32)
        if self.mesh is not None:
            from slrsfs_tpu_torch.parallel.mesh import replicate

            replicate(model, self.mesh)
        self.model = model.to(self.compute_dtype)
        # motion from hints: the regressor runs in float32 whatever the
        # render's dtype, as JAX runs its float32 variables
        self.regressor = (None if not motion_ckpt
                          else load_regressor(motion_ckpt, W).to(self.device))
        self.W, self.n_frames = W, n_frames
        # the frames this rank renders: all N, or its block of N / world
        self.rank_frames = n_frames if self.mesh is None else n_frames // self.mesh.world
        if decode_batch is not None:
            while self.rank_frames % decode_batch:
                decode_batch -= 1
        self.decode_batch = decode_batch
        # zero sub-threshold motion so estimated (dense) flows ride the
        # sparse path; eps = 0.5/N bounds each zeroed pixel's drift at half a
        # pixel. None = auto: 0.5/N for --rawsize renders, else 0.
        self.sparsify_eps = sparsify_eps
        # 'auto': splat and decode the moving region's window when it is
        # under 85 % of the frame, pasted onto one full-frame static decode
        self.crop_decode = crop_decode
        # geometric moving-set size buckets (prepare_scene_sparse): sweeps
        # set ~1.25 so that scenes share shapes; None = 1024-padding
        self.p_bucket_ratio = p_bucket_ratio
        self.profile_stages = profile_stages
        self.stage_profiles = None
        # the (P, window height, window width) of every scene rendered
        self.shapes = set()
        self._save_pool = ThreadPoolExecutor(max_workers=1)
        self._pending = []

    def decode_batch_for(self, area: int) -> int:
        """The frames of a decode chunk, a divisor of the frames this rank
        renders: ``decode_batch``, or the budget's choice for a window of
        ``area`` pixels."""
        if self.decode_batch is not None:
            return self.decode_batch
        return auto_decode_batch(self.rank_frames, area, slr=self.slr)

    def _tensors(self, img: np.ndarray, flow: np.ndarray):
        """(img (1, W, W, 3), flow, positions, valid) on the device, the
        moving set bucketed by ``p_bucket_ratio`` (spans
        ``render.moving_set`` and ``render.upload``)."""
        from slrsfs_tpu_torch.engine.rollout import prepare_scene_sparse

        with span("render.moving_set"):
            positions, valid = prepare_scene_sparse(flow,
                                                    bucket_ratio=self.p_bucket_ratio)
        with span("render.upload"):
            return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                         for a in (np.asarray(img, np.float32)[None],
                                   np.asarray(flow, np.float32), positions, valid))

    def frames(self, img: np.ndarray, flow: np.ndarray, plain: bool = False,
               alpha_region: np.ndarray = None):
        """img (W, W, 3) in [-1, 1], flow (W, W, 2) in output pixels → on
        the device, the baseline's (N, W, W, 3) float32 frames in [-1, 1],
        or SLR's dict of PredImg, FluidImg (N, W, W, 3), CompositeFluidAlpha
        (N, W, W, 1) and BGImg (W, W, 3). ``alpha_region`` (W, W) in [0, 1]
        is the SLR edit region (the baseline ignores it, as the JAX CLI
        does). ``plain`` runs the kernels' plain PyTorch versions instead of
        the kernels. With ``crop_decode`` 'auto' the scene's crop is planned
        here (``prepare_crop``, which also integrates it) and the rollout
        runs on it, or uncropped when the plan is None; the decode batch is
        sized to the decode window. With a mesh the frame-sharded rollouts
        render this rank's block and every rank returns all N frames; the
        counter ``render.frames`` adds this rank's frames."""
        from slrsfs_tpu_torch.engine import rollout

        count("render.frames", self.rank_frames)
        img_t, flow_t, pos_t, val_t = self._tensors(img, flow)
        crop = disp = None
        if self.crop_decode == "auto":
            disp, crop = rollout.prepare_crop(self.opt, self.slr, flow_t, pos_t,
                                              val_t, self.n_frames, plain=plain)
        hc, wc = (self.W, self.W) if crop is None else (crop.hc, crop.wc)
        self.shapes.add((pos_t.shape[0], hc, wc))
        args = (self.model, img_t, flow_t, self.n_frames, pos_t, val_t)
        kw = dict(decode_batch=self.decode_batch_for(hc * wc),
                  compute_dtype=self.compute_dtype, plain=plain,
                  splat_dtype=self.splat_dtype, crop=crop, disp=disp)
        if self.slr:
            kw["alpha_region"] = (
                None if alpha_region is None
                else torch.from_numpy(np.asarray(alpha_region, np.float32)
                                      [None, ..., None]).to(self.device))
        if self.mesh is not None:
            fn = (rollout.slr_rollout_frame_sharded if self.slr
                  else rollout.baseline_rollout_frame_sharded)
            return fn(*args, self.mesh, **kw)
        fn = rollout.slr_rollout_sparse if self.slr else rollout.baseline_rollout_sparse
        return fn(*args, **kw)

    def profile(self, img: np.ndarray, flow: np.ndarray) -> dict:
        """The baseline's stage times on this scene
        (``engine/stage_profile.py``): {"full": the uncropped rollout's,
        "crop": the crop rollout's, None when its plan is None or
        ``crop_decode`` is 'off'}."""
        from slrsfs_tpu_torch.engine.stage_profile import (
            profile_baseline_crop_stages,
            profile_baseline_stages,
        )

        img_t, flow_t, pos_t, val_t = self._tensors(img, flow)
        args = (self.model, img_t, flow_t, pos_t, val_t, self.n_frames)
        kw = dict(compute_dtype=self.compute_dtype, splat_dtype=self.splat_dtype)
        full = profile_baseline_stages(
            *args, decode_batch=self.decode_batch_for(self.W * self.W), **kw)[0]
        crop = None
        if self.crop_decode == "auto":  # the decode batch the crop render uses
            crop = profile_baseline_crop_stages(
                *args, decode_batch=self.decode_batch_for, **kw)
        return {"full": full, "crop": None if crop is None else crop[0]}

    def regress_motion(self, img: np.ndarray, flow: np.ndarray) -> np.ndarray:
        """Motion from hints (JAX cli/render.py:314-325): ``flow`` (W, W, 2)
        only seeds the speed-threshold mask and the five k-means/RBF hints
        (``data/hints.py:synthesize_hint``); the regressor predicts the
        dense motion from [img (W, W, 3), mask, hint], float32 with TF32
        off, on the renderer's device. Returns the motion (W, W, 2)."""
        from slrsfs_tpu_torch.data.hints import synthesize_hint

        dev = self.device
        hint, mask = synthesize_hint(torch.from_numpy(
            np.ascontiguousarray(flow, np.float32)).to(dev))
        img_t = torch.from_numpy(np.asarray(img, np.float32)[None]).to(dev)
        with torch.no_grad(), no_tf32():
            pred = self.regressor(img_t, mask[None, ..., None], hint[None])
        return pred[0].cpu().numpy()

    def load_inputs(self, image_path: str, flow_path: str, name: str,
                    speed: float = 1.0, align_json: str = "None",
                    rawsize: bool = False, rotate: float = 0.0,
                    flow_scale: float = 1.0):
        """→ (img (W, W, 3), flow (W, W, 2), out_w, out_h) per the protocol."""
        from PIL import Image

        from slrsfs_tpu_torch.data.transforms import transform_flow

        W = self.W
        img_pil = Image.open(image_path).convert("RGB")
        out_w, out_h = img_pil.size if rawsize else (img_pil.size[0] // 2,
                                                     img_pil.size[1] // 2)
        img = np.asarray(img_pil.resize((W, W), Image.BILINEAR), np.float32)
        img = (img / 255.0 - 0.5) / 0.5

        flow = edit_flow(_load_flow(flow_path), rotate, flow_scale)
        flow = transform_flow(flow, W, speed=speed)
        return img, self.scene_flow(img, flow, name, align_json, rawsize), out_w, out_h

    def scene_flow(self, img: np.ndarray, flow: np.ndarray, name: str,
                   align_json: str = "None", rawsize: bool = False) -> np.ndarray:
        """The motion the render animates, from the transformed flow (W, W,
        2): with a regressor, its motion from hints (``regress_motion``);
        then the align-json rescale and the sparsifier (span
        ``render.sparsify``). A scene starts here: the counter
        ``render.scenes``."""
        count("render.scenes")
        n_frames = self.n_frames
        if self.regressor is not None:
            flow = self.regress_motion(img, flow)
        if align_json and align_json != "None":
            with open(align_json) as f:
                align = json.load(f)
            if name in align:
                flow = flow * (align[name] / float(n_frames))
        eps = self.sparsify_eps
        if eps is None:
            eps = 0.5 / n_frames if rawsize else 0.0
        if eps > 0.0:
            with span("render.sparsify"):
                speed_px = np.sqrt(flow[..., 0] ** 2 + flow[..., 1] ** 2)
                sub = speed_px < eps
                zeroed = sub & (speed_px > 0)
                if zeroed.any():
                    print(f"sparsify eps={eps:g}: zeroed {zeroed.mean():.1%} of "
                          f"pixels (max trajectory drift "
                          f"{speed_px[zeroed].max() * n_frames:.2f}px over "
                          f"{n_frames} frames)")
                flow = np.where(sub[..., None], 0.0, flow)
        return np.asarray(flow, np.float32)

    def render(self, image_path: str, flow_path: str, save_dir: str,
               name: str = None, speed: float = 1.0, align_json: str = "None",
               rawsize: bool = False, rotate: float = 0.0,
               flow_scale: float = 1.0, alpha_region_path: str = None) -> str:
        from PIL import Image

        name = name or os.path.splitext(os.path.basename(image_path))[0]
        out_dir = os.path.join(save_dir, name)
        img, flow, out_w, out_h = self.load_inputs(
            image_path, flow_path, name, speed, align_json, rawsize, rotate,
            flow_scale)
        region = None
        if alpha_region_path:
            r = Image.open(alpha_region_path).convert("L").resize((self.W, self.W))
            region = np.asarray(r, np.float32) / 255.0
        if self.profile_stages and not self.slr and self.mesh is None:
            from slrsfs_tpu_torch.engine.stage_profile import format_stages

            self.stage_profiles = self.profile(img, flow)
            print(f"[profile {name}] {format_stages(self.stage_profiles['full'])}")
            if self.crop_decode == "auto":
                stc = self.stage_profiles["crop"]
                print(f"[profile {name}] crop: disengaged (plan None)" if stc is None
                      else f"[profile {name}] crop (t_euler_integration = "
                           f"prepare_crop): {format_stages(stc)}")
            self.profile_stages = False  # once a process
        outs = self.frames(img, flow, alpha_region=region)
        if self.mesh is not None and self.mesh.rank != 0:
            return out_dir  # rank 0 writes the files
        os.makedirs(out_dir, exist_ok=True)
        outs = outputs_to_u8(outs)
        # each pending save holds a scene's outputs in host memory
        while len(self._pending) >= 2:
            self._pending.pop(0).result()
        self._pending.append(self._save_pool.submit(
            save_outputs, outs, out_dir, name, out_w, out_h))
        return out_dir

    def finish(self):
        """Wait for the pending background saves, raising any save error."""
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    def close(self):
        """``finish()``, then destroy the process group if this renderer
        formed it."""
        self.finish()
        if self.mesh is not None:
            self.mesh.close()


def render_scene(image_path: str, flow_path: str, save_dir: str,
                 ckpt: str = None, name: str = None, W: int = 256,
                 n_frames: int = 60, speed: float = 1.0,
                 align_json: str = "None", rawsize: bool = False,
                 rotate: float = 0.0, flow_scale: float = 1.0,
                 dtype: str = "float32", decode_batch: int = None,
                 seed: int = 0, opt_overrides: dict = None,
                 sparsify_eps: float = 0.0, alpha_region_path: str = None,
                 crop_decode: str = "auto", motion_ckpt: str = None,
                 shard_frames: bool = False, device="cuda") -> str:
    """One-shot render of one scene (the reference single-scene script).
    Scene loops build one ``SceneRenderer`` and call ``render()`` per
    scene. ``shard_frames`` as for ``SceneRenderer``: this rank renders its
    block of frames, and the group the renderer formed is destroyed at the
    end."""
    r = SceneRenderer(ckpt=ckpt, W=W, n_frames=n_frames, dtype=dtype,
                      decode_batch=decode_batch, seed=seed, motion_ckpt=motion_ckpt,
                      opt_overrides=opt_overrides, sparsify_eps=sparsify_eps,
                      crop_decode=crop_decode, shard_frames=shard_frames,
                      device=device)
    out_dir = r.render(image_path, flow_path, save_dir, name=name, speed=speed,
                       align_json=align_json, rawsize=rawsize, rotate=rotate,
                       flow_scale=flow_scale, alpha_region_path=alpha_region_path)
    r.close()
    return out_dir


def save_outputs(outs: dict, out_dir: str, name: str, out_w: int,
                 out_h: int) -> str:
    """{key: uint8 array} → per (N, H, W, C) key <key>/%06d.png at the output
    size (alpha maps as gray RGB) and <key>_<name>.mp4 (ffmpeg, else
    OpenCV's writer); a single (H, W, 3) image → <key>.png. As the JAX
    ``_save_outputs``."""
    import cv2

    def write(path, im):
        if im.shape[-1] == 1:
            im = np.repeat(im, 3, -1)
        im = cv2.resize(im, (out_w, out_h), interpolation=cv2.INTER_LINEAR)
        cv2.imwrite(path, cv2.cvtColor(im, cv2.COLOR_RGB2BGR))

    for key, arr in outs.items():
        if arr.ndim == 3:
            write(os.path.join(out_dir, f"{key}.png"), arr)
            continue
        kdir = os.path.join(out_dir, key)
        os.makedirs(kdir, exist_ok=True)
        for t in range(arr.shape[0]):
            write(os.path.join(kdir, f"{t:06d}.png"), arr[t])
        mp4 = os.path.join(out_dir, f"{key}_{name}.mp4")
        try:
            subprocess.run(
                ["ffmpeg", "-loglevel", "quiet", "-framerate", "30", "-i",
                 os.path.join(kdir, "%06d.png"), "-y", mp4], check=True)
        except (FileNotFoundError, subprocess.CalledProcessError):
            vw = cv2.VideoWriter(mp4, cv2.VideoWriter_fourcc(*"mp4v"), 30,
                                 (out_w, out_h))
            for t in range(arr.shape[0]):
                vw.write(cv2.imread(os.path.join(kdir, f"{t:06d}.png")))
            vw.release()
    return out_dir


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("image")
    p.add_argument("flow")
    p.add_argument("save_dir")
    p.add_argument("--ckpt", default=None)
    p.add_argument("--name", default=None)
    p.add_argument("--W", type=int, default=256)
    p.add_argument("--n-frames", type=int, default=60)
    p.add_argument("--speed", type=float, default=1.0)
    p.add_argument("--align", default="None")
    p.add_argument("--rawsize", action="store_true")
    p.add_argument("--rotate", type=float, default=0.0)
    p.add_argument("--flow-scale", type=float, default=1.0)
    p.add_argument("--dtype", default="float32", choices=DTYPES,
                   help="'bfloat16': bf16 encoder/decoder, f32 splat "
                        "accumulation; 'bfloat16-fast': the splat also "
                        "accumulates in bf16 (frames within ~1e-2)")
    p.add_argument("--alpha-region", default=None,
                   help="SLR edit region: a grayscale image, white where the "
                        "two-layer composite applies")
    p.add_argument("--motion-ckpt", default=None,
                   help="motion-regressor checkpoint: the flow only seeds "
                        "sparse hints, the regressor predicts the motion")
    p.add_argument("--shard-frames", action="store_true",
                   help="render each rank's block of frames, one GPU a rank "
                        "(torchrun --nproc_per_node=K; one rank without it); "
                        "rank 0 writes the files")
    p.add_argument("--sparsify-eps", type=float, default=None,
                   help="zero motion below this speed so dense estimated "
                        "flows ride the sparse path; default: 0.5/N for "
                        "--rawsize renders, 0 otherwise")
    p.add_argument("--crop-decode", choices=["auto", "off"], default="auto",
                   help="'auto': per frame, splat and decode only the moving "
                        "region's window (receptive-field haloed, exact) and "
                        "paste it onto one full-frame static decode, when the "
                        "window is under 85%% of the frame")
    p.add_argument("--profile-stages", action="store_true",
                   help="print the reference's stage times (t_encoder, "
                        "t_euler_integration, t_softmax_splating, t_decoder) "
                        "of the baseline on this scene, uncropped and cropped")
    p.add_argument("--decode-batch", type=int, default=None,
                   help="frames per decode chunk; default sizes the chunk "
                        "to DECODE_PX_BUDGET")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu' for the plain path")
    a = p.parse_args(argv)
    r = SceneRenderer(ckpt=a.ckpt, W=a.W, n_frames=a.n_frames, dtype=a.dtype,
                      motion_ckpt=a.motion_ckpt, decode_batch=a.decode_batch,
                      shard_frames=a.shard_frames, sparsify_eps=a.sparsify_eps,
                      crop_decode=a.crop_decode,
                      profile_stages=a.profile_stages, device=a.device)
    out = r.render(a.image, a.flow, a.save_dir, name=a.name, speed=a.speed,
                   align_json=a.align, rawsize=a.rawsize, rotate=a.rotate,
                   flow_scale=a.flow_scale, alpha_region_path=a.alpha_region)
    r.close()
    print(f"rendered to {out}")
    return r


if __name__ == "__main__":
    main()
