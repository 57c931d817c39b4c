"""Render every scene of a directory on the GPU (PyTorch port of
``slrsfs_tpu/cli/render_all.py``; reference ``test_animating/*/
test_all_*_scenes.py``):

    python -m slrsfs_tpu_torch.cli.render_all SCENES_DIR SAVE_DIR \
        [--ckpt C] [--start 0] [--end -1] [--align align.json] ...

Each ``<scene>_input.jpg`` renders with its motion file (``--flow-suffix``,
else ``_motion.pth``, ``_motion.npz`` or ``_motion.flo``) through one
``SceneRenderer``: the weights load once, moving sets are bucketed
(``--p-bucket-ratio``) and crop windows quantised, and PNG/mp4 saving
overlaps the next scene's render. ``[--start, --end)`` selects a range of
the sorted scenes, for several jobs.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("scenes_dir")
    p.add_argument("save_dir")
    p.add_argument("--ckpt", default=None)
    p.add_argument("--W", type=int, default=768)
    p.add_argument("--n-frames", type=int, default=60)
    p.add_argument("--speed", type=float, default=1.0)
    p.add_argument("--align", default="None")
    p.add_argument("--rawsize", action="store_true")
    p.add_argument("--dtype", default="bfloat16",
                   choices=["float32", "bfloat16", "bfloat16-fast"])
    p.add_argument("--start", type=int, default=0,
                   help="first scene index (several jobs)")
    p.add_argument("--end", type=int, default=-1)
    p.add_argument("--flow-suffix", default="_motion.flo",
                   help="motion file suffix paired with _input.jpg")
    p.add_argument("--shard-frames", action="store_true",
                   help="shard frames over several GPUs (not ported yet)")
    p.add_argument("--sparsify-eps", type=float, default=None,
                   help="zero motion below this speed (see cli.render; "
                        "default 0.5/N for --rawsize, 0 otherwise)")
    p.add_argument("--opt-overrides", default=None,
                   help="JSON dict of Options fields overriding the "
                        "checkpoint's or the default configuration")
    p.add_argument("--crop-decode", choices=["auto", "off"], default="auto",
                   help="moving-region cropped decode (see cli.render); the "
                        "windows are quantised so that scenes share sizes")
    p.add_argument("--p-bucket-ratio", type=float, default=1.25,
                   help="geometric moving-set size buckets (at most "
                        "ratio - 1 padded rows); 1.0 = 1024-padding")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu' for the plain path")
    a = p.parse_args(argv)

    from slrsfs_tpu_torch.cli.render import SceneRenderer

    inputs = sorted(glob.glob(os.path.join(a.scenes_dir, "*_input.jpg")))
    end = len(inputs) if a.end < 0 else a.end
    inputs = inputs[a.start:end]
    print(f"rendering {len(inputs)} scenes [{a.start}:{end})")
    renderer = SceneRenderer(ckpt=a.ckpt, W=a.W, n_frames=a.n_frames,
                             dtype=a.dtype, shard_frames=a.shard_frames,
                             sparsify_eps=a.sparsify_eps,
                             crop_decode=a.crop_decode,
                             p_bucket_ratio=(a.p_bucket_ratio
                                             if a.p_bucket_ratio > 1.0 else None),
                             opt_overrides=(json.loads(a.opt_overrides)
                                            if a.opt_overrides else None),
                             device=a.device)
    done, skipped = 0, []
    t0 = time.perf_counter()
    for img_path in inputs:
        name = os.path.basename(img_path)[: -len("_input.jpg")]
        flow_path = os.path.join(a.scenes_dir, name + a.flow_suffix)
        if not os.path.exists(flow_path):
            for alt in ("_motion.pth", "_motion.npz", "_motion.flo"):
                cand = os.path.join(a.scenes_dir, name + alt)
                if os.path.exists(cand):
                    flow_path = cand
                    break
            else:
                skipped.append(name)
                continue
        renderer.render(img_path, flow_path, a.save_dir, name=name,
                        speed=a.speed, align_json=a.align, rawsize=a.rawsize)
        done += 1
        print(f"[{done}/{len(inputs)}] {name} "
              f"({time.perf_counter() - t0:.1f}s elapsed)", flush=True)
    renderer.finish()
    elapsed = time.perf_counter() - t0
    if skipped:
        print(f"skipped (no motion file): {skipped}")
    if done:
        # eager PyTorch compiles no program a shape; the count of distinct
        # (moving-set size, window size) shapes says how far the buckets
        # and the quantised windows grouped the scenes
        print(f"sweep: {done} scenes in {elapsed:.1f}s "
              f"({done / elapsed * 3600:.0f} scenes/hour incl. saves), "
              f"{len(renderer.shapes)} distinct (P, window) shape(s)")
    return {"done": done, "elapsed_s": elapsed, "shapes": len(renderer.shapes)}


if __name__ == "__main__":
    main()
