"""Evaluation CLI on the GPU (PyTorch port of ``slrsfs_tpu/cli/eval.py``;
reference ``evaluation/animation/eval_CLAW*.py``):

    python -m slrsfs_tpu_torch.cli.eval PRED_DIR GT_DIR [--fluid \
        --flow-dir D --input-dir D] [--vgg16-pth P --alexnet-pth P \
        --lpips-pth P] [--i3d-pth P] [--device cuda|cpu]

Writes ``--out`` (default ``PRED_DIR/../metric.json``, or
``metric_fluid.json`` with ``--fluid``) and prints the aggregate Total*
keys as JSON; ``--i3d-pth`` adds TotalFVD to the same file. The metrics
run on ``--device`` (default cuda; a missing card raises).
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("pred_dir")
    p.add_argument("gt_dir")
    p.add_argument("--fluid", action="store_true")
    p.add_argument("--flow-dir", default=None)
    p.add_argument("--input-dir", default=None)
    p.add_argument("--n-frames", type=int, default=60)
    p.add_argument("--gt-suffix", default=".mp4",
                   help='".mp4" for the CLAW layout, "_gt.mp4" for '
                        "eulerian_data (reference eval_eulerian_data.py:84)")
    p.add_argument("--vgg16-pth", default=None)
    p.add_argument("--alexnet-pth", default=None)
    p.add_argument("--lpips-pth", default=None)
    p.add_argument("--i3d-pth", default=None,
                   help="pytorch-i3d Kinetics state_dict; enables the FVD "
                        "metric over the per-scene 60-frame stacks")
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default) or 'cpu' for the plain path")
    a = p.parse_args(argv)

    from slrsfs_tpu_torch.eval.eval_claw import eval_claw_dir, eval_fvd_dir
    from slrsfs_tpu_torch.eval.i3d import FVD
    from slrsfs_tpu_torch.eval.metrics import PerceptualMetrics

    metrics = PerceptualMetrics(a.vgg16_pth, a.alexnet_pth, a.lpips_pth,
                                device=a.device)
    # one output path, so that TotalFVD rewrites the file eval_claw_dir wrote
    out_json = a.out or os.path.join(
        a.pred_dir, "..", "metric_fluid.json" if a.fluid else "metric.json")
    results = eval_claw_dir(
        a.pred_dir, a.gt_dir, metrics=metrics, fluid=a.fluid,
        flow_dir=a.flow_dir, input_dir=a.input_dir, n_frames=a.n_frames,
        out_json=out_json, gt_suffix=a.gt_suffix)
    if a.i3d_pth:
        fvd = FVD(a.i3d_pth, device=a.device)
        results["TotalFVD"] = eval_fvd_dir(a.pred_dir, a.gt_dir, fvd,
                                           n_frames=a.n_frames,
                                           gt_suffix=a.gt_suffix)
        with open(out_json, "w") as f:
            json.dump(results, f)
    agg = {k: v for k, v in results.items()
           if k.startswith("Total") and not isinstance(v, dict)}
    print(json.dumps(agg, indent=2))
    return results


if __name__ == "__main__":
    main()
