"""Readings that set the limits of a cell's output check, on the card at the
cell's own size, several seeds in one process:

    python3 benchmark/controls.py --workload CELL --seeds 1 2 3

For each seed it prints one JSON line with the numbers the run compares,
as the control and the faults read them:

* render cells: ``frame_mad_max`` of the control (the reference with its
  convolutions in fp8, ``benchmark/reference/lowprec.py``) against the
  float32 reference, on the scenes a run checks;
* training cells: ``loss_gap``, ``grad_gap`` and ``change_gap`` of the
  control (the reference with TF32 on) and of the fault "half of the batch
  left out, the mean taken over the rest" (the reference on the first half
  of every batch), each against the float32 reference. The fault "a step
  that returns its state unchanged" reads 1 for ``change_gap`` by the
  measure's definition and needs no run.

The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import generate, harness  # noqa: E402


def half_batch(pool):
    """The pool with every batch cut to its first half of samples."""
    def cut(v):
        if isinstance(v, list):
            return [cut(x) for x in v]
        return v[: v.shape[0] // 2]

    return dict(pool, batches=[{k: cut(v) for k, v in b.items()} for b in pool["batches"]])


def render_control(cell, mix, cfg, seed: int, device) -> dict:
    from benchmark.drivers import render as d
    from benchmark.reference.lowprec import fp8_convs

    import torch

    opt = d.options(cfg, mix)
    model, state = d.make_weights(opt, seed, device)
    pool = generate.scene_pool(mix, seed)
    scenes = d.sample_scenes(pool, seed, mix["check_scenes"])
    want = d.reference_frames(model, mix, pool, scenes)
    model.load_state_dict(state)
    ctrl = d.reference_frames(model, mix, pool, scenes, dtype=torch.bfloat16,
                              quantize=fp8_convs)
    return {"control": {"frame_mad_max": d.frame_mad_max(ctrl, want)}}


def train_control(cell, mix, cfg, seed: int, device) -> dict:
    from benchmark.drivers import train as d

    opt = d.options(cfg, mix)
    mods, states = d.make_weights(opt, seed, mix["n_steps"], device)
    pool = generate.batch_pool(mix, seed, d.part_of(opt).batch_extras)
    ref = d.reference_readings(opt, mods, states, mix, pool, seed, device)
    tf32 = d.reference_readings(opt, mods, states, mix, pool, seed, device, allow_tf32=True)
    half = d.reference_readings(opt, mods, states, mix, half_batch(pool), seed, device)
    return {"control": d.compare(tf32, ref), "half_batch": d.compare(half, ref)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    a = p.parse_args(argv)
    harness.set_cache_dirs()
    import torch

    bench = harness.load_json("BENCHMARK.json")
    cell = [w for w in bench["workloads"] if w["name"] == a.workload][0]
    cfg = harness.load_json([c for c in bench["configs"]
                             if c["name"] == cell["config"]][0]["file"])
    mix = harness.load_json(os.path.join("benchmark", "traffic", cell["traffic"] + ".json"))
    fn = render_control if mix["kind"] == "render" else train_control
    for seed in a.seeds:
        out = fn(cell, mix, cfg, seed, torch.device("cuda"))
        print(json.dumps({"workload": a.workload, "seed": seed, **out}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
