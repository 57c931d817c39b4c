"""A copy of the benchmark in a temporary directory with tiny cells that run
on the CPU: the real cells' configurations and limits, traffic mixes cut
to 32-64 px, a few frames and a batch of 2."""

from __future__ import annotations

import json
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TINY_RENDER = {"W": 64, "n_frames": 12, "order_groups": 2, "order_cycles": 4,
               "check_scenes": 2, "trace_scenes": 1,
               "bands": [[0.15, 0.5, 0.2, 0.4], [0.3, 0.6, 0.5, 0.5],
                         [0.45, 0.8, 0.7, 0.1], [0.9, 0.95, 0.5, 0.5]]}
TINY_TRAIN = {"batch_size": 2, "W": 64, "n_steps": 4, "pool": 3, "check_steps": 2,
              "trace_steps": 1, "middle_index_range": [1, 2],
              "bands": [[0.2, 0.5, 0.3, 0.6], [0.4, 0.8, 0.6, 0.2]]}


def make_copy(dest: str) -> str:
    """``dest`` holding BENCHMARK.json and ``benchmark/`` as in the repo,
    with every traffic mix cut to the tiny sizes above, and the port linked
    in beside them."""
    shutil.copytree(os.path.join(REPO, "benchmark"), os.path.join(dest, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dest)
    os.symlink(os.path.join(REPO, "slrsfs_tpu_torch"), os.path.join(dest, "slrsfs_tpu_torch"))
    traffic = os.path.join(dest, "benchmark", "traffic")
    for name in os.listdir(traffic):
        path = os.path.join(traffic, name)
        with open(path) as f:
            mix = json.load(f)
        mix.update(TINY_RENDER if mix["kind"] == "render" else TINY_TRAIN)
        with open(path, "w") as f:
            json.dump(mix, f)
    return dest


def load_run(dest: str):
    """``benchmark.run`` of the copy at ``dest`` (its modules replace any
    loaded from elsewhere)."""
    for m in [m for m in sys.modules if m == "benchmark" or m.startswith("benchmark.")]:
        del sys.modules[m]
    sys.path.insert(0, dest)
    try:
        import benchmark.run as run
    finally:
        sys.path.remove(dest)
    return run


def args(workload: str, seed: int = 5, seconds: float = 0.5, trace: int = 0):
    import argparse

    return argparse.Namespace(workload=workload, seed=seed, seconds=seconds, trace=trace)
