"""The harness on the CPU: the frozen work counts against hand counts, the
imports of a run, a cell added by files alone, and the output check
failing when the timed path is broken underneath."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.roofline import counts, peaks
from benchmark.tests import toy

RENDER = "baseline-render768-bf16"
TRAIN = "baseline-train256-f32"


def test_k2_k3_k7_counts_by_hand():
    # K2, one frame: 3 valid rows of 5 channels, 4 rows, a 2x2 window
    t, by = counts.k2(3, 4, 2, 2, 5, 4)
    n_bytes = 3 * (5 * 4 + 8 + 16) + 4 * 4 + 4 * 5 * 4 + 4 * 4 * 4
    n_ops = 2 * 3 * 5 * 9 + 4 * 4
    assert t == pytest.approx(max(n_bytes / peaks.HBM_BYTES_PER_S, n_ops / peaks.FP32_FLOPS))
    assert by == "bytes"
    # K3 on (1, 2, 2, 3): 4 pixels
    assert counts.k3_fwd(1, 2, 2, 3)[0] == pytest.approx(
        max((4 * 3 * 8 + 32) / peaks.HBM_BYTES_PER_S, 4 * 44 / peaks.FP32_FLOPS))
    assert counts.k3_bwd(1, 2, 2, 3)[0] == pytest.approx(
        max((4 * 3 * 12 + 64) / peaks.HBM_BYTES_PER_S, 4 * 88 / peaks.FP32_FLOPS))
    assert counts.k7(1, 2, 2, 10) == (max(104 / peaks.HBM_BYTES_PER_S,
                                          200 / peaks.LANE_OPS), "bytes")


def test_k7_steps_by_hand():
    # one sample 4x4, one moving pixel at (1, 1) going right one pixel a
    # step: forward 2 steps (t_f = 2), backward 2 steps of -M (t_p = 2)
    m = torch.zeros((1, 4, 4, 2))
    m[0, 1, 1] = torch.tensor([1.0, 0.0])
    tf, tp = np.array([2]), np.array([2])
    # forward: step 1 moves to (2, 1) and stays inside, step 2 gathers a
    # zero motion there and stays: both count; backward: (1,1) → (0,1) →
    # gathers a zero motion at (0, 1): both count
    assert counts.k7_steps(m, tf, tp, 4) == 4
    pos = torch.tensor([[[1, 1], [0, 0]]], dtype=torch.int32)
    val = torch.tensor([[1.0, 0.0]])
    assert counts.k7_steps(m, tf, tp, 4, pos, val) == 4
    # a pixel that leaves the frame on its first step counts that step only
    m[0, 1, 1] = torch.tensor([-3.0, 0.0])
    assert counts.k7_steps(m, np.array([3]), np.array([0]), 4) == 1


def test_flops_count_a_conv_by_hand():
    from torch.utils.flop_counter import FlopCounterMode

    x = torch.empty((2, 3, 8, 8), device="meta")
    w = torch.empty((5, 3, 3, 3), device="meta")
    with FlopCounterMode(display=False) as fc:
        torch.nn.functional.conv2d(x, w, padding=1)
    assert fc.get_total_flops() == 2 * (2 * 8 * 8) * 5 * (3 * 3 * 3)


def test_host_seconds_by_hand():
    """A span of 100 us holding a launch of 5 us (the median), a launch of
    25 us (20 of them blocked on the queue), a synchronisation of 30 us and
    an allocation of 10 us: 100 - 20 - 30 = 50 us of the host's own work."""
    from benchmark import trace

    def ev(cat, name, ts, dur):
        return {"cat": cat, "name": name, "ts": ts, "dur": dur}

    events = [ev("user_annotation", "bench.slice", 0.0, 1000.0),
              ev("user_annotation", "bench.frames", 100.0, 100.0),
              ev("cuda_runtime", "cudaLaunchKernel", 110.0, 5.0),
              ev("cuda_runtime", "cudaLaunchKernel", 120.0, 25.0),
              ev("cuda_runtime", "cudaStreamSynchronize", 150.0, 30.0),
              ev("cuda_runtime", "cudaMalloc", 185.0, 10.0),
              ev("cuda_runtime", "cudaLaunchKernel", 300.0, 5.0),
              ev("kernel", "k", 110.0, 50.0)]
    out = trace.summarize(events, "bench.slice")
    assert out["host_s"] == {"frames": [pytest.approx(50e-6)]}
    assert out["runtime_calls"] == 5 and out["waits_s"] == pytest.approx(50e-6)
    assert out["busy_s"] == pytest.approx(50e-6)


def _run_in_subprocess(code: str) -> str:
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=toy.REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


def test_a_run_loads_no_jax_and_the_reference_no_port(tmp_path):
    """A whole toy run of every kind in one process, then its top-level
    modules compared whole with JAX's and the JAX package's; the reference
    alone loads nothing of the port."""
    code = f"""
import sys, json
sys.path.insert(0, {toy.REPO!r})
from benchmark.tests import toy
d = toy.make_copy({str(tmp_path)!r})
run = toy.load_run(d)
for w in ({RENDER!r}, {TRAIN!r}):
    run.run_cell(toy.args(w, trace=1), device="cpu", t_start=0.0)
from benchmark import harness
print(json.dumps(harness.forbidden_modules()))
"""
    assert json.loads(_run_in_subprocess(code)) == []
    code = f"""
import sys, json, pkgutil, importlib
sys.path.insert(0, {toy.REPO!r})
import benchmark.reference as ref
for m in pkgutil.walk_packages(ref.__path__, "benchmark.reference."):
    importlib.import_module(m.name)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}}
                        & {{"jax", "jaxlib", "flax", "slrsfs_tpu", "slrsfs_tpu_torch"}})))
"""
    assert json.loads(_run_in_subprocess(code)) == []


# a render part for SLR's model type, which the benchmark does not have:
# its network is the reference's SLR model and its reference render a stub
# (the toy cell's limit passes any frames)
SLR_RENDER_PART = """
import torch
from benchmark.reference.models.slr import SLRModel


def build(opt):
    return SLRModel(opt)


def render_frames(model, img, flow, n_frames, eps, bucket_ratio, decode_batch_for, dtype,
                  crop_decode):
    return torch.zeros((n_frames,) + flow.shape[:2] + (3,)), None


def scene_work(opt, mix, flow, splat_channels, device):
    return 1.0, 1.0


def program_readings(renderer, img, flow, n_frames):
    return {}
"""


@pytest.mark.parametrize("config", ["baseline", "slr"])
def test_a_cell_is_added_by_files_alone(config, tmp_path):
    """A toy configuration (a copy of ``config``), traffic mix, per-layer
    metric and limits file, and their entries in BENCHMARK.json: the new
    cell runs and reports the new metric with no other file edited; for
    SLR, whose model type no render cell has, a new model part file brings
    it in. Taken out again, the copy is as it was and its cells still
    run."""
    d = toy.make_copy(str(tmp_path))
    bench_path = os.path.join(d, "BENCHMARK.json")
    with open(bench_path) as f:
        original = f.read()
    bench = json.loads(original)
    b = os.path.join(d, "benchmark")
    cfg = json.load(open(os.path.join(b, "configs", config + ".json")))
    added = {os.path.join(b, "configs", "toy.json"): dict(cfg, name="toy"),
             os.path.join(b, "traffic", "toy_mix.json"): dict(
                json.load(open(os.path.join(b, "traffic", "claw768_sweep.json"))),
                dtype="float32", crop_decode="off"),
             os.path.join(b, "limits", "toy-cell.json"): {"frame_mad_max": 255.0}}
    for path, obj in added.items():
        with open(path, "w") as f:
            json.dump(obj, f)
    metric = os.path.join(b, "metrics", "toy_frames_per_scene.py")
    files = list(added) + [metric]
    with open(metric, "w") as f:
        f.write("def read(r):\n    return r.frames / len(r.scene_s) if r.scene_s else None\n")
    part = os.path.join(b, "models", cfg["options"]["model_type"] + ".render.py")
    if not os.path.exists(part):
        with open(part, "w") as f:
            f.write(SLR_RENDER_PART)
        files.append(part)
    assert (len(files) == 5) == (config == "slr")
    bench["configs"].append({"name": "toy", "source": "https://example.org/toy",
                             "file": "benchmark/configs/toy.json", "reduced": [],
                             "why": "a toy"})
    bench["workloads"].append({"name": "toy-cell", "config": "toy", "traffic": "toy_mix",
                               "chips": 1, "why": "a toy"})
    bench["end_to_end"][0]["workloads"].append("toy-cell")
    bench["per_layer"].append({"name": "toy_frames_per_scene", "unit": "frames",
                               "better": "higher", "source": "program_counter",
                               "layer": "toy", "moves": "render_fps",
                               "workloads": ["toy-cell"]})
    with open(bench_path, "w") as f:
        json.dump(bench, f)
    run = toy.load_run(d)
    out = run.run_cell(toy.args("toy-cell", trace=1), device="cpu", t_start=0.0)
    assert out["correct"]
    assert out["metrics"]["toy_frames_per_scene"]["value"] == toy.TINY_RENDER["n_frames"]
    out = run.run_cell(toy.args("toy-cell"), device="cpu", t_start=0.0)
    assert set(out["metrics"]) == {"render_fps", "setup_s"}
    for path in files:
        os.remove(path)
    with open(bench_path, "w") as f:
        f.write(original)
    run = toy.load_run(d)
    assert run.run_cell(toy.args(RENDER), device="cpu", t_start=0.0)["correct"]


def _flip_last_frame(outputs_to_u8):
    def broken(outs):
        u8 = outputs_to_u8(outs)
        u8["PredImg"][-1] = u8["PredImg"][-1, ::-1]
        return u8

    return broken


def _still_frames(frames):
    def broken(self, img, flow, **kw):
        out = frames(self, img, flow, **kw)
        return out[:1].expand_as(out).clone()

    return broken


def _frozen_adam(step):
    def broken(self, grads):
        self.count += 1

    return broken


def _nan_after_check(train_step):
    calls = []

    def broken(self, batch, **kw):
        logs = train_step(self, batch, **kw)
        calls.append(1)
        if len(calls) > toy.TINY_TRAIN["check_steps"]:
            logs["Total Loss"] = logs["Total Loss"] * float("nan")
        return logs

    return broken


def _half_batch(train_step):
    def broken(self, batch, **kw):
        def cut(v):
            return [cut(x) for x in v] if isinstance(v, list) else v[: v.shape[0] // 2]

        return train_step(self, {k: cut(v) for k, v in batch.items()}, **kw)

    return broken


FAULTS = {
    "render_answer_altered": (RENDER, "slrsfs_tpu_torch.cli.render", None, "outputs_to_u8",
                              _flip_last_frame),
    "render_state_unchanged": (RENDER, "slrsfs_tpu_torch.cli.render", "SceneRenderer",
                               "frames", _still_frames),
    "train_state_unchanged": (TRAIN, "slrsfs_tpu_torch.engine.trainer", "Adam", "step",
                              _frozen_adam),
    "train_half_batch": (TRAIN, "slrsfs_tpu_torch.engine.trainer", "Trainer", "train_step",
                         _half_batch),
    "train_window_loss_nan": (TRAIN, "slrsfs_tpu_torch.engine.trainer", "Trainer",
                              "train_step", _nan_after_check),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(fault, tmp_path, monkeypatch):
    """A run without the look for a chip, with the timed path broken under
    it, under the cell's own limits: ``correct`` comes out false."""
    import importlib

    cell, module, cls, attr, breaker = FAULTS[fault]
    mod = importlib.import_module(module)
    owner = getattr(mod, cls) if cls else mod
    monkeypatch.setattr(owner, attr, breaker(getattr(owner, attr)))
    run = toy.load_run(toy.make_copy(str(tmp_path)))
    out = run.run_cell(toy.args(cell), device="cpu", t_start=0.0)
    assert not out["correct"], out["checks"]
