"""What every cell's run shares: the cache directories, the look for the
cards, the readings a run collects, the metric readers (one file each under
``benchmark/metrics/``), the model parts (one file a model type and kind of
cell under ``benchmark/models/``), the trace of a bounded slice, and the
result line.
"""

from __future__ import annotations

import functools
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# top-level module names that must not be loaded in a run: JAX and the JAX
# package (compared whole: the port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "slrsfs_tpu")


def set_cache_dirs(root: str = ROOT) -> None:
    """Fixed build and kernel cache directories inside the checkout (the
    port's own nvcc builds already live in ``build/kernels``), and no flax
    through any library."""
    build = os.path.join(root, "build")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_json(rel: str):
    with open(os.path.join(ROOT, rel)) as f:
        return json.load(f)


@dataclass
class Readings:
    """What a run measured, for the metric readers. Times in seconds."""

    cell: Dict
    traffic: Dict
    config: Dict
    chips: int = 1
    # the precision of the networks' products, which sets the peak of MFU
    dtype: str = "float32"
    setup_s: Optional[float] = None
    window_s: Optional[float] = None
    frames: int = 0
    scene_s: List[float] = field(default_factory=list)
    samples: int = 0
    steps: int = 0
    peak_bytes: int = 0
    # traced slice (``--trace 1``)
    trace: Optional[Dict] = None
    marks: Dict[str, List[float]] = field(default_factory=dict)
    bounds: Dict[str, float] = field(default_factory=dict)
    flops: Optional[float] = None
    extra: Dict = field(default_factory=dict)


def _load_file(path: str, module: str):
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str):
    """The module of metric ``name``: ``benchmark/metrics/<name>.py``, or
    where there is none, the reader of the name's first part
    (``device_idle_pct.render`` → ``device_idle_pct.py``), shared by the
    metric's splits over kinds of cell."""
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    if not os.path.exists(path):
        path = os.path.join(BENCH_DIR, "metrics", name.split(".")[0] + ".py")
    return _load_file(path, "benchmark_metric_" + name.replace(".", "_"))


@functools.lru_cache(maxsize=None)
def model_part(model_type: str, kind: str):
    """The module that runs configurations of ``model_type`` in cells of
    ``kind`` (``render`` or ``train``): ``benchmark/models/<model_type>.<kind>.py``.
    It builds the reference's networks and the program's, and holds what
    else differs between model types; a new model type comes in as new
    files there."""
    path = os.path.join(BENCH_DIR, "models", f"{model_type}.{kind}.py")
    if not os.path.exists(path):
        raise SystemExit(f"no benchmark/models/{model_type}.{kind}.py: {kind} cells of "
                         f"model type {model_type!r} need one")
    return _load_file(path, f"benchmark_model_{model_type}_{kind}")


def cell_metrics(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or
    with ``trace`` its per-layer metrics (a metric without a ``workloads``
    list goes with every cell; a per-layer one, with every cell that
    reports the metric it moves)."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def read_metrics(metrics: List[Dict], r: Readings) -> Dict[str, Dict]:
    """{name: {"value", "unit"}} of the readers that find something."""
    out = {}
    for m in metrics:
        v = load_reader(m["name"]).read(r)
        if v is None:
            continue
        if not math.isfinite(v):
            raise ValueError(f"metric {m['name']} read {v}")
        out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


class Marks:
    """A ``Trainer.train_step(timer=...)`` that records a CUDA event at each
    stage mark and never synchronises (on the CPU, the host clock);
    ``per_stage`` reads them after the slice: {stage: [ms from the previous
    mark, one per step]}."""

    def __init__(self, cuda: bool = True):
        self.cuda = cuda
        self.steps: List[List] = []

    def _event(self):
        if not self.cuda:
            return time.perf_counter()
        import torch

        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def start(self) -> None:
        self.steps.append([("start", self._event())])

    def __call__(self, name: str) -> None:
        self.steps[-1].append((name, self._event()))

    def per_stage(self) -> Dict[str, List[float]]:
        if self.cuda:
            import torch

            torch.cuda.synchronize()
        out: Dict[str, List[float]] = {}
        for marks in self.steps:
            for (_, a), (name, b) in zip(marks, marks[1:]):
                ms = a.elapsed_time(b) if self.cuda else (b - a) * 1e3
                out.setdefault(name, []).append(ms)
        return out


def traced(fn: Callable[[], None], tmp: str) -> Dict:
    """Run ``fn`` under ``torch.profiler`` (host and card) inside the span
    ``bench.slice`` and summarise the trace (``benchmark/trace.py``). The
    trace file is written to ``tmp`` and removed."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark import trace as tr

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function("bench.slice"):
            fn()
            sync()
    path = os.path.join(tmp, "trace.json")
    prof.export_chrome_trace(path)
    try:
        out = tr.summarize(tr.load_events(path), "bench.slice")
    finally:
        os.remove(path)
    print(f"trace: {out['window_s']:.3f} s, card busy {out['busy_s']:.3f} s; "
          f"{out['runtime_calls']} host calls into the CUDA runtime, "
          f"{out['waits_s']:.3f} s of them waiting on the card", flush=True)
    return out


def span(name: str):
    """A host span of the benchmark's own code, seen in the trace."""
    from torch.profiler import record_function

    return record_function("bench." + name)


def device_info(chips: int, peak_bytes: int, trace: Optional[Dict]) -> Dict:
    import torch

    d = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
         "memory_peak_bytes": int(peak_bytes)}
    if trace is not None:
        d["busy_s"] = trace["busy_s"]
        d["window_s"] = trace["window_s"]
    return d


def print_result(correct: bool, attempted: int, failed: int, metrics: Dict,
                 device: Dict, checks: Dict, breakdown: Optional[Dict] = None) -> None:
    """The checks as the last lines of standard error, then the result as
    the last line of standard output, its checks under the last key."""
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    sys.stderr.flush()
    print(json.dumps(out), flush=True)


def scratch_dir() -> str:
    """A directory of this run under the given TMPDIR."""
    return tempfile.mkdtemp(prefix="bench-", dir=tempfile.gettempdir())


def now() -> float:
    return time.perf_counter()
