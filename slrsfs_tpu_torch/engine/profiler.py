"""Stage timing and traces (PyTorch port of ``slrsfs_tpu/engine/profiler.py``).

The reference times its stages behind DEBUG_TIME flags with
``torch.cuda.synchronize()`` brackets (``test_baseline_4eval_rawsize.py:
187-202,209-233``). ``StageProfiler`` keeps the same stage names and
synchronises the card at the end of each stage; ``profile_trace`` records
a ``torch.profiler`` trace of the host and the card:

    prof = StageProfiler(device)
    with prof.stage("t_encoder"):
        fs = model.encode(img)
    print(prof.sums())

    with profile_trace("build/trace"):  # build/trace/trace.json
        run()
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import numpy as np
import torch

from slrsfs_tpu_torch.engine.init_utils import resolve_device


class StageProfiler:
    """Seconds per stage, a list for each name (reference stage names:
    t_encoder, t_euler_integration, t_softmax_splating, t_decoder). On the
    card a stage is timed by CUDA events recorded at its start and end,
    the end synchronised; on the CPU by the host clock. The device defaults
    to the card, as every entry point of the port does, and a host without
    one raises (``engine.init_utils.resolve_device``): host-clock timing of
    queued card work would time its enqueue. ``device="cpu"`` is the
    host-clock mode."""

    def __init__(self, device="cuda"):
        self.cuda = resolve_device(device).type == "cuda"
        self.times: Dict[str, list] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.cuda:
            t0 = time.perf_counter()
            yield
            self.times[name].append(time.perf_counter() - t0)
            return
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        end.synchronize()
        self.times[name].append(start.elapsed_time(end) / 1e3)

    def sums(self) -> Dict[str, float]:
        return {k: float(np.sum(v)) for k, v in self.times.items()}


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """``torch.profiler`` over the block, host and card activities, written
    as a Chrome trace to ``log_dir/trace.json`` when the block ends."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
