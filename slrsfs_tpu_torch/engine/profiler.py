"""Stage timing, traces and the program's own spans (PyTorch port of
``slrsfs_tpu/engine/profiler.py``).

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

``span`` and ``count`` mark the program's own work where it happens (the
render's host stages and its copies to the host, the rollout's decodes,
the training batch's preparation). They record exactly while a
``torch.profiler`` runs in the process, and cost one flag read otherwise;
a recorded span is a ``slrsfs.<name>`` annotation in that profiler's
trace, on its clock, and ``captured()`` sums what was recorded:

    with torch.profiler.profile(...):
        renderer.frames(img, flow)
    captured()["spans"]["rollout.decode"]["device_s"]
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict, deque
from typing import Dict, Optional

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

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
    as a Chrome trace to ``log_dir/trace.json`` when the block ends; the
    program's spans and counters (``captured()``) start anew."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset()
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


# ---------------------------------------------------------------------------
# The program's spans and counters
# ---------------------------------------------------------------------------

# the StageProfiler stage of each span that a rollout also times as one
STAGE_OF = {"rollout.decode": "t_decoder", "rollout.static_decode": "t_decoder"}
_OFF = contextlib.nullcontext()


class _Recorder:
    """What ``span`` and ``count`` recorded, summed a name as each span
    ends: {name: [n, host ns, device s (None for a name never timed)]}, the
    counters, and the timed spans whose end event the card has not reached
    yet."""

    def __init__(self):
        self.spans: Dict[str, list] = {}
        self.counters: Dict[str, int] = {}
        self.pending: deque = deque()  # (the name's sums, start event, end event)

    def fold(self, wait: bool) -> None:
        """Add the device time of the pending spans the card has finished
        (``wait``: of all of them) to their names' sums."""
        while self.pending and (wait or self.pending[0][2].query()):
            sums, e0, e1 = self.pending.popleft()
            if wait:
                e1.synchronize()
            sums[2] += e0.elapsed_time(e1) * 1e-3


_REC = _Recorder()


class _Span:
    """A recorded span: ``record_function("slrsfs." + name)`` around the
    block, its host clock, and timed on the card a CUDA event at each end."""

    __slots__ = ("name", "timed", "rf", "t0", "e0")

    def __init__(self, name: str, timed: bool):
        self.name, self.timed = name, timed
        self.e0 = None

    def __enter__(self):
        self.rf = torch.profiler.record_function("slrsfs." + self.name)
        self.rf.__enter__()
        if self.timed and torch.cuda.is_initialized():
            self.e0 = torch.cuda.Event(enable_timing=True)
            self.e0.record()
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        host = time.perf_counter_ns() - self.t0
        rec = _REC
        sums = rec.spans.setdefault(self.name, [0, 0, None])
        sums[0] += 1
        sums[1] += host
        if self.timed:
            sums[2] = sums[2] or 0.0
            if self.e0 is None:
                sums[2] += host * 1e-9
            else:
                e1 = torch.cuda.Event(enable_timing=True)
                e1.record()
                rec.pending.append((sums, self.e0, e1))
                rec.fold(wait=False)
        self.rf.__exit__(*exc)
        return False


@contextlib.contextmanager
def _span_and_stage(sp: _Span, stage):
    with sp, stage:
        yield


def span(name: str, timed: bool = False, stages: Optional[StageProfiler] = None):
    """A context manager around the program's work ``name``. While a
    ``torch.profiler`` runs in the process it is recorded: a
    ``record_function("slrsfs." + name)`` in the trace, on the profiler's
    clock, its length on the host clock and, with ``timed``, a CUDA event
    at each end on the current stream, never synchronised (without CUDA in
    the process, the host clock); otherwise it does nothing but read the
    profiler's flag. With ``stages`` the block is also that
    ``StageProfiler``'s stage ``STAGE_OF[name]``."""
    on = _autograd_profiler._is_profiler_enabled
    if stages is not None:
        stage = stages.stage(STAGE_OF[name])
        return _span_and_stage(_Span(name, timed), stage) if on else stage
    return _Span(name, timed) if on else _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a ``torch.profiler`` runs
    (as ``span`` records)."""
    if _autograd_profiler._is_profiler_enabled:
        _REC.counters[name] = _REC.counters.get(name, 0) + n


def captured() -> Dict:
    """What was recorded since the last ``reset``: {"spans": {name: {"n",
    "host_s" (the summed lengths on the host clock), "device_s" (timed
    spans: start event to end event, summed; None for a name never
    timed)}}, "counters": {name: n}}. Waits for the card to reach the
    timed spans' end events; spans still open are left out."""
    _REC.fold(wait=True)
    return {"spans": {k: {"n": n, "host_s": h * 1e-9, "device_s": d}
                      for k, (n, h, d) in _REC.spans.items()},
            "counters": dict(_REC.counters)}


def reset() -> None:
    """Forget every recorded span and counter (``profile_trace`` does on
    entry)."""
    global _REC
    _REC = _Recorder()
