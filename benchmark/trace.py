"""Reading a ``torch.profiler`` Chrome trace of one traced slice: the card's
busy time (the union of its kernel, copy and memset intervals: cuDNN runs
some convolutions on streams of its own, so intervals overlap), the time by
device operation name, the idle gaps, each labelled by what the host was
doing (the benchmark's own span and the host operation running at the
gap's middle), and the host's own work in each of the benchmark's spans.
The union arithmetic is ``slrsfs_tpu_torch/tools/trace_busy.py``'s,
without its fixed span name.
"""

from __future__ import annotations

import bisect
import json
import statistics
from collections import Counter
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "bench."
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
# runtime calls that wait on the card for their whole length
WAITS = ("Synchronize", "Memcpy", "Free")


def load_events(path: str) -> list:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _label(mid: float, spans: list, ops: list) -> str:
    """The innermost benchmark span and host operation holding ``mid``."""
    def inner(evs):
        best = None
        for e in evs:
            if e["ts"] <= mid < e["ts"] + e.get("dur", 0.0):
                if best is None or e["ts"] >= best["ts"]:
                    best = e
        return best

    span, op = inner(spans), inner(ops)
    parts = [span["name"][len(SPAN_PREFIX):] if span else "outside spans"]
    if op is not None:
        parts.append(op["name"])
    return "/".join(parts)


def host_seconds(events: list, spans: list, t0: float, t1: float) -> Dict:
    """{"host_s": {span name: [seconds of the host's own work in each span]},
    "runtime_calls", "waits_s"}: each span's length less the time its
    thread waited on the card inside it. A call into the CUDA runtime that
    synchronises, copies or frees waits for its whole length; a launch
    waits for what it takes beyond the slice's median launch (it blocks
    while the card's queue is full)."""
    rt = sorted((e for e in events if e.get("cat") in RUNTIME_CATS
                 and t0 <= e["ts"] <= t1), key=lambda e: e["ts"])
    launches = [e.get("dur", 0.0) for e in rt if "Launch" in e["name"]]
    typical = statistics.median(launches) if launches else 0.0

    def wait(e) -> float:
        if any(k in e["name"] for k in WAITS):
            return e.get("dur", 0.0)
        if "Launch" in e["name"]:
            return max(0.0, e.get("dur", 0.0) - typical)
        return 0.0

    starts = [e["ts"] for e in rt]
    acc = [0.0]
    for e in rt:
        acc.append(acc[-1] + wait(e))
    host: Dict[str, List[float]] = {}
    for s in spans:
        a, b = s["ts"], s["ts"] + s.get("dur", 0.0)
        w = acc[bisect.bisect_right(starts, b)] - acc[bisect.bisect_left(starts, a)]
        host.setdefault(s["name"][len(SPAN_PREFIX):], []).append((b - a - w) * 1e-6)
    return {"host_s": host, "runtime_calls": len(rt), "waits_s": acc[-1] * 1e-6}


def summarize(events: list, slice_name: str, top: int = 10) -> Dict:
    """The card's work inside the host span ``slice_name`` (exactly one):
    {"window_s", "busy_s", "by_name": {device op: s}, "device_ops": the
    ``top`` longest by summed time, "idle_gaps": the ``top`` longest idle
    gaps as [label, s]}, and ``host_seconds``' keys."""
    sl = [e for e in events if e.get("name") == slice_name
          and e.get("cat") == "user_annotation"]
    if len(sl) != 1:
        raise ValueError(f"{len(sl)} '{slice_name}' spans in the trace")
    t0, t1 = sl[0]["ts"], sl[0]["ts"] + sl[0]["dur"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS
           and e["ts"] < t1 and e["ts"] + e.get("dur", 0.0) > t0]
    by_name: Counter = Counter()
    intervals = []
    for e in dev:
        a, b = max(e["ts"], t0), min(e["ts"] + e.get("dur", 0.0), t1)
        by_name[e["name"]] += (b - a) * 1e-6
        intervals.append((a, b))
    busy = _union(intervals)
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name", "").startswith(SPAN_PREFIX) and e["name"] != slice_name
             and t0 <= e["ts"] <= t1]
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and t0 <= e["ts"] <= t1]
    gaps = []
    last = t0
    for a, b in busy + [(t1, t1)]:
        if a > last:
            gaps.append((last, a))
        last = max(last, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    return {**host_seconds(events, spans, t0, t1),
            "window_s": (t1 - t0) * 1e-6,
            "busy_s": sum(b - a for a, b in busy) * 1e-6,
            "by_name": dict(by_name),
            "device_ops": [[n, s] for n, s in by_name.most_common(top)],
            "idle_gaps": [[_label((a + b) / 2.0, spans, ops), (b - a) * 1e-6]
                          for a, b in gaps[:top]]}


def seconds_of(by_name: Dict[str, float], names) -> float:
    """Summed device seconds of the operations whose name contains any of
    ``names``; 0.0 when none ran."""
    return sum(s for n, s in by_name.items() if any(k in n for k in names))
