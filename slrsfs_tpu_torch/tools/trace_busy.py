"""The card's busy share of one annotated span of a ``torch.profiler`` trace.

    python -m slrsfs_tpu_torch.tools.trace_busy TRACE.json[.gz]

Reads the Chrome trace that ``engine/profiler.py:profile_trace`` writes,
finds the host span ``SPAN`` (the ``torch.profiler.record_function`` block
that ``chip_smoke.py`` puts around the traced crop render) and measures
the card's work inside it: its kernels, copies and memsets. cuDNN runs
some convolutions across several streams of its own, so device intervals
overlap: the busy time is the union of the intervals over the span, and
the sum of their durations exceeds it by the time two or more streams ran
at once. ``device_busy`` reports both and the time at each count of
running streams, so that the two reconcile: sum = Σ k · t_k and busy =
Σ_{k ≥ 1} t_k.
"""

from __future__ import annotations

import argparse
import gzip
import json
from collections import Counter, defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN = "crop render"
TOP = 8  # kernel names listed by summed duration


def load_events(path: str) -> list:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)["traceEvents"]


def device_busy(events: list, span_name: str) -> dict:
    """The card's work in the host span ``span_name`` (exactly one) →
    {"span_us", "busy_us": the union of the device intervals clipped to the
    span, "busy_unclipped_us": their union unclipped, "sum_us": the sum of
    their durations, "by_running": {k: µs of the span with k intervals
    running}, "streams": {stream: (intervals, µs)}, "n_kernels",
    "names": {kernel name: µs}}."""
    span = [e for e in events if e.get("name") == span_name
            and e.get("cat") == "user_annotation"]
    if len(span) != 1:
        raise ValueError(f"{len(span)} '{span_name}' spans in the trace")
    t0, t1 = span[0]["ts"], span[0]["ts"] + span[0]["dur"]
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    if not dev:
        raise ValueError("the trace holds no device events")
    edges = []
    streams = defaultdict(lambda: [0, 0.0])
    names = Counter()
    for e in dev:
        a, b = e["ts"], e["ts"] + e["dur"]
        edges += [(a, 1), (b, -1)]
        streams[e.get("tid")][0] += 1
        streams[e.get("tid")][1] += e["dur"]
        names[e["name"]] += e["dur"]
    edges.sort()
    by_running = Counter()
    clipped = unclipped = 0.0
    running, last = 0, edges[0][0]
    for t, d in edges:
        if running:
            unclipped += t - last
        lo, hi = max(last, t0), min(t, t1)
        if hi > lo:
            by_running[running] += hi - lo
            if running:
                clipped += hi - lo
        running, last = running + d, t
    by_running[0] += max(0.0, min(edges[0][0], t1) - t0) + max(0.0, t1 - max(last, t0))
    return {"span_us": t1 - t0, "busy_us": clipped, "busy_unclipped_us": unclipped,
            "sum_us": sum(e["dur"] for e in dev), "by_running": dict(by_running),
            "streams": {k: tuple(v) for k, v in streams.items()},
            "n_kernels": sum(1 for e in dev if e["cat"] == "kernel"),
            "names": dict(names)}


def summary(b: dict) -> str:
    """One line: span, busy (clipped and not), the sum of durations, the
    streams and the time at each count of running streams, in ms."""
    ms = lambda us: f"{us / 1e3:.1f} ms"  # noqa: E731
    share = b["busy_us"] / b["span_us"]
    running = ", ".join(f"{k}: {ms(v)}" for k, v in sorted(b["by_running"].items()))
    return (f"span {ms(b['span_us'])}, device busy {ms(b['busy_us'])} = "
            f"{100.0 * share:.1f} % (idle {100.0 * (1.0 - share):.1f} %; union "
            f"unclipped {ms(b['busy_unclipped_us'])}); {b['n_kernels']} kernels on "
            f"{len(b['streams'])} streams, durations summing to {ms(b['sum_us'])}; "
            f"time by intervals running at once: {running}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("trace")
    a = p.parse_args(argv)
    b = device_busy(load_events(a.trace), SPAN)
    print(summary(b))
    for s, (n, us) in sorted(b["streams"].items(), key=lambda kv: -kv[1][1]):
        print(f"  stream {s}: {n} intervals, {us / 1e3:.1f} ms")
    for name, us in Counter(b["names"]).most_common(TOP):
        print(f"  {us / 1e3:9.1f} ms  {name[:100]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
