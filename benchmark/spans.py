"""The program's own spans and counters for the metric readers: what
``slrsfs_tpu_torch/engine/profiler.py:captured()`` holds after the traced
slice, the only stretch of a run under ``torch.profiler`` and so the only
one the program records. A program without that recorder gives nothing."""

from __future__ import annotations

from typing import Dict, Iterable, Optional


def captured(unit: str) -> Optional[Dict]:
    """The program's capture, or None when it has no recorder or recorded
    no ``unit`` (``render.scenes`` or ``train.steps``)."""
    try:
        from slrsfs_tpu_torch.engine.profiler import captured as program_captured
    except ImportError:
        return None
    c = program_captured()
    return c if c["counters"].get(unit) else None


def host_s(c: Dict, names: Iterable[str]) -> Optional[float]:
    """Summed host seconds of the spans ``names``; None when none ran."""
    got = [c["spans"][n]["host_s"] for n in names if n in c["spans"]]
    return sum(got) if got else None


def device_s(c: Dict, names: Iterable[str]) -> Optional[float]:
    """Summed device seconds (start event to end event) of the timed spans
    ``names``; None when none ran."""
    got = [c["spans"][n]["device_s"] for n in names
           if c["spans"].get(n, {}).get("device_s") is not None]
    return sum(got) if got else None
