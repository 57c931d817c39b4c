"""decode_ms_per_frame: the decoder's ms a traced frame on the card's
clock, on the traffic the slice runs and never synchronised: the program's
timed spans ``rollout.decode`` (each decode chunk, with its paste) and
``rollout.static_decode`` (a crop render's one full-frame decode), over
the counter ``render.frames``."""

from benchmark.spans import captured, device_s


def read(r):
    c = captured("render.scenes")
    s = None if c is None else device_s(c, ("rollout.decode", "rollout.static_decode"))
    frames = 0 if c is None else c["counters"].get("render.frames", 0)
    return 1e3 * s / frames if s is not None and frames else None
