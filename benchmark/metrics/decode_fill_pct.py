"""decode_fill_pct: the share of the pixels the traced decodes take in
that reach the frames, in %: the program's counters ``rollout.kept_px``
(a crop window's paste interior a frame, plus the static decode's frame
outside it; a whole frame uncropped) over ``rollout.decoded_px`` (the
window a frame, plus the static decode's frame)."""

from benchmark.spans import captured


def read(r):
    c = captured("render.scenes")
    if c is None or not c["counters"].get("rollout.decoded_px"):
        return None
    n = c["counters"]
    return 100.0 * n.get("rollout.kept_px", 0) / n["rollout.decoded_px"]
