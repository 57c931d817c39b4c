"""d2h_ms_per_scene: the copies of a traced scene's uint8 frames to the
host, in ms of the card's clock: the program's timed span ``render.d2h``
(``cli/render.py:outputs_to_u8``'s ``.cpu()`` calls, CUDA events at both
ends) over the counter ``render.scenes``."""

from benchmark.spans import captured, device_s


def read(r):
    c = captured("render.scenes")
    s = None if c is None else device_s(c, ("render.d2h",))
    return None if s is None else 1e3 * s / c["counters"]["render.scenes"]
