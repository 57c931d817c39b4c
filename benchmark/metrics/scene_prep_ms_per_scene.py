"""scene_prep_ms_per_scene: the host's work a traced scene before its
first rollout launch, in ms, from the program's own spans: the sparsifier
(``render.sparsify``), the moving set (``render.moving_set``), the four
copies to the card (``render.upload``) and the crop plan with K1 and its
readback (``rollout.crop_plan``), over the counter ``render.scenes``. The
card has nothing of the scene queued meanwhile. Layer: ``cli/render.py``
``SceneRenderer``'s host path."""

from benchmark.spans import captured, host_s

SPANS = ("render.sparsify", "render.moving_set", "render.upload", "rollout.crop_plan")


def read(r):
    c = captured("render.scenes")
    s = None if c is None else host_s(c, SPANS)
    return None if s is None else 1e3 * s / c["counters"]["render.scenes"]
