"""host_ms_per_scene: the host's own work a scene in the traced slice, in
ms: the time of the benchmark's spans around ``scene_flow`` (the
sparsifier), ``frames`` (the moving set, the crop plan, the launches) and
``outputs_to_u8`` (the copy to the host), less the time the host spent
waiting on the card inside them, as the trace shows it
(``benchmark/trace.py:host_seconds``: synchronisations and copies whole,
each launch beyond the slice's median launch, which is a launch blocked on
a full queue). Layer: ``cli/render.py`` ``SceneRenderer``'s host path."""

SPANS = ("scene_flow", "frames", "to_u8")


def read(r):
    if r.trace is None:
        return None
    host = r.trace["host_s"]
    if not all(host.get(s) for s in SPANS):
        return None
    return 1e3 * sum(sum(host[s]) for s in SPANS) / len(host["frames"])
