"""scene_p90_s: the 90th percentile (linear interpolation) of every
window scene's latency, from the call to ``scene_flow`` to its uint8
frames on the host."""

import numpy as np


def read(r):
    return float(np.percentile(r.scene_s, 90)) if r.scene_s else None
