"""batch_prep_ms_per_step: the host's batch preparation a traced step, in
ms, from the program's own spans: the moving sets
(``cli/train.py:attach_moving_sets``, ``train.moving_sets``) and the
copies to the card (``to_device_batch``, ``train.upload``), over the
counter ``train.steps``."""

from benchmark.spans import captured, host_s


def read(r):
    c = captured("train.steps")
    s = None if c is None else host_s(c, ("train.moving_sets", "train.upload"))
    return None if s is None else 1e3 * s / c["counters"]["train.steps"]
