"""updates_ms_per_step: the Adam updates of G and D (``engine/trainer.py``
``Adam``, a Python loop over the parameters), ms a traced step: the CUDA
events from the mark before "updates" to it."""

import numpy as np


def read(r):
    return float(np.mean(r.marks["updates"])) if "updates" in r.marks else None
