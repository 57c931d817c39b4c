"""g_ms_per_step: G's forward and backward, ms a traced step: the CUDA
events that ``Trainer.train_step(timer=...)`` records at its step start
and its "G forward" and "G backward" marks."""

import numpy as np


def read(r):
    if "G backward" not in r.marks:
        return None
    return float(np.mean(np.add(r.marks["G forward"], r.marks["G backward"])))
