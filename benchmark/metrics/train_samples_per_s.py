"""train_samples_per_s: the samples of every step in the window (on
several cards, the global batch), divided by the window's seconds."""


def read(r):
    return r.samples / r.window_s if r.steps else None
