"""peak_mem_gib: ``torch.cuda.max_memory_allocated()`` over the window, on
the fullest card, in GiB."""


def read(r):
    return r.peak_bytes / 2.0 ** 30 if r.peak_bytes else None
