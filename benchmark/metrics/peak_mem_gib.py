"""``torch.cuda.max_memory_allocated()`` over set-up and window (GiB)."""


def read(run):
    if run.memory_peak_bytes <= 0:
        return None
    return run.memory_peak_bytes / 2 ** 30
