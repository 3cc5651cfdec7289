"""``torch.cuda.max_memory_allocated()`` over the window, the peak reset at
its start, in GiB."""


def read(stats, cell):
    peak = stats.get("memory_peak_bytes")
    return peak / 2**30 if peak else None
