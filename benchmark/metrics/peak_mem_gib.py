"""peak_mem_gib: ``torch.cuda.max_memory_allocated()`` over the window,
after ``reset_peak_memory_stats()`` at its start, in GiB (end to end)."""


def read(rec):
    w = rec.get("window")
    peak = w and w.get("peak_bytes")
    return peak / 2 ** 30 if peak else None
