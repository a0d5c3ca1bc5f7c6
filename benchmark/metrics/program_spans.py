"""The program's own spans and counters over the traced chunk, for the
readers of the ``program_span`` and ``program_counter`` metrics:
``voxelrt_torch.utils.profiling.recorded`` over the chunk's host window,
read after the harness's closing synchronise. The program records exactly
while a profiler session is open, as the traced chunk's is.

A record without a traced chunk, or a program without that recorder (one
older than it), gives None, and so leaves its metric out."""


def program_record(rec):
    """``recorded(*window_ns)`` of the traced chunk, or None."""
    t = rec.get("traced")
    if not t:
        return None
    from voxelrt_torch.utils import profiling

    read = getattr(profiling, "recorded", None)
    return None if read is None else read(*t["window_ns"])


def stream_ms_per_spp(rec, name, whole=False):
    """The stream ms of the spans ``name`` in the traced chunk over its
    samples: each span's self time (its interval between its two timing
    events on the card's stream less its children's), or with ``whole`` its
    interval children included; None where no such span has a stream
    time."""
    r = program_record(rec)
    if r is None:
        return None
    key = "stream_ms" if whole else "stream_self_ms"
    ms = [s[key] for s in r["spans"] if s["name"] == name]
    if not ms or None in ms:
        return None
    return sum(ms) / rec["traced"]["spp"]
