"""spp_per_s: every sample a pixel completed in the window over the
window's wall time; the window closes at the first chunk end after
``--seconds`` and the samples of an unfinished still count (end to end,
host clock)."""


def read(rec):
    w = rec.get("window")
    return w["spp"] / w["seconds"] if w and w["seconds"] > 0 else None
