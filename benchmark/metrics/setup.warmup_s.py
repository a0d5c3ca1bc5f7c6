"""setup.warmup_s: host seconds of the warm-up (the cell's launch, image
fetch, pixel gather and history reset), closed by a synchronise (layer:
set-up; moves ``setup_s``)."""


def read(rec):
    return rec["setup"].get("warmup_s")
