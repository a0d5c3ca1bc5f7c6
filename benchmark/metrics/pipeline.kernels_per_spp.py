"""pipeline.kernels_per_spp: the device kernels of the traced chunk over its
samples, a count (copies and sets are not kernels and are left out)
(layer: pipeline; moves ``spp_per_s``)."""


def read(rec):
    t = rec.get("traced")
    if not t or not t["events"]:
        return None
    n = sum(1 for name, _, _ in t["events"]
            if not name.startswith(("Memcpy", "Memset")))
    return n / t["spp"]
