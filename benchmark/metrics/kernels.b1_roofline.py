"""kernels.b1_roofline: B1's least time over its profiled time in the
traced chunk, in %. The least time is the bytes its dispatches were handed
(``b1_bytes.dispatch_bytes``) over the card's published memory bandwidth
(``peaks.json``); the card's power limit is printed beside it (layer:
kernels; moves ``spp_per_s``)."""

from benchmark.harness.trace import matches
from benchmark.metrics.b1_bytes import dispatch_bytes


def read(rec):
    t, peaks = rec.get("traced"), rec.get("peaks")
    names = t and t["kernels"].get(t["b1_source"])
    if not names or not peaks or not t["dispatches"]:
        return None
    ns = sum(e - s for name, s, e in t["events"] if matches(name, names))
    if not ns:
        return None
    nbytes = sum(dispatch_bytes(d["n"], d["n_alive"], d["mask_bytes"],
                                d["tmax_per_ray"], d["nee"], d["any_hit"],
                                d["table_bytes"]) for d in t["dispatches"])
    return 100.0 * (nbytes / peaks["hbm_bytes_per_s"]) / (ns / 1e9)
