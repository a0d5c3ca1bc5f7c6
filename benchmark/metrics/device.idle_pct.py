"""device.idle_pct: 100 x (1 - the union of the device's event intervals
over the traced chunk's wall time), the wall time on the host clock from
before its first launch to its closing synchronise (layer: device; moves
``spp_per_s``)."""

from benchmark.harness.trace import busy_ns


def read(rec):
    t = rec.get("traced")
    if not t or not t["events"]:
        return None
    t0, t1 = t["window_ns"]
    return 100.0 * (1.0 - busy_ns(t) / (t1 - t0))
