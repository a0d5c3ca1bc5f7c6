"""kernels.hit_roofline: kernel H's least time over its profiled time in the
traced chunk, in %. The least time is the bytes of its launches
(``hit_bytes.launch_bytes`` of each ``hit.lanes`` count the program
recorded, with the ``b1.alive`` count of the closest-hit dispatch inside the
same span) over the card's published memory bandwidth (``peaks.json``); the
profiled time is the device time of ``voxelrt_torch/csrc/hit.cu``'s kernels
(layer: kernels; moves ``spp_per_s``).

Where the profiler saw fewer of the kernel's launches than the program
counted (it drops a session's events now and then), the bytes are those of
the launches it saw, at the counted launches' mean. A launch whose
dispatch's alive count is not found is counted with no lane tracing. A
program without kernel H, without the recorder or without the counter gives
None."""

from benchmark.harness.trace import matches
from benchmark.metrics.hit_bytes import launch_bytes
from benchmark.metrics.program_spans import program_record

SOURCE = "hit"


def read(rec):
    t, peaks = rec.get("traced"), rec.get("peaks")
    names = t and t["kernels"].get(SOURCE)
    if not names or not peaks:
        return None
    r = program_record(rec)
    if r is None:
        return None
    launches = [c for c in r["counts"] if c["name"] == "hit.lanes"
                and c["value"] and c["attrs"].get("stage")]
    times = [e - s for name, s, e in t["events"] if matches(name, names)]
    if not launches or not times:
        return None
    # the alive lanes of each closest-hit dispatch, by the span that holds
    # the dispatch (the parent of its ``kernels.b1`` span)
    parent = {s["id"]: s["parent"] for s in r["spans"]}
    alive = {parent.get(c["span"]): c["value"] for c in r["counts"]
             if c["name"] == "b1.alive" and c["span"] is not None
             and not c["attrs"].get("any_hit")}
    alive.pop(None, None)
    nbytes = sum(launch_bytes(c["value"], alive.get(c["span"], 0),
                              c["attrs"]["stage"], c["attrs"].get("nee"))
                 for c in launches) * len(times) / len(launches)
    return 100.0 * (nbytes / peaks["hbm_bytes_per_s"]) / (sum(times) / 1e9)
