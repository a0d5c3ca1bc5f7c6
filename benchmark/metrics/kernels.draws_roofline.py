"""kernels.draws_roofline: kernel D's least time over its profiled time in
the traced chunk, in %. The least time is the bytes of its launches
(``draws_bytes.launch_bytes`` of each ``draws.lanes`` count the program
recorded) over the card's published memory bandwidth (``peaks.json``); the
profiled time is the device time of ``voxelrt_torch/csrc/draws.cu``'s
kernels (layer: kernels; moves ``spp_per_s``).

Where the profiler saw fewer of the kernel's launches than the program
counted (it drops a session's events now and then), the bytes are those of
the launches it saw, at the counted launches' mean. A program without
kernel D, without the recorder or without the counter gives None."""

from benchmark.harness.trace import matches
from benchmark.metrics.draws_bytes import launch_bytes
from benchmark.metrics.program_spans import program_record

SOURCE = "draws"


def read(rec):
    t, peaks = rec.get("traced"), rec.get("peaks")
    names = t and t["kernels"].get(SOURCE)
    if not names or not peaks:
        return None
    r = program_record(rec)
    if r is None:
        return None
    launches = [c for c in r["counts"] if c["name"] == "draws.lanes"
                and c["value"] and c["attrs"].get("slots")]
    times = [e - s for name, s, e in t["events"] if matches(name, names)]
    if not launches or not times:
        return None
    nbytes = sum(launch_bytes(c["value"], c["attrs"]["slots"],
                              c["attrs"]["lane_keys"])
                 for c in launches) * len(times) / len(launches)
    return 100.0 * (nbytes / peaks["hbm_bytes_per_s"]) / (sum(times) / 1e9)
