"""pipeline.trace_frame_idle_ms_per_spp: the device's idle ms in the traced
chunk whose gap began inside the program's span ``pipeline.trace_frame``,
over its samples (layer: pipeline; moves ``spp_per_s``).

The gaps are ``trace.idle_gaps``' (between the union of the device's events,
inside the chunk's window). A gap counts where the innermost program span
open as it began lies inside ``pipeline.trace_frame``: the program's spans
nest, so that is where a ``pipeline.trace_frame`` span is open then, and
those spans alone are handed to ``idle_gaps``."""

from benchmark.harness.trace import idle_gaps
from benchmark.metrics.program_spans import program_record


def read(rec):
    r = program_record(rec)
    if r is None:
        return None
    t = rec["traced"]
    frames = [("trace_frame", s["t0_ns"], s["t1_ns"]) for s in r["spans"]
              if s["name"] == "pipeline.trace_frame"]
    if not frames or not t["events"]:
        return None
    gaps = idle_gaps(t["events"], frames, t["window_ns"])
    return gaps.get("trace_frame", 0.0) * 1e3 / t["spp"]
