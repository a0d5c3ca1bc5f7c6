"""sample.alive_lane_pct: 100 x the rays alive in B1's closest-hit
dispatches of the bounce loop (the program's counter ``b1.alive``, B1's own
count kept on the card) over the lanes its glue computes on
(``sample.lanes``), summed over every depth of the traced chunk. The alive
mask is the loop's ``tracing`` mask, so this is the share of the glue's
lanes that still carry a path; a change that compacts the wavefront raises
it (layer: wavefront sample; moves ``spp_per_s``).

Counters without a ``depth`` (outside the bounce loop) and those of shadow
dispatches (``any_hit``) are left out."""

from benchmark.metrics.program_spans import program_record


def read(rec):
    r = program_record(rec)
    if r is None:
        return None
    rows = [c for c in r["counts"] if "depth" in c["attrs"]]
    alive = sum(c["value"] for c in rows if c["name"] == "b1.alive"
                and not c["attrs"].get("any_hit"))
    lanes = sum(c["value"] for c in rows if c["name"] == "sample.lanes")
    return 100.0 * alive / lanes if lanes else None
