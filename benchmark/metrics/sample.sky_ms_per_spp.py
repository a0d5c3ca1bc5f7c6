"""sample.sky_ms_per_spp: stream ms of the span ``sample.sky`` (the deferred
escape sky, B2 or B3 with its glue), self time summed over the traced chunk,
over its samples (layer: wavefront sample; moves ``spp_per_s``)."""

from benchmark.metrics.program_spans import stream_ms_per_spp


def read(rec):
    return stream_ms_per_spp(rec, "sample.sky")
