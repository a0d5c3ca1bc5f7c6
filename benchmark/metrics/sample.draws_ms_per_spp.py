"""sample.draws_ms_per_spp: stream ms of the spans ``sample.draws`` (the PCG3D
draws of each depth, hashed as their slots are read), self time summed over
every depth of the traced chunk, over its samples (layer: wavefront sample;
moves ``spp_per_s``)."""

from benchmark.metrics.program_spans import stream_ms_per_spp


def read(rec):
    return stream_ms_per_spp(rec, "sample.draws")
