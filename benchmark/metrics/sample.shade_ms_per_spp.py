"""sample.shade_ms_per_spp: stream ms of the spans ``sample.shade`` (the miss,
emissive and surface-shading blocks, NEE, the BSDF and MIS), self time
summed over every depth of the traced chunk, over its samples (layer:
wavefront sample; moves ``spp_per_s``)."""

from benchmark.metrics.program_spans import stream_ms_per_spp


def read(rec):
    return stream_ms_per_spp(rec, "sample.shade")
