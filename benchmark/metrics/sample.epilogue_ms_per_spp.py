"""sample.epilogue_ms_per_spp: stream ms of the span ``sample.epilogue`` (the
G-buffer epilogue, the primary-vertex MIS and the diffuse and specular
split), self time summed over the traced chunk, over its samples (layer:
wavefront sample; moves ``spp_per_s``)."""

from benchmark.metrics.program_spans import stream_ms_per_spp


def read(rec):
    return stream_ms_per_spp(rec, "sample.epilogue")
