"""pipeline.embed_ms_per_spp: stream ms of the span ``pipeline.embed`` (the
sample mean, the untiling and the embedding into the image buffers), self
time summed over the traced chunk, over its samples (layer: pipeline; moves
``spp_per_s``)."""

from benchmark.metrics.program_spans import stream_ms_per_spp


def read(rec):
    return stream_ms_per_spp(rec, "pipeline.embed")
