"""pipeline.resolve_ms_per_spp: stream ms of the span
``pipeline.resolve_frame`` with its children (the temporal prepass and
filters), summed over the traced chunk, over its samples (layer: pipeline;
moves ``spp_per_s``)."""

from benchmark.metrics.program_spans import stream_ms_per_spp


def read(rec):
    return stream_ms_per_spp(rec, "pipeline.resolve_frame", whole=True)
