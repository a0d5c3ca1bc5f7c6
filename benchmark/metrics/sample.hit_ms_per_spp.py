"""sample.hit_ms_per_spp: stream ms of the spans ``sample.hit`` (``next_hit``:
the floor plane, the NEE parameters and the surface fetch with the
colour-word decode) less their ``kernels.b1`` child, summed over every depth
of the traced chunk, over its samples (layer: wavefront sample; moves
``spp_per_s``)."""

from benchmark.metrics.program_spans import stream_ms_per_spp


def read(rec):
    return stream_ms_per_spp(rec, "sample.hit")
