"""sample.glue_ms_per_spp: device ms of every event of the traced chunk
that is not one of the program's own CUDA kernels (those named in
``voxelrt_torch/csrc/*.cu``) over its samples: PyTorch's elementwise,
indexing and reduction kernels, and its copies and sets (layer: wavefront
sample; moves ``spp_per_s``)."""

from benchmark.harness.trace import matches


def read(rec):
    t = rec.get("traced")
    if not t or not t["events"]:
        return None
    port = set().union(*t["kernels"].values())
    ns = sum(e - s for name, s, e in t["events"] if not matches(name, port))
    return ns / 1e6 / t["spp"]
