"""kernels.b1_ms_per_spp: device ms of B1's kernels (those of
``voxelrt_torch/csrc/dda.cu``) in the traced chunk over its samples
(layer: kernels; moves ``spp_per_s``)."""

from benchmark.harness.trace import matches


def read(rec):
    t = rec.get("traced")
    names = t and t["kernels"].get(t["b1_source"])
    if not names:
        return None
    ns = sum(e - s for name, s, e in t["events"] if matches(name, names))
    return ns / 1e6 / t["spp"] if ns else None
