"""pipeline.host_ms_per_launch: the host's own ms a launch in the traced
chunk: the chunk's enqueue (from before its first call to the return of
``accumulate_n``) less the time the host waited on the card inside CUDA
calls, over the chunk's launches (layer: pipeline; moves ``spp_per_s``).

A launch enqueues some 6,400 kernels. Once CUDA's launch queue is full
(about 1,020 kernels deep on the H100), each ``cudaLaunchKernel`` blocks
until a kernel ends, so the enqueue's wall follows the card's pace. The wait
is read from the profiler's record of the host's runtime calls: each launch
call's time beyond the median of the chunk's first ``FREE_CALLS`` launch
calls (made just after a synchronise, into an empty queue), and the whole of
each synchronising call. What is left is the host's own work: Python,
PyTorch's dispatch and each launch call's own cost. While it stays under
the card's ms a launch, the host does not set the pace."""

import statistics

FREE_CALLS = 64


def read(rec):
    t = rec.get("traced")
    if not t or not t.get("runtime"):
        return None
    e0, e1 = t["enqueue_ns"]
    calls = sorted((c for c in t["runtime"] if e0 <= c[1] < e1),
                   key=lambda c: c[1])
    launch = [e - s for name, s, e in calls if "Launch" in name]
    if len(launch) < FREE_CALLS:
        return None
    free = statistics.median(launch[:FREE_CALLS])
    wait = sum(max(0, d - free) for d in launch)
    wait += sum(e - s for name, s, e in calls if "Synchronize" in name)
    return (e1 - e0 - wait) / 1e6 / t["launches"]
