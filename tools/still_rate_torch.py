"""Launch-by-launch wall time of the still render, from a fresh process, on
one CUDA card:

    python tools/still_rate_torch.py

Builds the kernels, sets up example6 at 1280x720 with 16 samples per launch
(as ``chip_smoke.py`` phases 3-4 do) and renders 64 samples twice, one
launch per ``render`` chunk: the first 64 are the cold ones ``chip_smoke.py``
reports as phase 4's ``per_spp_ms``, the next 64 the steady ones. Prints
each launch's wall milliseconds, the CUDA caching allocator's segment and
retry counts after each pass, and one JSON line; the card's name and power
limit come last. It imports the ``voxelrt_torch`` beside it, so a copy of
this file in another checkout (the parent commit's, unpacked with
``git archive``) measures that checkout.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SPP, SPL = 64, 16


def main():
    import torch

    from voxelrt_torch.app.examples import build_example
    from voxelrt_torch.ops import _cuda
    from voxelrt_torch.utils.profiling import FrameStats

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    _cuda.build_all()
    t0 = time.perf_counter()
    r = build_example("example6", None, samples_per_launch=SPL).renderer
    r.prepare_data()
    torch.cuda.synchronize()
    out = dict(root=ROOT, device=smi, setup_s=time.perf_counter() - t0)
    for tag in ("cold", "steady"):
        with open(os.devnull, "w") as null:
            stats = FrameStats(out=null)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r.render(spp=SPP, chunk=SPL, stats=stats)
            torch.cuda.synchronize()
        m = torch.cuda.memory_stats()
        out[tag] = dict(
            per_spp_ms=(time.perf_counter() - t0) / SPP * 1e3,
            launch_ms=[row["wall_ms"] for row in stats.rows],
            segments=m.get("segment.all.allocated", 0),
            alloc_retries=m.get("num_alloc_retries", 0),
            peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        print(f"{tag}: {json.dumps(out[tag])}", flush=True)
    print(json.dumps(out))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
