"""Measure, on the CUDA card, what one loop iteration of each construct of
the traversal kernel's loop costs: the port's counterpart of
``tools/pallas_probe.py``, launching kernel P (voxelrt_torch/ops/probe.py,
csrc/probe.cu).

    python tools/cuda_probe.py [--variants base fetch ...] [--blocks 512]
                               [--iters 512 4096] [--trials 5]
                               [--x-scale 1] [--json]

Each variant runs its loop per (8, 128) block over ``--blocks`` blocks; the
cost is the slope between the two iteration counts, timed with CUDA events
(best of ``--trials``). Two figures per variant: ns per iteration per block
over the whole grid (the figure ``pallas_probe.py`` prints; on the card the
blocks run side by side, so this is a throughput), and ns per iteration of
one block's loop, measured with one block per multiprocessor (the loop's
latency, what a redesign of the traversal loop starts from). Fails without a
CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    from voxelrt_torch.ops.probe import VARIANTS

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=VARIANTS)
    ap.add_argument("--blocks", type=int, default=512)
    ap.add_argument("--iters", type=int, nargs=2, default=[512, 4096],
                    metavar=("LO", "HI"))
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--x-scale", type=float, default=1.0,
                    help="x is drawn from [0, X_SCALE): 1 (the TPU probe's "
                         "inputs) gives every lane table index 0, 1024 and "
                         "more a random index per lane")
    ap.add_argument("--json", action="store_true",
                    help="print one JSON object instead of the table")
    args = ap.parse_args(argv)
    if not 0 < args.iters[0] < args.iters[1]:
        ap.error("--iters needs 0 < LO < HI")
    if args.blocks < 1 or args.trials < 1:
        ap.error("--blocks and --trials must be positive")
    return args


def probe_inputs(n_blocks, seed, device, x_scale=1.0):
    """The probe's inputs from a seed: x in [0, x_scale), table words in
    [0, 100)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.random((n_blocks, 8, 128), dtype=np.float32)
                         * np.float32(x_scale))
    tab = torch.from_numpy(rng.integers(0, 100, (256, 128)).astype(np.int32))
    return x.to(device), tab.to(device)


def _best_ms(x, tab, variant, iters, trials):
    import torch

    from voxelrt_torch.ops.probe import probe

    probe(x, tab, variant, iters)  # builds and loads the kernel, warms up
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        probe(x, tab, variant, iters)
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def run_probe(variants, n_blocks=512, iters=(512, 4096), trials=5,
              x_scale=1.0):
    """Time every variant; returns {variant: figures}."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("cuda_probe needs a CUDA card")
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    lo, hi = iters
    out = {}
    for grid, tag in ((n_blocks, "grid"), (n_sm, "one_per_sm")):
        x, tab = probe_inputs(grid, 0, dev, x_scale)
        for v in variants:
            t_lo = _best_ms(x, tab, v, lo, trials)
            t_hi = _best_ms(x, tab, v, hi, trials)
            slope_ns = (t_hi - t_lo) / (hi - lo) * 1e6
            fig = out.setdefault(v, {})
            if tag == "grid":
                fig.update(ms_lo=t_lo, ms_hi=t_hi, blocks=grid,
                           ns_per_iter_per_block=slope_ns / grid)
            else:
                fig.update(loop_ns_per_iter=slope_ns, loop_blocks=grid)
    return out


def main(argv=None):
    args = parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("cuda_probe needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    res = run_probe(args.variants, args.blocks, tuple(args.iters),
                    args.trials, args.x_scale)
    if args.json:
        print(json.dumps(dict(device=smi, iters=args.iters, variants=res)))
        return 0
    print(f"{smi} | {args.blocks} blocks of 1024 lanes, slope between "
          f"{args.iters[0]} and {args.iters[1]} iterations")
    base = res.get("base")
    for v, f in res.items():
        note = ""
        if base is not None and v != "base":
            note = (f"  (+{f['loop_ns_per_iter'] - base['loop_ns_per_iter']:7.1f}"
                    " ns over base)")
        print(f"{v:8s} {f['ns_per_iter_per_block']:8.3f} ns/iter/block   "
              f"loop {f['loop_ns_per_iter']:8.1f} ns/iter{note}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
