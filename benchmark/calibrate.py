"""The readings that the comparison's limits are set from, on the card: for
each seed the program renders the cell's window as a run does, then the
plain reference traces its stills again, and the numbers that
``harness/check.py`` compares are read for the program (the lower readings)
and for the control, the reference computed in bfloat16 put in the
program's place (the upper readings).

    python3 benchmark/calibrate.py --workload NAME --seconds S --seeds N ...
        [--fmad] [--cpu] [--dump DIR]

``--fmad`` builds the program's kernels with multiply-add contraction
(nvcc's default) in place of the port's ``-fmad=false``: a sound change of
rounding, as a faster kernel or a fused one would make, so that the lower
reading is that of a program that does not match the reference bit for bit.
``--cpu`` also traces the stills with the reference on the host's CPU, whose
float32 division, square roots and powers round otherwise than the card's,
and reads that against the card's reference: a second sound change of
rounding, one that reaches every shading step. ``--dump DIR`` writes each
seed's pixels, chunks and colours (the program's, the reference's, the
control's and with ``--cpu`` the CPU's) to
``DIR/<workload>-<variant>-<seed>.npz``.

One JSON line a seed goes to standard output. Run from the root of a
checkout.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def contract_fmad():
    """Build the program's kernels with multiply-add contraction."""
    from voxelrt_torch.ops import _cuda

    _cuda.NVCC_FLAGS[:] = ["-fmad=true" if f == "-fmad=false" else f
                           for f in _cuda.NVCC_FLAGS]


def dump(path, captured, colours):
    """``colours``: {tag: [(hdr, ldr) a still]}."""
    import numpy as np

    arrays = dict(pixels=np.asarray(captured["pixels"]))
    for i, (chunks, _, _) in enumerate(captured["stills"]):
        arrays[f"chunks{i}"] = np.asarray(chunks, dtype=np.int64)
        for tag, stills in colours.items():
            arrays[f"{tag}_hdr{i}"] = stills[i][0].numpy()
            arrays[f"{tag}_ldr{i}"] = stills[i][1].numpy()
    np.savez_compressed(path, **arrays)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fmad", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--dump")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark.harness import check, runner, spec

    if not torch.cuda.is_available():
        print("calibrate runs on a CUDA card", file=sys.stderr)
        return 2
    if args.fmad:
        contract_fmad()
    variant = "fmad" if args.fmad else "program"
    cell = spec.cell(args.workload)
    kind = runner.kind_module(cell["traffic"]["kind"])
    dev = torch.device("cuda")
    if args.dump:
        os.makedirs(args.dump, exist_ok=True)
    for seed in args.seeds:
        run = kind.Run(cell, seed, dev)
        run.setup()
        w = run.window(args.seconds)
        captured = run.close()
        del run
        stills = [c for c, _, _ in captured["stills"]]
        prog = [(h, l) for _, h, l in captured["stills"]]
        t = time.perf_counter()
        refs = check.reference_stills(cell, seed, stills,
                                      captured["pixels"], dev)
        ref_s = time.perf_counter() - t
        colours = dict(prog=prog, ref=refs, ctrl=check.reference_stills(
            cell, seed, stills, captured["pixels"], dev,
            dtype=torch.bfloat16))
        if args.cpu:
            colours["cpu"] = check.reference_stills(
                cell, seed, stills, captured["pixels"], "cpu")
        reads = {}
        for tag in ("prog", "ctrl", "cpu"):
            if tag in colours:
                reads[tag], _, reads[tag + "_failed"] = check.compare(
                    colours[tag], refs, cell["check"])
        if args.dump:
            dump(os.path.join(args.dump,
                              f"{args.workload}-{variant}-{seed}.npz"),
                 captured, colours)
        k = cell["traffic"]["samples_per_launch"]
        print(json.dumps(dict(
            workload=args.workload, variant=variant, seed=seed, **reads,
            stills=len(stills), spp=[sum(n for _, n in c) * k for c in stills],
            pixels=len(captured["pixels"]), window_spp=w["spp"],
            reference_s=ref_s)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
