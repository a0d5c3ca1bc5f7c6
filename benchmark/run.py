"""Run one cell of the benchmark of ``voxelrt_torch`` on this machine's CUDA
card and print its result as the last line of standard output.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout. The cell, its configuration, its traffic,
its comparison and its metrics are found by name (``BENCHMARK.json``,
``benchmark/configs``, ``traffic``, ``checks``, ``metrics``); the traffic's
``kind`` names its runner in ``benchmark/harness``. With ``--trace 0`` the
result holds the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics and ``busy_s``, ``window_s`` and a ``breakdown``. Every
run checks what the timed path produced against the plain reference and
prints the numbers compared beside their limits, last on standard error
and last in the result.

The run exits with another code than 0, and prints no result, where there
is no CUDA card or fewer than the cell asks for, where the profiler loses
B1's kernel events in every session of a traced run, and where the process
holds JAX, jaxlib, flax or the JAX package ``voxelrt`` once the window has
closed. Every build and cache stays inside the checkout: the kernels in
``voxelrt_torch/_build/``, a computed sky in ``.skycache/``.
"""

import time

T_START = time.perf_counter()  # set-up counts from here, imports included

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "voxelrt")


def forbidden_modules():
    """The loaded modules whose top-level name (before the first dot) is
    one of FORBIDDEN, compared whole: ``voxelrt_torch`` is not
    ``voxelrt``."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def card_line():
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "--id=0"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or None
    except (OSError, subprocess.TimeoutExpired):
        return None


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    sys.path.insert(0, ROOT)
    from benchmark.harness import runner, spec

    cell = spec.cell(args.workload)
    import torch

    need = int(cell["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"this cell needs {need} CUDA card(s); {have} found",
              file=sys.stderr)
        return 2
    result, lines = runner.run(cell, args.seed, args.seconds,
                               bool(args.trace), "cuda", T_START,
                               card_line)
    found = forbidden_modules()
    if found:
        print("the run loaded JAX or the JAX package: " + ", ".join(found),
              file=sys.stderr)
        return 3
    print(json.dumps(result))
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
