"""Interactive-equivalent benchmark of the PyTorch port: animated camera
path (the port-side twin of tools/camera_path_bench.py; same arguments, same
one-line JSON).

Runs a scripted orbit+dolly path through an example scene with the
reference's motion policy active (render_scale 0.5, 50-frame accumulation
cap while moving — scene.py:209-228) and reports ms/frame. It imports
``voxelrt_torch`` only: the example module is imported with its
``_common.make_scene`` replaced by the port's ``Scene``. ``--restir`` runs
the path with ReSTIR-PT's spatial GRIS pass.

    python tools/camera_path_bench_torch.py [--scene example1] [--frames 24]
                                            [--res 640x360] [--device cpu]
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import importlib
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "examples"))


def load_scene(name, device):
    """The example module's Scene, built on the port."""
    import _common

    from voxelrt_torch.scene import Scene

    _common.make_scene = lambda argv=None, **kw: Scene(
        quiet=True, device=device, **kw)
    mod = importlib.import_module(name)
    if hasattr(mod, "initialize_voxels"):
        mod.initialize_voxels()
    else:
        mod.initialize()
        if hasattr(mod, "draw"):
            mod.draw()
    return mod.scene


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="example1")
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--res", default="640x360")
    ap.add_argument("--restir", action="store_true")
    ap.add_argument("--out", default=None, help="write the final frame PNG")
    ap.add_argument("--cfg", nargs="*", default=[],
                    help="config overrides, e.g. motion_filter=catmullrom")
    ap.add_argument("--pipelined", action="store_true",
                    help="throughput mode: enqueue frames asynchronously and "
                         "sync once per phase (a real viewer fetches frames "
                         "out of band)")
    ap.add_argument("--sync-lag", type=int, default=0,
                    help="double-buffered latency mode: sync frame i-N "
                         "after dispatching frame i (display one frame "
                         "behind); wall_ms becomes time between frame "
                         "completions")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs "
                         "the kernels' plain twins)")
    args = ap.parse_args()
    w, h = (int(x) for x in args.res.split("x"))

    from voxelrt_torch.utils.profiling import FrameStats, sync

    sys.argv = ["bench"]
    scene = load_scene(args.scene, args.device)
    over = {}
    for kv in args.cfg:
        k_, v_ = kv.split("=", 1)
        try:
            over[k_] = ast.literal_eval(v_)
        except ValueError:
            over[k_] = v_
    scene.config = dataclasses.replace(
        scene.config, image_res=(w, h), use_restir_pt=args.restir, **over)
    dev = scene.device

    if args.pipelined:
        # Throughput mode: frames queue on the device without a per-frame
        # wait; one sync per phase. The phase-transition framebuffer reset
        # between the split run_frames calls is elided, as in the JAX tool.
        mv = {"orbit": (0.01, 0.002), "move_keys": ["w"], "dt": 0.02}
        st = {"dt": 0.02}
        scene.run_frames([mv] * 3 + [st] * 3, spp_per_frame=1,
                         fetch_final=False)  # warm both phases
        sync(dev)
        t0 = time.perf_counter()
        scene.run_frames([dict(mv)] * args.frames, spp_per_frame=1,
                         fetch_final=False)
        sync(dev)
        t1 = time.perf_counter()
        n_still = max(4, args.frames // 4)
        scene.run_frames([dict(st)] * n_still, spp_per_frame=1,
                         fetch_final=False)
        sync(dev)
        t2 = time.perf_counter()
        print(json.dumps({
            "metric": "camera_path_throughput_ms_per_frame",
            "value": round((t1 - t0) / args.frames * 1e3, 2),
            "unit": "ms",
            "still_ms_per_frame": round((t2 - t1) / n_still * 1e3, 2),
            "restir": args.restir,
            "res": args.res,
            "frames": args.frames + n_still,
        }))
        return

    # Orbit + dolly path, then hold still to accumulate.
    frames = [{"orbit": (0.01, 0.002), "move_keys": ["w"], "dt": 0.02}
              for _ in range(args.frames)]
    frames += [{"dt": 0.02}] * max(4, args.frames // 4)

    with open(os.devnull, "w") as null:
        stats = FrameStats(out=null)
        img = scene.run_frames(frames, spp_per_frame=1, stats=stats,
                               sync_lag=args.sync_lag)
    times = [row["wall_ms"] / 1e3 for row in stats.rows]
    if args.out:
        from voxelrt_torch.utils.image import write_png

        write_png(args.out, img)

    # Skip the first frames of each phase (warm-up).
    moving = sorted(times[2:args.frames])
    still = sorted(times[args.frames + 2:])

    def med(xs):
        return xs[len(xs) // 2] * 1e3 if xs else float("nan")

    print(json.dumps({
        "metric": "camera_path_ms_per_frame",
        "value": round(med(moving), 2),
        "unit": "ms",
        "still_ms_per_frame": round(med(still), 2),
        "restir": args.restir,
        "res": args.res,
        "frames": len(times),
        "sync_lag": args.sync_lag,
        "final_mean": float(np.asarray(img).mean()),
    }))


if __name__ == "__main__":
    main()
