"""ReSTIR-PT low-spp quality on the PyTorch port (the port's counterpart of
tools/restir_quality.py; same arguments and JSON rows). Renders a scene
converged with ReSTIR off (``--ref-spp`` samples, another seed), then
renders it at each of ``--spp`` with ReSTIR off and on, and compares each
against the reference by the RMSE of the tonemapped images. ReSTIR off and
on each render once untimed first (the port builds its kernels on first
use and compiles nothing per sample count); the equal-time
gain is the plain render's RMSE scaled to the ReSTIR render's wall time
(RMSE ~ 1/sqrt(time)) over the ReSTIR render's RMSE.

    python tools/restir_quality_torch.py --scene example6 --res 1280x720
    python tools/restir_quality_torch.py --scene example2 --res 64x36 \\
        --ref-spp 16 --spp 1 2 --device cpu

``--device`` defaults to the CUDA card and fails without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="example1")
    ap.add_argument("--res", default="1280x720")
    ap.add_argument("--ref-spp", type=int, default=256)
    ap.add_argument("--spp", type=int, nargs="*", default=[1, 2, 4])
    ap.add_argument("--device", default=None,
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args(argv)
    args.res = tuple(int(x) for x in args.res.lower().split("x"))
    return args


def render(name, res, device, restir, spp, seed=0, **over):
    """A fresh scene's ``Scene.finish(spp)`` with ReSTIR on or off; returns
    (image, wall seconds of the render). Candidates trace one sample a
    launch on both paths (ReSTIR needs it); a converged render, eight."""
    from voxelrt_torch.app.examples import build_example
    from voxelrt_torch.utils.profiling import sync

    scene = build_example(name, device, res, use_restir_pt=restir,
                          samples_per_launch=8 if spp >= 8 else 1, **over)
    scene.seed = seed
    r = scene.renderer
    r.prepare_data()
    sync(r.device)
    t0 = time.perf_counter()
    img = np.asarray(scene.finish(spp=spp, save=False))
    sync(r.device)
    return img, time.perf_counter() - t0


def quality_rows(name, res, ref_spp, spps, device=None, **over):
    """The measurement: one JSON-ready dict a candidate spp."""
    # The reference uses an independent seed: with a shared one the
    # candidates would share the reference's first sample streams.
    ref, _ = render(name, res, device, False, ref_spp, seed=9876, **over)
    rows = []
    for restir in (False, True):
        render(name, res, device, restir, min(spps), **over)
    for spp in spps:
        off, t_off = render(name, res, device, False, spp, **over)
        on, t_on = render(name, res, device, True, spp, **over)
        r_off = float(np.sqrt(np.mean((off - ref) ** 2)))
        r_on = float(np.sqrt(np.mean((on - ref) ** 2)))
        eq = r_off * np.sqrt(t_off / max(t_on, 1e-9)) / max(r_on, 1e-9)
        rows.append(dict(spp=spp, rmse_plain=r_off, rmse_restir=r_on,
                         gain=r_off / max(r_on, 1e-9), wall_plain_s=t_off,
                         wall_restir_s=t_on, equal_time_gain=float(eq)))
    return rows


def main(argv=None):
    args = parse_args(argv)
    rows = quality_rows(args.scene, args.res, args.ref_spp, args.spp,
                        args.device)
    for row in rows:
        print(json.dumps(row), flush=True)
    print(json.dumps(dict(scene=args.scene, res=f"{args.res[0]}x{args.res[1]}",
                          ref_spp=args.ref_spp, rows=rows)))


if __name__ == "__main__":
    main()
