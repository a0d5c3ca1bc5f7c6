"""Render one of ``examples/*.py`` on the PyTorch port (the examples
themselves run on the JAX package and are not edited):

    python tools/run_example_torch.py example7 --spp 64 --res 1280x720
    python tools/run_example_torch.py example7 --device cpu --res 128x72 --spp 4

``--device`` defaults to the CUDA card and fails without one; ``cpu`` runs
the kernels' plain PyTorch versions. A scene with a physical sky computes it
on that device at the first run and caches it under ``.skycache/``. Prints
one JSON line with the seconds of set-up and render and the kernel launch
counts, and writes the PNG to ``--out`` (default ``screenshot/<name>.png``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    from voxelrt_torch.app.examples import NAMES

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("name", choices=NAMES)
    ap.add_argument("--spp", type=int, default=64)
    ap.add_argument("--res", type=str, default="1280x720", help="WxH")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--device", type=str, default=None,
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args(argv)
    w, h = args.res.lower().split("x")
    args.res = (int(w), int(h))
    return args


def run_example(name, device=None, res=(1280, 720), spp=64, out=None,
                save=True, quiet=True, sky_cache_dir=".skycache",
                **config_over):
    """Build ``name`` on the port and render ``spp`` samples through
    ``Scene.finish``. Returns (image, figures): seconds of set-up (scene
    build, tables, sky) and render, and the kernel launches of the run."""
    from voxelrt_torch.app.examples import build_example
    from voxelrt_torch.ops import _cuda
    from voxelrt_torch.utils.profiling import sync

    t0 = time.perf_counter()
    scene = build_example(name, device, res, quiet=quiet,
                          sky_cache_dir=sky_cache_dir, **config_over)
    r = scene.renderer
    before = dict(_cuda.LAUNCHES)
    r.prepare_data()
    sync(r.device)
    t1 = time.perf_counter()
    img = r.render(spp=spp)
    sync(r.device)
    t2 = time.perf_counter()
    if save:
        from voxelrt_torch.utils.image import write_png

        out = out or os.path.join("screenshot", f"{name}.png")
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        write_png(out, img)
    launches = {k: v - before[k] for k, v in _cuda.LAUNCHES.items()}
    return img, dict(name=name, device=str(r.device), res=list(res), spp=spp,
                     setup_s=t1 - t0, render_s=t2 - t1, launches=launches,
                     out=out if save else None)


def main(argv=None):
    args = parse_args(argv)
    img, fig = run_example(args.name, args.device, args.res, args.spp,
                           args.out, quiet=False)
    fig["mean"] = float(img.mean())
    print(json.dumps(fig))


if __name__ == "__main__":
    main()
