"""example6's camera path on the port, frame by frame: ``chip_smoke.py``
phase 9's path (24 frames of orbit (0.01, 0.002) + 'w' at dt 0.02, then 6
still frames, one sample a frame, the default config and seed) through
``Scene.run_frames``, its frames kept as PNGs; and a frame-by-frame
comparison of two such sets, for instance the card's against the JAX
package's (``python tests/test_torch_golden.py --regen path --frames
1,2,24 --out DIR`` writes those) or against the port's CPU path.

    python3 tools/path_frames_torch.py render OUT [--device cpu]
                                       [--frames 1,2,4,8,12,16,20,24,25,30]
    python3 tools/path_frames_torch.py compare DIR_A DIR_B

``render`` writes ``OUT/fNN.png`` for each frame counted from 1 (on the
CUDA card unless ``--device`` names another). ``compare`` prints one JSON
line a frame present in both directories: the RMSE, the share of pixels
whose channels are all equal, whose largest difference is one 8-bit level
and whose largest is more than two, the clusters (8-connected) of those
beyond two levels and the largest, and the channel values one level above
and one level below (A against B).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import HOLD, MOVE, N_MOVING, N_STILL  # noqa: E402

FRAMES = [MOVE] * N_MOVING + [HOLD] * N_STILL
KEEP = (1, 2, 4, 8, 12, 16, 20, 24, 25, 30)


def render(out, device, keep):
    from voxelrt_torch.app.examples import build_example
    from voxelrt_torch.utils.image import write_png

    os.makedirs(out, exist_ok=True)

    def on_frame(i, img):
        if i + 1 in keep:
            write_png(os.path.join(out, f"f{i + 1:02d}.png"), img)

    build_example("example6", device).run_frames(
        [dict(f) for f in FRAMES], on_frame=on_frame)


def compare(dir_a, dir_b):
    from scipy import ndimage

    from voxelrt_torch.utils.image import read_png

    for name in sorted(set(os.listdir(dir_a)) & set(os.listdir(dir_b))):
        a = np.rint(read_png(os.path.join(dir_a, name)) * 255).astype(int)
        b = np.rint(read_png(os.path.join(dir_b, name)) * 255).astype(int)
        d = a - b
        levels = np.abs(d).max(-1)
        far = levels > 2
        labels, n = ndimage.label(far, structure=np.ones((3, 3)))
        sizes = np.bincount(labels.ravel())[1:]
        print(json.dumps(dict(
            frame=name, rmse=float(np.sqrt(np.mean((d / 255) ** 2))),
            equal=float((levels == 0).mean()),
            one_level=float((levels == 1).mean()),
            beyond_2_levels=int(far.sum()), clusters=int(n),
            largest_cluster=int(sizes.max()) if n else 0,
            channels_one_above=int((d == 1).sum()),
            channels_one_below=int((d == -1).sum()))), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("render")
    r.add_argument("out")
    r.add_argument("--device", default=None)
    r.add_argument("--frames", default=",".join(map(str, KEEP)))
    c = sub.add_parser("compare")
    c.add_argument("dir_a")
    c.add_argument("dir_b")
    args = ap.parse_args()
    if args.cmd == "render":
        render(args.out, args.device,
               {int(n) for n in args.frames.split(",")})
    else:
        compare(args.dir_a, args.dir_b)


if __name__ == "__main__":
    main()
