"""Time the shade kernel (``ops/shade_kernel.py``, csrc/shade.cu) on the
card at each depth of a real launch, against its eager twin
(``render/pathtracer.py`` ``shade_depth_eager``), and hold it to the twin
by bits at full size.

    python3 tools/shade_kernel_torch.py [--scene NAME] [--res WxH]
                                        [--reps R] [--out PATH]

One 16-sample launch of the scene runs on the eager route and the state is
taken as it enters each depth's shading (one launch a depth, so that one
depth's state is held at a time). For each depth it prints and, with
``--out``, writes as JSON:

* ``device_ms``: the kernel's card time a call (CUDA events around the
  launch alone, queued behind a spin, the state restored from a copy
  before each call: the kernel updates it in place);
* ``ms_with_wrapper``: events around ``shade_kernel.shade_depth`` as the
  host issues it on an idle card, its Python wrapper included;
* ``plain_ms``: the card time of the eager twin ``shade_depth_eager`` on
  the same state (``torch_measure.device_ms``);
* ``bound_ms``: the bytes the depth needs over 3.35 TB/s: a lane's
  ``tracing`` for every lane; the hit, the path state and ``pos``/``d`` for
  the lanes tracing as the depth begins, and their records; the escape's
  draws and record for the lanes that escape, the emissive add for those
  that hit a light; the NEE draws and verdict, the bounce draws and the
  new path state for the lanes that go on (surface), the NEE sums for
  those whose B1 verdict is visible (an upper bound: the floor check and
  the cosine may still drop a lane);
* ``lanes_differ``: the lanes where any output's bits differ between the
  kernel and the twin, and their largest relative gap (``worst_rel``);
* ``dead_changed``: the lanes that do not trace at the depth whose state
  the kernel changed (0: it leaves them as they were).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402


def renderer(name, res):
    """The prepared renderer of example ``name`` at ``res`` on the card,
    16 samples a launch (the benchmark's and the smoke's main path)."""
    from voxelrt_torch.app.examples import build_example

    r = build_example(name, "cuda", res, samples_per_launch=16).renderer
    r.prepare_data()
    return r


def capture(r, depths, all_features=False):
    """What ``shade_depth_eager`` is handed at each of ``depths`` in one
    launch of the prepared renderer ``r`` (a wavefront of its samples a
    launch) on the eager route of the card: (cfg, {depth: (scene, params,
    hit, knee_vis, state, draws)}), the state as it entered. The launch
    adds to ``r``'s accumulation. ``all_features``: the palette's Disney
    features all on in place of the scene's."""
    import dataclasses

    from voxelrt_torch.ops import prng
    from voxelrt_torch.render import pathtracer, pipeline

    cfg = (dataclasses.replace(r.cfg, material_features=())
           if all_features else r.cfg)
    params = r._params(1e9)
    got = {}
    orig = pathtracer.shade_depth_eager

    def keep(cfg_, scene, params_, d, hit, knee_vis, s, *draws):
        if d in depths and d not in got:
            got[d] = (scene, params_, hit, knee_vis,
                      pathtracer.PathState(**vars(s)), draws)
        return orig(cfg_, scene, params_, d, hit, knee_vis, s, *draws)

    applies = pathtracer.shade_kernel_applies
    pathtracer.shade_kernel_applies = lambda *a: False
    pathtracer.shade_depth_eager = keep
    try:
        pipeline.accumulate(cfg, r.scene_data, params, r.state, prng.key(7))
    finally:
        pathtracer.shade_kernel_applies = applies
        pathtracer.shade_depth_eager = orig
    torch.cuda.synchronize()
    return cfg, got


def own(s):
    """A copy of a state in buffers of its own: each V3 one (3, n) buffer,
    as the kernel's route holds it."""
    from voxelrt_torch.ops.v3 import V3
    from voxelrt_torch.render import pathtracer

    def one(x):
        if isinstance(x, V3):
            return V3(*torch.stack([c.expand(x.x.shape) for c in x]).clone())
        if isinstance(x, tuple):
            return tuple(c.clone() for c in x)
        return x.clone()

    return pathtracer.PathState(**{k: one(x) for k, x in vars(s).items()})


def fields(s):
    """(name, per-lane tensor) of every field of a state, in one order."""
    from voxelrt_torch.ops.v3 import V3

    n = s.tracing.shape[0]
    for name, x in sorted(vars(s).items()):
        parts = enumerate(x) if isinstance(x, (V3, tuple)) else [(None, x)]
        for i, c in parts:
            yield (name if i is None else f"{name}[{i}]"), c.expand(n)


def bits(t):
    """A tensor's bits: float32 as int32, float16 as int16."""
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    if t.dtype == torch.float16:
        return t.view(torch.int16)
    return t


def differ(a, b):
    """The lanes where any field's bits differ between states ``a`` and
    ``b``, and the largest relative gap there (inf where a field that is
    not float differs)."""
    off_any = None
    worst = 0.0
    for (_, x), (_, y) in zip(fields(a), fields(b)):
        off = bits(x) != bits(y)
        if off.any():
            if x.is_floating_point():
                rel = ((x - y).abs() / x.abs().clamp(min=1e-30))[off]
                worst = max(worst, float(rel.max()))
            else:
                worst = float("inf")
        off_any = off if off_any is None else off_any | off
    return off_any, worst


def bound_bytes(cfg, depth, hit, knee_vis, alive, surf):
    """The bytes a depth needs (see the module docstring)."""
    first, last = depth == 0, depth == cfg.max_ray_depth - 1
    nee = cfg.use_directional_light
    fin = torch.isfinite(hit.closest)
    n = hit.closest.shape[0]
    a = int(alive.sum())
    s = int(surf.sum())
    sky = int((alive & ~hit.hit_light & ~fin).sum())
    light = int((alive & hit.hit_light & fin).sum())
    vis = int((surf & (knee_vis != 0)).sum()) if nee else 0
    b = n * 1  # tracing
    # hit (33), pos, d, throughput (36), tracing out (1)
    b += a * (33 + 36 + 1)
    if first:
        b += a * (4 + 12 + 8 + 12 + 1)  # G-buffer words, is_sky
    elif depth == 1:
        b += a * (4 + 8)  # the first lobe, the reflection distance
    b += sky * (12 + 36)  # the sky draws, the escape record
    if not first:
        b += light * 24  # contrib read and written
    if nee:
        b += s * (8 + 4) + (s * 4 if first else 0)  # draws, verdict, pdf
        b += vis * (48 if first else 24)  # the NEE sums
    if not last:
        b += s * (12 + 36)  # bounce draws; throughput, d, pos
        if first:
            b += s * (4 + 4 + 12 + (12 if nee else 0))  # the first bounce
    return b


def run_depth(r, depth, reps):
    """Kernel S against its twin at ``depth`` of a launch of ``r`` (see the
    module docstring)."""
    from tools.torch_measure import HBM_BYTES_PER_S, device_ms
    from voxelrt_torch.ops import shade_kernel
    from voxelrt_torch.render import pathtracer

    cfg, got = capture(r, (depth,))
    scene, params, hit, knee_vis, snap, draws = got[depth]
    strans = pathtracer.center_transmittance(cfg, scene, params)
    feat = pathtracer.mat_features(cfg)

    def eager():
        s = pathtracer.PathState(**vars(snap))
        pathtracer.shade_depth_eager(cfg, scene, params, depth, hit,
                                     knee_vis, s, *draws)
        return s

    plain_ms = device_ms(eager, reps)
    ref = eager()
    pristine, work = own(snap), own(snap)

    def restore():
        for (_, dst), (_, src) in zip(fields(work), fields(pristine)):
            dst.copy_(src)

    def launch():
        shade_kernel.shade_depth(cfg, params, scene.mat_params, depth, hit,
                                 knee_vis, work, *draws, strans, feat)

    restore()
    launch()  # the first call loads the library
    k_ms, w_ms = [], []
    for idle in (False, True):
        for _ in range(reps):
            restore()
            if idle:
                torch.cuda.synchronize()
            else:
                torch.cuda._sleep(2_000_000)
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            e0.record()
            launch()
            e1.record()
            e1.synchronize()
            (w_ms if idle else k_ms).append(e0.elapsed_time(e1))
    restore()
    launch()
    torch.cuda.synchronize()
    off, worst = differ(ref, work)
    dead_changed = int((differ(pristine, work)[0] & ~snap.tracing).sum())
    nbytes = bound_bytes(cfg, depth, hit, knee_vis, snap.tracing,
                         ref.tracing)
    return dict(depth=depth, lanes=hit.closest.shape[0],
                alive=int(snap.tracing.sum()), surf=int(ref.tracing.sum()),
                device_ms=sorted(k_ms)[len(k_ms) // 2],
                ms_with_wrapper=sorted(w_ms)[len(w_ms) // 2],
                plain_ms=plain_ms,
                bound_bytes=nbytes,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                lanes_differ=int(off.sum()), worst_rel=worst,
                dead_changed=dead_changed)


def main(argv=None):
    from tools.torch_measure import card_name

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", default="example6")
    ap.add_argument("--res", default="1280x720")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    res = tuple(int(x) for x in args.res.split("x"))
    dev = torch.device("cuda")
    r = renderer(args.scene, res)
    rows = []
    for depth in range(r.cfg.max_ray_depth):
        row = run_depth(r, depth, args.reps)
        print(json.dumps(row), flush=True)
        rows.append(row)
        torch.cuda.empty_cache()
    out = dict(scene=args.scene, res=list(res), card=card_name(dev),
               torch=torch.__version__, depths=rows,
               **{k: sum(row[k] for row in rows) for k in (
                   "device_ms", "ms_with_wrapper", "plain_ms", "bound_ms")})
    print(json.dumps({k: v for k, v in out.items() if k != "depths"}))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)


if __name__ == "__main__":
    main()
