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
    python3 tools/path_frames_torch.py stages [--device cuda] [--against cpu]
                                       [--scene NAME] [--out FILE]
    python3 tools/path_frames_torch.py ops [--device cuda] [--against cpu]
                                       [--scene NAME] [--res 320x180]
                                       [--align OPS ...]

``render`` writes ``OUT/fNN.png`` for each frame counted from 1 (on the
CUDA card unless ``--device`` names another). ``compare`` prints one JSON
line a frame present in both directories: the RMSE, the share of pixels
whose channels are all equal, whose largest difference is one 8-bit level
and whose largest is more than two, the clusters (8-connected) of those
beyond two levels and the largest, and the channel values one level above
and one level below (A against B).

``stages`` renders frame 1 (the first moving frame) on two devices in one
process and splits their difference by stage: the trace (``trace_frame``'s
diffuse and specular colour), the temporal prepass, B4
(``temporal_taps``, the diffuse call then the specular one), the temporal
filters and the tonemap (``render_to_image``). For each output it prints
the values that differ, above and below (``--device`` against
``--against``), twice: ``chain``, the two runs' outputs, which carry every
earlier stage's difference; and ``own``, the ``--device`` run's output
against the stage run on ``--against`` with the ``--device`` run's inputs,
the stage's own part. The tonemap's 8-bit channels one level above and
below come with both.

With ``--scene NAME`` both split that example's still launch in place of
frame 1: one launch of 16 samples through ``Scene.finish``, as
``chip_smoke.py`` phase 17 and the example's full-width golden render it
(example7 and example10 lit by their shipped TINY_SKY sky); a still launch
calls no B4. The result goes to ``chiprun_out/<scene>_stages.json`` or
``<scene>_ops.json`` unless ``--out`` names another file.

``ops`` goes one level down, into frame 1's trace at ``--res``: every
PyTorch operator the trace dispatches on ``--device`` is run again on
``--against`` with the same inputs, and by operator it prints the float
values that differ, above and below (the operator's own part; the kernels,
which are no PyTorch operators, are left out), and the trace's diffuse
colour against ``--against``'s; ``--align div rsqrt sin,cos all`` runs the
trace again once for each set, those operators' outputs taken from
``--against``, and prints the colour that then remains apart.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (EXAMPLE_SKIES, EXAMPLE_SPP, HOLD, MOVE,  # noqa: E402
                        N_MOVING, N_STILL, TINY_SKY, shipped_sky)

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


def _to(x, device):
    """``x`` with every tensor in it (through tuples, named tuples, lists
    and dicts) copied to ``device``, and every device named in it
    replaced by ``device``."""
    import torch

    device = torch.device(device)
    if isinstance(x, torch.Tensor):
        return x.detach().to(device, copy=True)
    if isinstance(x, torch.device):
        return device
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to(v, device) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_to(v, device) for v in x)
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    return x


def _outputs(x):
    """The arrays of a stage's output, by position or key."""
    import torch

    if isinstance(x, torch.Tensor):
        return {"": x.detach().float().cpu().numpy()}
    if isinstance(x, np.ndarray):
        return {"": x.astype(np.float32)}
    items = x.items() if isinstance(x, dict) else enumerate(x)
    return {f"{k}": v.detach().float().cpu().numpy() for k, v in items
            if isinstance(v, torch.Tensor)}


def drive(device, scene=None, res=None):
    """Renders frame 1 of the path on ``device`` or, with ``scene``, that
    example's still launch as ``chip_smoke.py`` phase 17 and its golden
    render it: one launch of ``EXAMPLE_SPP`` samples through
    ``Scene.finish``, example7 and example10 lit by their shipped TINY_SKY
    sky; at ``res`` (default 1280x720)."""
    import tempfile

    from voxelrt_torch.app.examples import build_example

    if scene is None:
        build_example("example6", device, res).run_frames(
            [dict(FRAMES[0])], on_frame=lambda i, img: None)
        return
    over = dict(samples_per_launch=EXAMPLE_SPP)
    with tempfile.TemporaryDirectory() as cache:
        if scene in EXAMPLE_SKIES:
            shipped_sky(scene, cache)
            over.update(TINY_SKY)
        build_example(scene, device, res, sky_cache_dir=cache,
                      **over).finish(spp=EXAMPLE_SPP, save=False)


def frame1_stages(device, scene=None):
    """Frame 1 of the path (or ``scene``'s still launch, see ``drive``) on
    ``device``: each stage's calls in order, as (stage, function, args,
    kwargs, output)."""
    from voxelrt_torch.render import pipeline, temporal

    hooks = [(pipeline, "trace_frame", "trace"),
             (temporal, "temporal_prepass", "prepass"),
             (temporal, "temporal_taps", "b4"),
             (temporal, "temporal_filter", "filter"),
             (temporal, "temporal_filter_specular", "filter_specular"),
             (pipeline, "render_to_image", "tonemap")]
    calls = []
    origs = [(m, name, getattr(m, name)) for m, name, _ in hooks]

    def hook(fn, stage):
        def wrapper(*args, **kwargs):
            out = fn(*args, **kwargs)
            calls.append((stage, fn, args, kwargs, out))
            return out
        return wrapper

    for (m, name, stage), (_, _, fn) in zip(hooks, origs):
        setattr(m, name, hook(fn, stage))
    try:
        drive(device, scene)
    finally:
        for m, name, fn in origs:
            setattr(m, name, fn)
    return calls


def _signs(a, b):
    d = a.astype(np.float64) - b
    return dict(unequal=int((d != 0).sum()), above=int((d > 0).sum()),
                below=int((d < 0).sum()), max_abs=float(np.abs(d).max()))


def _levels(a, b):
    from voxelrt_torch.utils.image import to_uint8_rows

    d = to_uint8_rows(a).astype(int) - to_uint8_rows(b)
    return dict(one_above=int((d == 1).sum()), one_below=int((d == -1).sum()),
                beyond=int((np.abs(d) > 1).sum()))


def stages(device, against, out_path, scene=None):
    """Frame 1's stages (or ``scene``'s still launch's) on ``device``
    against ``against``, printed as JSON lines and written to
    ``out_path``."""
    a_calls = frame1_stages(device, scene)
    b_calls = frame1_stages(against, scene)
    if [c[0] for c in a_calls] != [c[0] for c in b_calls]:
        raise SystemExit("the two runs called the stages in another order")
    rows = []
    for (stage, fn, args, kwargs, a_out), b in zip(a_calls, b_calls):
        # the trace's inputs are the same on both devices, so its own part
        # is its chain
        own_out = b[4] if stage == "trace" else fn(*_to(args, against),
                                                   **_to(kwargs, against))
        a_arr, b_arr, own = (_outputs(x) for x in (a_out, b[4], own_out))
        for k in a_arr:
            row = dict(stage=stage, output=k, shape=list(a_arr[k].shape),
                       chain=_signs(a_arr[k], b_arr[k]),
                       own=_signs(a_arr[k], own[k]))
            if stage == "tonemap":
                row["chain_8bit"] = _levels(a_arr[k], b_arr[k])
                row["own_8bit"] = _levels(a_arr[k], own[k])
            rows.append(row)
            print(json.dumps(row), flush=True)
    import torch

    from tools.torch_measure import card_name

    card = card_name(torch.device(device))
    what = f"{scene}'s still launch" if scene else "frame 1"
    print(f"{what}, {device} against {against}, on {card}", flush=True)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as fh:
        json.dump(dict(device=device, against=against, scene=scene,
                       card=card, rows=rows), fh, indent=1)


def trace_ops(device, against, res, out_path, aligns=(), scene=None):
    """Frame 1's trace (or ``scene``'s still launch's, see ``drive``) at
    ``res`` on ``device``, each PyTorch operator run
    again on ``against`` with the same inputs; by operator, printed as JSON
    lines (the most unequal first) and written to ``out_path``, with the
    trace's diffuse colour against ``against``'s. Each entry of ``aligns``
    (operator names joined by commas, or 'all') runs the trace again with
    those operators' outputs taken from ``against``, and prints the colour
    that then remains apart."""
    import collections

    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from tools.torch_measure import card_name
    from voxelrt_torch.render import pipeline

    here, other = torch.device(device), torch.device(against)
    # operators whose output is not a function of their inputs' values
    skip = ("empty", "new_empty", "_local_scalar_dense", "set_", "resize_")

    def tensors(x):
        if isinstance(x, torch.Tensor):
            return [x]
        if isinstance(x, (list, tuple)):
            return [t for v in x for t in tensors(v)]
        return []

    def run(dev, align=None):
        """(counts by operator, the trace's diffuse colour) of frame 1 on
        ``dev``; with ``align`` (a set of names), every operator is run
        again on ``against``, and those named return that result."""
        by_op = collections.defaultdict(lambda: dict.fromkeys(
            ("calls", "values", "unequal", "above", "below"), 0))
        colors = []

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                name = func.__name__
                if name.startswith(skip):
                    return func(*args, **kwargs)
                again = _to((args, kwargs), other)
                out = func(*args, **kwargs)
                ref = func(*again[0], **again[1])
                base = name.split(".")[0]
                c = by_op[base]
                c["calls"] += 1
                for o, r in zip(tensors(out), tensors(ref)):
                    if not o.dtype.is_floating_point or o.shape != r.shape:
                        continue
                    o, r = o.detach().cpu(), r.cpu()
                    ne = ~((o == r) | (o.isnan() & r.isnan()))
                    c["values"] += o.numel()
                    c["unequal"] += int(ne.sum())
                    c["above"] += int((o > r).sum())
                    c["below"] += int((o < r).sum())
                # only functional operators: no view, no in-place write
                functional = not func._schema.is_mutable and not any(
                    r.alias_info for r in func._schema.returns)
                if functional and (base in align or "all" in align):
                    return _to(ref, here)
                return out

        trace = pipeline.trace_frame

        def traced(*args, **kwargs):
            if align is None:
                out = trace(*args, **kwargs)
            else:
                with Mode():
                    out = trace(*args, **kwargs)
            colors.append(out["color"].detach().float().cpu().numpy())
            return out

        pipeline.trace_frame = traced
        try:
            drive(dev, scene, res)
        finally:
            pipeline.trace_frame = trace
        return by_op, colors[0]

    _, ref_color = run(against)
    by_op, color = run(device, set())
    rows = sorted(({"op": k, **v} for k, v in by_op.items()),
                  key=lambda r: -r["unequal"])
    card = card_name(here)
    for r in rows:
        if r["unequal"]:
            print(json.dumps(r), flush=True)
    what = f"{scene}'s still launch" if scene else "frame 1"
    print(f"{what}'s trace at {res[0]}x{res[1]}, {device} against "
          f"{against}, {sum(r['calls'] for r in rows)} operator calls, on "
          f"{card}", flush=True)
    colors = {"none": _signs(color, ref_color)}
    for align in aligns:
        colors[align] = _signs(run(device, set(align.split(",")))[1],
                               ref_color)
    for align, c in colors.items():
        print(json.dumps(dict(aligned=align, color=c)), flush=True)
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as fh:
        json.dump(dict(device=device, against=against, scene=scene,
                       res=list(res), card=card, ops=rows,
                       color_by_aligned=colors), fh, indent=1)


def main():
    from voxelrt_torch.app.examples import NAMES

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("render")
    r.add_argument("out")
    r.add_argument("--device", default=None)
    r.add_argument("--frames", default=",".join(map(str, KEEP)))
    c = sub.add_parser("compare")
    c.add_argument("dir_a")
    c.add_argument("dir_b")
    st = sub.add_parser("stages")
    st.add_argument("--device", default="cuda")
    st.add_argument("--against", default="cpu")
    st.add_argument("--out", default=None,
                    help="default chiprun_out/frame1_stages.json, or "
                    "<scene>_stages.json")
    o = sub.add_parser("ops")
    o.add_argument("--device", default="cuda")
    o.add_argument("--against", default="cpu")
    o.add_argument("--res", default="320x180")
    o.add_argument("--out", default=None,
                   help="default chiprun_out/frame1_ops.json, or "
                   "<scene>_ops.json")
    o.add_argument("--align", nargs="*", default=[],
                   help="operator sets (names joined by commas, or 'all') "
                   "whose outputs are taken from --against, one run each")
    for p in (st, o):
        p.add_argument("--scene", default=None, choices=NAMES,
                       help="an example's still launch in place of frame 1 "
                       "of the path")
    args = ap.parse_args()
    if args.cmd in ("stages", "ops") and args.out is None:
        args.out = os.path.join(ROOT, "chiprun_out",
                                f"{args.scene or 'frame1'}_{args.cmd}.json")
    if args.cmd == "ops":
        trace_ops(args.device, args.against,
                  tuple(int(x) for x in args.res.split("x")), args.out,
                  args.align, args.scene)
    elif args.cmd == "render":
        render(args.out, args.device,
               {int(n) for n in args.frames.split(",")})
    elif args.cmd == "stages":
        stages(args.device, args.against, args.out, args.scene)
    else:
        compare(args.dir_a, args.dir_b)


if __name__ == "__main__":
    main()
