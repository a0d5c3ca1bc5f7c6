"""Time kernel B4 and the moving frame of other copies of the port against
this tree's, on the same recorded inputs, on one CUDA card:

    python tools/b4_ab_torch.py PARENT_DIR [OTHER_DIR ...]

Each directory holds another copy of the port (for example a commit's,
unpacked with ``git archive``): its ``voxelrt_torch/render/temporal.py`` and
``voxelrt_torch/ops/resample.py`` are loaded, the latter bound to its own
build of ``voxelrt_torch/csrc/resample.cu``. The tool drives this tree's
example6 Scene (1280x720, default config) through four moving frames and
records the last one's two ``_moving_taps`` calls (diffuse, specular). On
those inputs it times, in turns PARENT, this, this, PARENT:

  (i)   B4's launch alone: each tree's ``temporal_taps`` on the arguments
        its own ``_moving_taps`` gives it, with the recorded Catmull-Rom
        taps and with the bilinear ones;
  (ii)  ``_moving_taps`` whole, its kernel path with whatever packing the
        tree does around the launch, with either tap filter;
  (iii) ``moving_frame_ms`` (the median FrameStats wall time of
        ``Scene.run_frames`` over MOVING frames, the first two left out)
        and the kernels and device time of one profiled moving frame, with
        the tree's temporal module in the pipeline.

(i) and (ii) are read by device time (for (i) ``chip_smoke.device_ms``:
CUDA events around calls enqueued behind a spin, so that they run back to
back; for (ii) torch.profiler, every kernel, with their count) and by CUDA
events around the calls as the host issues them. Every OTHER_DIR gets (i) and (ii) once, in the same call. Each
tree's B4 outputs are compared with this tree's by value (``torch.equal``,
so a zero's sign is not compared: trees before this one's kernel took it
from the operand order, where PyTorch's min/max and this kernel take
fmaxf's; the values whose bits differ are counted). Prints one line per
measurement, writes
everything to ``chiprun_out/b4_ab.json``, and exits 1 if any output
differs.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (MOVE, Recorder, build_example, cuda_ms,  # noqa: E402
                        device_ms, profile_launch)

MOVING = 12  # moving frames a turn of (iii)
REPS = 10


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_tree(path, tag):
    """(temporal module, resample module) of the copy of the port under
    ``path``, its resample bound to its own build of ``resample.cu``."""
    import voxelrt_torch.ops as ops_pkg
    from voxelrt_torch.ops import _cuda
    from voxelrt_torch.ops import resample as this_rs

    out = os.path.join(_cuda.BUILD_DIR, f"libresample_{tag}.so")
    os.makedirs(_cuda.BUILD_DIR, exist_ok=True)
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", out,
                    os.path.join(path, "voxelrt_torch", "csrc",
                                 "resample.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(out)
    rs = _load(f"b4_ab_{tag}_resample",
               os.path.join(path, "voxelrt_torch", "ops", "resample.py"))
    rs._cuda = types.SimpleNamespace(
        require=_cuda.require, check=_cuda.check, stream_ptr=_cuda.stream_ptr,
        LAUNCHES=collections.defaultdict(int), lib=lambda name: lib)
    # the tree's temporal module imports the tree's resample module
    sys.modules["voxelrt_torch.ops.resample"] = ops_pkg.resample = rs
    try:
        tm = _load(f"b4_ab_{tag}_temporal",
                   os.path.join(path, "voxelrt_torch", "render",
                                "temporal.py"))
    finally:
        sys.modules["voxelrt_torch.ops.resample"] = this_rs
        ops_pkg.resample = this_rs
    return tm, rs


def all_kernels(fn, reps):
    """Device ms and kernel launches a call of ``fn``, every kernel
    counted (torch.profiler, ``reps`` calls after a warm-up)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ms = n = 0
    for e in p.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms += e.self_device_time_total / 1e3
            n += e.count
    return ms / reps, n / reps


def b4_call(tm, margs, mkw):
    """The arguments the tree's ``_moving_taps`` gives its B4 wrapper, and
    the ``_moving_taps`` result."""
    rec = Recorder(tm, "temporal_taps", keep=1)
    try:
        res = tm._moving_taps(*margs, **mkw)
    finally:
        rec.restore()
    return rec.calls[0], res


def same(a, b):
    """Whether two B4 results hold the same values (shapes aside)."""
    import torch

    return all((x is None and y is None) or (
        x is not None and y is not None
        and torch.equal(x.reshape(-1), y.reshape(-1))) for x, y in zip(a, b))


def bits_differ(a, b):
    """Output values (of the same value in both) whose bits differ: a zero's
    sign."""
    import torch

    return sum(int((x.reshape(-1).view(torch.int32)
                    != y.reshape(-1).view(torch.int32)).sum().item())
               for x, y in zip(a, b) if x is not None)


def time_calls(tree, rs, tm, calls, ref):
    """(i) and (ii) for one tree on the recorded ``_moving_taps`` calls."""
    rows = []
    for (margs, mkw), tag in zip(calls, ("diffuse", "specular")):
        (a, k), res = b4_call(tm, margs, mkw)

        def launch(cat=True):
            return rs.temporal_taps(*a, **dict(k, catmullrom=cat))

        bil_args = (dataclasses.replace(margs[0], motion_filter="bilinear"),
                    *margs[1:])

        def path(bilinear=False):
            return tm._moving_taps(*(bil_args if bilinear else margs), **mkw)

        dev_path, n_path = all_kernels(path, REPS)
        dev_bil, n_bil = all_kernels(lambda: path(True), REPS)
        rows.append(dict(
            tree=tree, pass_=tag, b4_device_ms=device_ms(launch, REPS),
            b4_wall_ms=cuda_ms(launch, REPS),
            b4_bilinear_device_ms=device_ms(lambda: launch(False), REPS),
            path_device_ms=dev_path, path_kernels=n_path,
            path_wall_ms=cuda_ms(path, REPS),
            path_bilinear_device_ms=dev_bil, path_bilinear_kernels=n_bil,
            path_bilinear_wall_ms=cuda_ms(lambda: path(True), REPS),
            equal=(same(launch(), ref[tag]) and same(res, ref[tag])
                   and same(launch(False), ref[tag + "_bilinear"])),
            zero_sign_differs=bits_differ(launch(), ref[tag]),
            zero_sign_differs_bilinear=bits_differ(
                launch(False), ref[tag + "_bilinear"])))
        print(json.dumps(rows[-1]), flush=True)
    return rows


def time_frames(tree, tm, scene):
    """(iii) for one tree: its temporal module in the pipeline."""
    from voxelrt_torch.render import pipeline
    from voxelrt_torch.utils.profiling import FrameStats

    saved = pipeline.temporal
    pipeline.temporal = tm
    try:
        with open(os.devnull, "w") as null:
            stats = FrameStats(out=null)
            scene.run_frames([dict(MOVE) for _ in range(MOVING)],
                             stats=stats, fetch_final=False)
        walls = [r["wall_ms"] for r in stats.rows[2:]]
        prof = profile_launch(scene.renderer, statistics.median(walls),
                              moving=True)
    finally:
        pipeline.temporal = saved
    row = dict(tree=tree, moving_frame_ms=statistics.median(walls),
               frame_walls_ms=walls, frame_kernels=prof["kernels"],
               frame_device_ms=prof["device_ms"],
               frame_b4_device_ms=prof["by_group_ms"]["taps_kernel"])
    print(json.dumps(row), flush=True)
    return row


def main(argv=None):
    import torch

    from voxelrt_torch.ops import _cuda
    from voxelrt_torch.render import temporal

    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {smi}", flush=True)
    _cuda.build_all()
    from voxelrt_torch.ops import resample as this_rs

    trees = {"this": (temporal, this_rs)}
    for i, path in enumerate(argv):
        trees[path] = load_tree(path, f"t{i}")
    scene = build_example("example6", None)
    rec = Recorder(temporal, "_moving_taps", keep=2)
    try:
        scene.run_frames([dict(MOVE) for _ in range(4)], fetch_final=False)
    finally:
        rec.restore()
    calls = rec.calls
    ref = {}
    for (a, k), tag in zip(calls, ("diffuse", "specular")):
        ref[tag] = temporal._moving_taps(*a, **k)
        (ta, tk), _ = b4_call(temporal, a, k)
        ref[tag + "_bilinear"] = this_rs.temporal_taps(
            *ta, **dict(tk, catmullrom=False))
    parent = argv[0]
    calls_rows, frame_rows = [], []
    for tree in (parent, "this", "this", parent):
        tm, rs = trees[tree]
        calls_rows += time_calls(tree, rs, tm, calls, ref)
        frame_rows.append(time_frames(tree, tm, scene))
    for path in argv[1:]:
        tm, rs = trees[path]
        calls_rows += time_calls(path, rs, tm, calls, ref)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "b4_ab.json"), "w") as fh:
        json.dump(dict(device=smi, trees=argv, calls=calls_rows,
                       frames=frame_rows), fh, indent=1)
    print(smi)
    bad = [r for r in calls_rows if not r["equal"]]
    if bad:
        print(f"FAIL: {len(bad)} B4 result(s) differ from this tree's",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
