"""Time the sky fetches of another copy of the port against this tree's, on
the same recorded inputs, on one CUDA card:

    python tools/b3_ab_torch.py PARENT_DIR

PARENT_DIR holds another copy of the port (for example a commit's, unpacked
with ``git archive``): its ``voxelrt_torch/ops/texfetch.py``, bound to its
own build of ``voxelrt_torch/csrc/texfetch.cu``, and its
``voxelrt_torch/sky/atmos.py``, importing that texfetch module, are loaded
beside this tree's. The tool drives this tree's example6 (1280x720, 16
samples a launch) on path A' (``chip_smoke.SHADOW_PATH``: the bilinear sky
fetch and the per-ray NEE transmittance) and on the main path, and records
the last launch's escape fetch (``sample_skybox``, both maps), its per-ray
NEE lookup at depth 0 (``sample_skybox_transmittance``) and the main path's
one-lane cone-centre lookup. Then, in turns PARENT, this, this, PARENT:

  (i)  each of those three sky-fetch functions whole, glue included, with
       the tree's sky module: the card's time a call (``chip_smoke
       .device_ms``: calls enqueued behind a spin), CUDA events around the
       calls as the host issues them, and the kernels a call (the PyTorch
       operators dispatched, views left out, plus the port's own kernel
       launches); every output compared bit for bit with this tree's;
  (ii) end to end, with the tree's sky module in the pipeline: steady
       ``per_spp_ms`` of the main path (64 spp) and of path A' (32 spp),
       ``moving_frame_ms`` (the median FrameStats wall time of MOVING
       moving frames, the first two left out) with the host time a frame
       spent inside the sky module's two fetch functions and the garbage
       collector's passes during those frames, and the kernels and device
       ms of a profiled still launch and moving frame
       (``chip_smoke.profile_launch``).

Last, (iii) on the escape fetch's inputs, this tree's
``bilinear_fetch_dirs2`` from the interleaved 16-byte table against
``tools/b3_split_probe.cu``, the same kernel making two 8-byte loads a
corner from the two maps' own arrays, in turns (interleaved, split, split,
interleaved), device ms, outputs compared.

Prints one line per measurement, writes everything to
``chiprun_out/b3_ab.json``, and exits 1 if any output differs.
"""

from __future__ import annotations

import collections
import ctypes
import gc
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (MAIN_SPL, MOVE, SHADOW_PATH, OpCounter,  # noqa: E402
                        Recorder, build_example, cuda_ms, device_ms,
                        profile_launch)

MOVING = 12  # moving frames a turn
REPS = 10
FETCHES = ("escape", "nee_depth0", "cone_centre")


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_tree(path, tag):
    """(sky module, its launch counts) of the copy of the port under
    ``path``, its texfetch module bound to its own build of texfetch.cu."""
    import voxelrt_torch.ops as ops_pkg
    from voxelrt_torch.ops import _cuda
    from voxelrt_torch.ops import texfetch as this_tf

    out = os.path.join(_cuda.BUILD_DIR, f"libtexfetch_{tag}.so")
    os.makedirs(_cuda.BUILD_DIR, exist_ok=True)
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", out,
                    os.path.join(path, "voxelrt_torch", "csrc",
                                 "texfetch.cu")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(out)
    tf = _load(f"b3_ab_{tag}_texfetch",
               os.path.join(path, "voxelrt_torch", "ops", "texfetch.py"))
    launches = collections.defaultdict(int)
    tf._cuda = types.SimpleNamespace(
        require=_cuda.require, check=_cuda.check, stream_ptr=_cuda.stream_ptr,
        LAUNCHES=launches, lib=lambda name: lib)
    # the tree's sky module imports the tree's texfetch module
    sys.modules["voxelrt_torch.ops.texfetch"] = ops_pkg.texfetch = tf
    try:
        atmos = _load(f"b3_ab_{tag}_atmos",
                      os.path.join(path, "voxelrt_torch", "sky", "atmos.py"))
    finally:
        sys.modules["voxelrt_torch.ops.texfetch"] = this_tf
        ops_pkg.texfetch = this_tf
    return atmos, launches


class using:
    """Inside the block, the pipeline's lazy imports of the sky module find
    ``atmos``."""

    def __init__(self, atmos):
        self.atmos = atmos

    def __enter__(self):
        self.saved = sys.modules["voxelrt_torch.sky.atmos"]
        sys.modules["voxelrt_torch.sky.atmos"] = self.atmos

    def __exit__(self, *exc):
        sys.modules["voxelrt_torch.sky.atmos"] = self.saved


def bits(v):
    """A sky fetch's result (a V3, or a pair of them) as int32 tensors."""
    import torch

    if isinstance(v, tuple) and not hasattr(v, "x"):
        return [b for part in v for b in bits(part)]
    return [c.contiguous().view(torch.int32) for c in v]


def kernels_per_call(fn, launches):
    """PyTorch operators dispatched (views left out) plus the port's own
    kernel launches, in one call of ``fn``."""
    before = sum(launches.values())
    with OpCounter() as ops:
        fn()
    return ops.count + sum(launches.values()) - before


def time_fetches(tree, atmos, launches, calls, ref):
    """(i) for one tree."""
    import torch

    rows = []
    for tag in FETCHES:
        fname, args, kw = calls[tag]
        fn = getattr(atmos, fname)

        def call():
            return fn(*args, **kw)

        out = bits(call())
        rows.append(dict(
            tree=tree, fetch=tag, function=fname,
            lanes=args[2].x.shape[0], device_ms=device_ms(call, REPS),
            wall_ms=cuda_ms(call, REPS),
            kernels=kernels_per_call(call, launches),
            equal=all(torch.equal(a, b) for a, b in zip(out, ref[tag]))))
        print(json.dumps(rows[-1]), flush=True)
    return rows


def steady_ms(r, spp):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.render(spp=spp)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / spp * 1e3


class HostTimer:
    """Inside the block, the host seconds spent in the sky module's two
    fetch functions, summed over their calls."""

    NAMES = ("sample_skybox", "sample_skybox_transmittance")

    def __init__(self, atmos):
        self.atmos, self.s = atmos, 0.0

    def __enter__(self):
        self.saved = {n: getattr(self.atmos, n) for n in self.NAMES}
        for n, fn in self.saved.items():
            def timed(*a, _fn=fn, **k):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **k)
                finally:
                    self.s += time.perf_counter() - t0
            setattr(self.atmos, n, timed)
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.atmos, n, fn)


def end_to_end(tree, atmos, main, path_a, moving):
    """(ii) for one tree, its sky module in the pipeline."""
    from voxelrt_torch.utils.profiling import FrameStats

    with using(atmos):
        main_ms = steady_ms(main.renderer, 4 * MAIN_SPL)
        path_a_ms = steady_ms(path_a.renderer, 2 * MAIN_SPL)
        still = profile_launch(main.renderer, main_ms * MAIN_SPL)
        gc_before = [g["collections"] for g in gc.get_stats()]
        with open(os.devnull, "w") as null, HostTimer(atmos) as sky_host:
            stats = FrameStats(out=null)
            moving.run_frames([dict(MOVE) for _ in range(MOVING)],
                              stats=stats, fetch_final=False)
        gc_passes = [g["collections"] - b
                     for g, b in zip(gc.get_stats(), gc_before)]
        walls = [r["wall_ms"] for r in stats.rows[2:]]
        frame = profile_launch(moving.renderer, statistics.median(walls),
                               moving=True)
    row = dict(tree=tree, main_per_spp_ms=main_ms,
               path_a_per_spp_ms=path_a_ms,
               moving_frame_ms=statistics.median(walls),
               frame_walls_ms=walls,
               sky_host_ms_per_frame=sky_host.s / MOVING * 1e3,
               gc_passes_by_generation=gc_passes,
               still_launch_kernels=still["kernels"],
               still_launch_device_ms=still["device_ms"],
               still_launch_b3_device_ms=still["by_group_ms"][
                   "bilinear_kernel"],
               moving_frame_kernels=frame["kernels"],
               moving_frame_device_ms=frame["device_ms"])
    print(json.dumps(row), flush=True)
    return row


def split_probe():
    """The C entry of ``tools/b3_split_probe.cu``, built with the kernels'
    flags."""
    from voxelrt_torch.ops import _cuda

    out = os.path.join(_cuda.BUILD_DIR, "libb3_split_probe.so")
    os.makedirs(_cuda.BUILD_DIR, exist_ok=True)
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", _cuda.CSRC,
                    "-o", out, os.path.join(ROOT, "tools",
                                            "b3_split_probe.cu")],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(out).bilinear_fetch_dirs2_split
    p, ll = ctypes.c_void_p, ctypes.c_longlong
    fn.argtypes = ([p] * 5 + [ll] * 3 + [p] * 3 + [ll] * 3
                   + [p, ll, ctypes.c_int, p])
    fn.restype = ctypes.c_int
    return fn


def layouts(sky, d, res, u3):
    """(iii): dirs2 from the interleaved table against the split layout's
    probe, on the escape fetch's inputs."""
    import torch

    from voxelrt_torch.ops import _cuda
    from voxelrt_torch.ops import texfetch as tf

    fn, dev, n = split_probe(), sky.packed_st.device, d.x.shape[0]
    vecs = [a for v in (d, u3) for a in ([c.data_ptr() for c in v]
                                         + [c.stride(0) for c in v])]

    def split():
        out = torch.empty((6, n), dtype=torch.float32, device=dev)
        _cuda.check(fn(sky.packed_scatt.data_ptr(),
                       sky.packed_trans.data_ptr(), *vecs, out.data_ptr(), n,
                       res, _cuda.stream_ptr(dev)), "b3_split_probe")
        return out

    def interleaved():
        return tf.bilinear_fetch_dirs2(sky.packed_scatt, sky.packed_trans,
                                       sky.packed_st, d, res, u3)

    s, t = interleaved()
    equal = torch.equal(torch.cat([s.t(), t.t()]).view(torch.int32),
                        split().view(torch.int32))
    fns = dict(interleaved=interleaved, split=split)
    rows = []
    for k in ("interleaved", "split", "split", "interleaved"):
        rows.append(dict(layout=k, lanes=n, device_ms=device_ms(fns[k], REPS),
                         equal=equal))
        print(json.dumps(rows[-1]), flush=True)
    return rows


def freeze(call):
    """A recorded call with its V3 arguments copied, each into the layout
    the path holds (the column views of one (N, 3) tensor), so that later
    renders cannot change them."""
    import torch

    from voxelrt_torch.ops.v3 import V3

    def copy(a):
        if not isinstance(a, V3):
            return a
        t = torch.stack([c.reshape(-1) for c in a], dim=1)
        return V3(t[:, 0], t[:, 1], t[:, 2])

    args, kw = call
    return tuple(copy(a) for a in args), kw


def record(scene, names):
    """The arguments of the last calls of the sky module's ``names`` in one
    launch of ``scene``, frozen."""
    from voxelrt_torch.sky import atmos

    recs = {n: Recorder(atmos, n, keep=1) for n in names}
    try:
        scene.renderer.render(spp=MAIN_SPL)
    finally:
        for rec in recs.values():
            rec.restore()
    return {n: freeze(rec.calls[-1]) for n, rec in recs.items()}


def main(argv=None):
    import torch

    from voxelrt_torch.ops import _cuda
    from voxelrt_torch.sky import atmos

    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
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
    parent = argv[0]
    trees = {"this": (atmos, _cuda.LAUNCHES), parent: load_tree(parent, "p")}

    path_a = build_example("example6", None, samples_per_launch=MAIN_SPL,
                           **SHADOW_PATH)
    main_s = build_example("example6", None, samples_per_launch=MAIN_SPL)
    moving = build_example("example6", None)
    for s in (path_a, main_s):
        s.renderer.prepare_data()
    # the first escape-fetch call of a launch is the deferred escape sky; the
    # first transmittance call is the depth-0 per-ray NEE lookup
    rec = Recorder(atmos, "sample_skybox_transmittance", keep=8)
    got = record(path_a, ["sample_skybox"])
    rec.restore()
    nee = freeze(rec.calls[-path_a.renderer.cfg.max_ray_depth])
    cone = record(main_s, ["sample_skybox_transmittance"])
    calls = {"escape": ("sample_skybox", *got["sample_skybox"]),
             "nee_depth0": ("sample_skybox_transmittance", *nee),
             "cone_centre": ("sample_skybox_transmittance",
                             *cone["sample_skybox_transmittance"])}
    ref = {tag: bits(getattr(atmos, f)(*a, **k))
           for tag, (f, a, k) in calls.items()}

    fetch_rows, e2e_rows = [], []
    for tree in (parent, "this", "this", parent):
        tree_atmos, launches = trees[tree]
        fetch_rows += time_fetches(tree, tree_atmos, launches, calls, ref)
        e2e_rows.append(end_to_end(tree, tree_atmos, main_s, path_a, moving))
    _, (cfg, sky, d, u3), _ = calls["escape"]
    layout_rows = layouts(sky, d, cfg.skybox_res, u3)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "b3_ab.json"), "w") as fh:
        json.dump(dict(device=smi, parent=parent, fetches=fetch_rows,
                       end_to_end=e2e_rows, layouts=layout_rows), fh,
                  indent=1)
    print(smi)
    bad = [r for r in fetch_rows + layout_rows if not r["equal"]]
    if bad:
        print(f"FAIL: {len(bad)} result(s) differ from this tree's",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
