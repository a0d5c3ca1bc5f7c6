"""Time kernel B1 of another copy of the port against this tree's, on the
same recorded dispatches, on one CUDA card:

    python tools/b1_ab_torch.py OTHER_DIR

``OTHER_DIR`` holds another copy of the port (for example the parent
commit's, unpacked with ``git archive``): its
``voxelrt_torch/ops/dda_kernel.py`` and ``voxelrt_torch/csrc/dda.cu`` are
loaded and built beside this tree's. The tool records the B1 dispatches of
example6 at 1280x720 with 16 samples per launch: the main path's four
(closest hit with in-kernel NEE, depths 0-3) and the explicit-shadow path's
eight (a closest-hit and a shadow-mode dispatch per depth). On each
dispatch it times the two in turns (other, this, this, other), each by CUDA
events over 3 launches after a warm-up, then this tree once more with its
sun-open early-outs off (``sun_mode='off'``, ``nee_src_open`` and
``use_sun_open`` false), and checks that every output of each is bit-equal
to this tree's. The other copy's wrapper gets only the arguments its
signature takes. Prints one line per dispatch, writes everything to
``chiprun_out/b1_ab.json``, and exits 1 if any output differs.
"""

from __future__ import annotations

import collections
import ctypes
import importlib.util
import inspect
import json
import os
import subprocess
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import SHADOW_PATH, Recorder, cuda_ms  # noqa: E402

FIELDS = ("distance", "ipos", "normal", "iters", "color_word", "active",
          "nee_visible")
EARLY_OUTS_OFF = dict(sun_mode="off", nee_src_open=False, use_sun_open=False)


def load_other(path):
    """The B1 wrapper module of the copy of the port under ``path``, bound
    to its own build of ``dda.cu``."""
    from voxelrt_torch.ops import _cuda

    src = os.path.join(path, "voxelrt_torch", "csrc", "dda.cu")
    out = os.path.join(_cuda.BUILD_DIR, "libdda_other.so")
    os.makedirs(_cuda.BUILD_DIR, exist_ok=True)
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", out, src],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(out)
    spec = importlib.util.spec_from_file_location(
        "b1_ab_other", os.path.join(path, "voxelrt_torch", "ops",
                                    "dda_kernel.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod._cuda = types.SimpleNamespace(
        require=_cuda.require, check=_cuda.check, stream_ptr=_cuda.stream_ptr,
        LAUNCHES=collections.defaultdict(int), lib=lambda name: lib)
    return mod


def record_dispatches(over, keep):
    """The last ``keep`` B1 dispatches of one 16-sample launch of example6
    at 1280x720 with the config overrides ``over``: (args, kwargs) each."""
    from voxelrt_torch.app.examples import build_example
    from voxelrt_torch.render import pathtracer as pt

    r = build_example("example6", None, samples_per_launch=16,
                      **over).renderer
    r.prepare_data()
    rec = Recorder(pt, "raytrace", keep=keep)
    try:
        r.render(spp=16)
    finally:
        rec.restore()
    return rec.calls


def _call(mod, call, extra=None):
    """Run ``mod.raytrace`` on one recorded dispatch, with the arguments
    its signature takes."""
    args, kw = call
    takes = inspect.signature(mod.raytrace).parameters
    kw = {k: v for k, v in dict(kw, **(extra or {})).items() if k in takes}
    t = mod.DeviceTables(**{f: getattr(args[0], f)
                            for f in mod.DeviceTables._fields})
    return lambda: mod.raytrace(t, *args[1:], **kw)


def _differ(a, b):
    """Fields in which result ``a`` is not bit-equal to ``b`` (fields that
    either leaves None are skipped)."""
    import torch

    out = []
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            continue
        xs = list(x) if isinstance(x, tuple) else [x]
        ys = list(y) if isinstance(y, tuple) else [y]
        if not all(torch.equal(p, q) for p, q in zip(xs, ys)):
            out.append(f)
    return out


def main(argv=None):
    import torch

    from voxelrt_torch.ops import dda_kernel as dk

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
    other = load_other(argv[0])
    dk._cuda.build_all()
    versions = dict(other=other, this=dk)
    dispatches = [("main", d, "closest+nee", c) for d, c in
                  enumerate(record_dispatches({}, 4))]
    shadow = record_dispatches(SHADOW_PATH, 8)
    dispatches += [("shadow_path", i // 2,
                    "shadow" if c[1].get("any_hit") else "closest", c)
                   for i, c in enumerate(shadow)]
    rows, bad = [], 0
    for path, depth, mode, call in dispatches:
        ref = _call(dk, call)()
        counts = ref.counts.tolist()
        times = collections.defaultdict(list)
        for name in ("other", "this", "this", "other"):
            times[name].append(cuda_ms(_call(versions[name], call), 3))
        off = _call(dk, call, EARLY_OUTS_OFF)
        times["this_early_outs_off"].append(cuda_ms(off, 3))
        differ = {name: _differ(_call(mod, call)(), ref)
                  for name, mod in versions.items()}
        differ["this_early_outs_off"] = _differ(off(), ref)
        bad += sum(bool(v) for v in differ.values())
        row = dict(path=path, depth=depth, mode=mode,
                   n=call[0][1].x.shape[0], alive=counts[0],
                   nee_marched=counts[1], nee_settled=counts[2],
                   ms=dict(times), differ=differ)
        rows.append(row)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "b1_ab.json"), "w") as fh:
        json.dump(dict(device=smi, other=argv[0], rows=rows), fh, indent=1)
    print(smi)
    if bad:
        print(f"FAIL: {bad} output set(s) differ from this tree's",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
