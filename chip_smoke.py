"""Smoke run of the PyTorch port on one CUDA card: build the kernels, hold
each against its plain PyTorch twin at main-path shapes, and drive the port's
paths at 1280x720: example6 (terrain, trees, physical sky + clouds, sun)
through ``Scene.finish`` (still frames), ``Scene.run_frames`` (a moving
camera path) and the browser viewer; a full-size sky precompute; every
example scene; the explicit shadow dispatch with the bilinear sky fetch;
ReSTIR-PT with its spatial GRIS pass, the sorted route and the table draws;
the loop-construct probe; checkpoint/resume, the native runtime, the
portable traversal and multi-device rendering; and the benchmark harness
``bench_torch.py``, B1 on ``tools/trace_bench_torch.py``'s ray sets and the
still frame partitioned at dp=8 and dp=32; and example6 at full width held to
the JAX package's golden images of it, its camera path and its ReSTIR
render, and its sky computed on the card held to the JAX package's; and
every other example, and example2's ReSTIR render, held to the JAX
package's full-width golden of each; example6 at the reference's own
1920x1080 and example7's low-sun sky held to the JAX package's.

    python3 chip_smoke.py

Phases, each printing its own line: 1 device, 2 build, 3 scene set-up, 4 the
still path (64 spp at 16 samples per launch, the launch counters set to 0
just before it and read just after), 5 B1 against its twin on that path's
own four dispatches (the twin on 4 of a dispatch's 16 samples; every output
bit-equal, with the config's ``dda_sun_mode`` and with 'off', each
dispatch once under ``torch.cuda.set_sync_debug_mode("error")``; the alive
count and the NEE shadow rays marched and settled at conversion), 6 the
steady-state rate and a profiled launch (its kernel count printed), 7 B2
and B3's three entries against their twins on main-path inputs and on a
million random directions and coordinates (B3 by int32 bits), 7b kernel
S against its twin ``shade_depth_eager`` on the main path's own state at
each depth (one more launch of the main path's renderer on the eager route
a depth, ``tools/shade_kernel_torch.py`` ``run_depth``: each output by its
bits, at most 0.1% of the lanes off and by 1e-5 relative at most, the
lanes that do not trace left as they were), 7c kernel D against
``fold_in`` then ``Pcg3dDraws`` by bits on the main path's own lanes and
keys at 14,745,600 and 33,177,600 lanes, every slot 0-32, with a depth's
launch timed beside its byte bound, 7d kernel H against the eager glue of
``next_hit`` by bits on a depth-1 state of the main path at 14,745,600
and 33,177,600 lanes, a depth's two launches timed beside their byte
bound, 8 a
small-render check of the card path against the CPU
path; 9 the moving path (24 moving frames at 640x360 active, then 6 still
frames, counters set to 0 just before and read just after, B4's routes
counted over every call, frames 24 and 30 kept for phase 30), 10 B4
against its twin on the last moving frame's
own two calls, with both tap filters, and on the diffuse call with half the
frame's reprojections scattered (a sudden turn, which overflows blocks'
shared-memory boxes), every output bit-equal, 11 one moving frame's
device work under ``torch.cuda.set_sync_debug_mode("error")``, then a
profiled moving frame and its kernel count printed, 12 the viewer driven over
HTTP, 13 a small moving-path check of the card against the CPU; 14
example6 with ``nee_in_kernel=False``, ``sky_fetch='bilinear'`` and
``nee_transmittance='per_ray'``: B1's closest-hit dispatches (no NEE)
and shadow dispatches of a launch (checked as in 5, the shadow mode's
early-out being ``use_sun_open``) and every B3-family call of the launch
(the per-ray NEE fetches and the escape fetch of both maps, at the full
wavefront; int32 bits) against their twins on that path's own inputs,
five B3-family launches a launch and no eager projection kernel, its rate
beside the main path's, and small renders against the main path and the
CPU; 15 P
against its plain version for every variant, then ``tools/cuda_probe.py``'s
table; then, before phase 16 (after the sky precompute torch.profiler sees
no kernel in this process), 18 example6 with ReSTIR-PT at the JAX defaults
(32 taps, radius 24, one sample a launch): 8 spp counted, the last 4 for
the steady rate, a profiled launch and GRIS pass, and B1's GRIS revalidation
dispatch, B2's inline escape fetch at depth 1 and B3's call in the GRIS pass
on packed directions against their twins by int32 bits, the revalidation
rays' most advances held under B1's advance cap (rays at the cap written to
``chiprun_out/example6_restir_capped_rays.npz`` before the run fails); 19 the
main path with
``sort_rays=True`` and with ``rng_draws='table'``, each timed against the
default route in turns, the sorted dispatches unsorted back held bitwise to
B1 in ray order, and on each route a depth-1 B1 dispatch, B2 and B3 held to
their twins; 20 example2 (8 taps, radius 6) and example6 with ReSTIR at
128x72 on the card against the CPU path; 21
``tools/restir_quality_torch.py`` on example6 at 1280x720; 22 the main
path (64 spp at chunk 16) and ReSTIR (4 spp at chunk 1) each checkpointed
mid-run and resumed in a fresh renderer, the resumed image within 1e-6 of
the uninterrupted one, with the file's size and the save and load times; 23
``make -C native`` on a copy of ``native/`` in a temporary directory, and
when it builds, with the extension loaded from there for that phase only,
the native PNG encoder and occupancy build against the Python ones and a served viewer frame split into render,
``fetch_image``, ``to_uint8_rows`` and encode; 24 the portable traversal
``ops/dda.raytrace`` against B1 (closest hit) on one sample's 921,600
primaries, at most 1% disagreeing; 25 ``parallel_render`` and the still
frame partitioned over 'dp' (``sharded_accumulate_n``: a 16-sample launch,
a second one under ``torch.cuda.set_sync_debug_mode("error")``, a
still→moving→still sequence, ReSTIR at 32 taps for 4 spp) on the card twice
(dp=2), and on every card when there are several, every field of the
gathered state ``torch.equal`` to one device's, with wall ms, each
device's peak memory and a profiled launch beside one device's; 26
``bench_torch.py`` at its defaults (512 spp at 1280x720) in a fresh
process, its one JSON line printed here and its info dict with
``compile_s`` in its parts; 27 ``tools/trace_bench_torch.py``'s four ray
sets: B1's device ms, bound share, advance and slowest-warp statistics, and
on a sample of each set every output bit-equal to B1's twin; 28
``tools/multichip_report_torch.py``'s report at dp=8 (160-row blocks) and
dp=32 (40-row blocks, off the tile columns), and at dp=4 x sp=2 (each
block's samples over two devices, the trace gathered): two launches of
example6's still step, every field equal to one device's, halo rows and
bytes, device ms and peak memory beside one device's; 29 example6 at its
default config
(1280x720) with 16 samples in one launch through ``Scene.finish``, held to
the JAX package's CPU render of the same
(``tests/golden/torch_fullres/``) at RMSE 0.015, the examples' golden
bar; 30 phase 9's frames 24 (the last moving one) and 30 (the last still
one) held to the JAX package's CPU render of the same camera path from the
same seed (``example6_path_f24.png``, ``example6_path_f30.png``) at RMSE
0.015, with phase 9's launches (B1, B2, B3 and B4's ``temporal_taps``);
31 example6 with ReSTIR-PT at the JAX defaults, 4 spp through
``Scene.finish``, held to the JAX package's CPU render of the same
(``example6_restir_1280x720_4spp.png``) at RMSE 0.015, B1's shadow
dispatch among its launches; each of 29-31 with the share of pixels within
2/255 and the 16 worst; 32 example6's sky at ``skybox_res=128`` and every
other knob at its default, computed on the card by ``Scene.finish`` from
an empty cache, held to the JAX package's CPU sky of the same
(``example6_sky_128.npz``) at tests/test_torch_sky.py's bars with the
texels that miss split by layer, and its 16-sample image at 1280x720 held
to the same render lit by the JAX package's sky at RMSE 0.015; 33
example2 (emissive voxels, no sun) with ReSTIR-PT at the JAX defaults, 4
spp through ``Scene.finish``, held to the JAX package's CPU render of the
same (``example2_restir_1280x720_4spp.png``) at RMSE 0.015; 34 example6
at 1920x1080, one launch of 16 samples through ``Scene.finish`` and phase
9's camera path through ``Scene.run_frames``, held to the JAX package's
CPU renders of the same (``example6_1920x1080_16spp.png``,
``example6_path_1080p_f24.png``, ``..._f30.png``) at RMSE 0.015, the
960x540 moving frames' lanes in column order (the grid does not tile), with
per_spp_ms, the frames' wall ms and the peak memory, and on another still
launch's own calls B1's four dispatches (the twin on the last of the 16
samples, the highest lane indices), B2 and B3, and on the last moving
frame's two calls B4, each bit-equal to its twin; 16 example7's low-sun
sky at ``skybox_res=128`` and every other knob at its default, computed on
the card into an empty temporary cache, then found there, held to the JAX
package's CPU sky of the same (``example7_sky_128.npz``) at phase 32's
bars, and the same light at test knobs and 256x256 (four chunks, which
the card batches) on the card against the CPU; 17 every
example at its default config
(1280x720) with one launch of 16 samples, through
``tools/run_example_torch.py``'s function, each held to the JAX package's
CPU render of the same (``tests/golden/torch_fullres/
<name>_1280x720_16spp.png``, example6's phase 29's) at RMSE 0.015 with the
share within 2/255 and the
16 worst pixels, example7 and example10 lit by the JAX package's TINY_SKY
sky of each (shipped beside their goldens), and example9's primaries'
B1 dispatch held bit-equal to B1's twin on 4 of its 16 samples; then the
kernels JSON line, the card's name and power limit, and the
result line ``{"ok": true, "device": {...}}`` last. Every path is driven
with the launch counters set to 0 just before it and read just after.
Each kernel is timed twice: by CUDA events around ten calls of its Python
wrapper as the host issues them ("with wrapper"), and by the card's time
for ten calls enqueued behind a spin, so that they run back to back
(``device_ms``), which the kernels line reports as ``ms``.
Details go to ``chiprun_out/chip_smoke.json``. Any failure exits non-zero
before the result line. Without a CUDA card it exits 1 at once.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

from tools.torch_measure import (FP32_OPS_PER_S, HBM_BYTES_PER_S,
                                 b1_bound_ms, card_name, device_ms,
                                 unequal_fields)

HERE = os.path.dirname(os.path.abspath(__file__))
MAIN_SPP = 64
MAIN_SPL = 16
# The camera path of tools/camera_path_bench.py: orbit + dolly, then hold.
MOVE = {"orbit": (0.01, 0.002), "move_keys": ["w"], "dt": 0.02}
HOLD = {"dt": 0.02}
N_MOVING, N_STILL = 24, 6
B1_TWIN_SAMPLES = 4  # of a dispatch's 16 samples go through B1's slow twin
EXAMPLE_SPP = 16
# Phase 29: the JAX package's example6 at 1280x720, one launch of 16 samples
GOLDEN_DIR = os.path.join("tests", "golden", "torch_fullres")
FULLRES_GOLDEN = os.path.join(GOLDEN_DIR, "example6_1280x720_16spp.png")
FULLRES_SPL = 16
FULLRES_BAR = 0.015
# Phase 17: every example the same way, held to the JAX package's render of
# it (example6's is phase 29's golden); example7 and example10 lit by the
# JAX package's TINY_SKY sky of each, shipped beside their goldens. Phase
# 33: example2 with ReSTIR-PT at the JAX defaults, 4 spp.
EXAMPLE_SKIES = ("example7", "example10")
# scenes whose primaries' B1 dispatch phase 17 holds to B1's twin: example9's
# gap to the JAX package's CPU render is traversal (B1's two-axis normals at
# exact edge ties, which the JAX package's portable traversal does not make)
TWIN_SCENES = ("example9",)
EXAMPLE2_RESTIR_GOLDEN = os.path.join(GOLDEN_DIR,
                                      "example2_restir_1280x720_4spp.png")
# Phases 30-31: the JAX package's camera path (frames 24 and 30 of phase 9's
# path) and ReSTIR render at 1280x720, both on the port's route
PATH_GOLDENS = {n: os.path.join(GOLDEN_DIR, f"example6_path_f{n}.png")
                for n in (24, 30)}
RESTIR_GOLDEN_SPP = 4
RESTIR_GOLDEN = os.path.join(GOLDEN_DIR, "example6_restir_1280x720_4spp.png")
# Phase 34: example6 at the reference's own 1920x1080 (scene.py's default
# image_res), the still launch and the camera path as phases 29 and 30 take
# them, held to the JAX package's renders of the same
REF_RES = (1920, 1080)
REF_GOLDEN = os.path.join(GOLDEN_DIR, "example6_1920x1080_16spp.png")
REF_PATH_GOLDENS = {n: os.path.join(GOLDEN_DIR, f"example6_path_1080p_f{n}.png")
                    for n in (24, 30)}
# Phase 32: the JAX package's example6 sky at the default knobs, only
# skybox_res cut (one 16,384-texel chunk, the full sky's chunk size), and
# tests/test_torch_sky.py's bars for prepare_sky against the JAX package
SKY_GOLDEN_RES = 128
SKY_GOLDEN = os.path.join(GOLDEN_DIR, f"example6_sky_{SKY_GOLDEN_RES}.npz")
SKY_RTOL, SKY_ATOL = 2e-4, 1e-7
SKY_SHARE_BAR = 0.95
SKY_REL_RMSE_BARS = dict(scattering=6e-2, transmittance=1.5e-2)
SKY_AMBIENT_ATOL, SKY_LUT_ATOL = 1e-6, 2e-6
# Phase 16: example7's low-sun sky the same way (its own light, night
# settings), computed on the card and held to the JAX package's at these bars
SKY7_GOLDEN_RES = 128
SKY7_GOLDEN = os.path.join(GOLDEN_DIR, f"example7_sky_{SKY7_GOLDEN_RES}.npz")
# and at TINY_SKY knobs on the card against the CPU at this size: four
# 16,384-texel chunks, which the card's memory budget puts through each
# tensor op at once (the batched chunk axis with its per-chunk keys)
SKY_BATCHED_RES = 256
# Phase 18: the revalidation rays that reach B1's advance cap, kept for the
# CPU's four traversals (tests/test_torch_capped_rays.py)
CAPPED_RAYS = "example6_restir_capped_rays.npz"
RESTIR_SPP = 8  # one sample a launch on the ReSTIR path; the second half
# of them gives its steady rate (16 before phase 32 was added)
ROUTE_SPP = 32  # a timed turn of phase 19: two 16-sample launches
ROUTE_TWIN_RAYS = 230_400  # of a phase-19 dispatch go through B1's twin
TINY_SKY = dict(skybox_res=128, sky_steps=8, sky_sun_samples=2,
                sky_ms_samples=2, sky_ms_steps=2, cloud_steps=8,
                cloud_sun_samples=2, cloud_shadow_steps=2,
                cloud_accum_passes=2)  # tests/test_examples_golden.py
SHADOW_PATH = dict(nee_in_kernel=False, sky_fetch="bilinear",
                   nee_transmittance="per_ray")
# float32 and integer operations per lane and loop iteration of P's variants
# (csrc/probe.cu: 8 carry adds, the loop counter, and the construct)
PROBE_OPS = dict(base=9, orred=16, ctz=30, reduce=14, reduce2=19, rolls=24,
                 gather=17, fetch=24, cond=11, alu20=29)
# integer and float32 operations per lane of B3's entries, counted from
# csrc/texfetch.cu and csrc/sky_project.cuh (the corners about 60, a map's
# four texels 36, the projection about 75 with atan2f and acosf at about 25
# and 20 instructions, the jitter 17)
B3_OPS = dict(packed=96, dirs=171, dirs_jitter=188, dirs2=224)
# directions where the projection's branches meet: the poles with both
# zeros' signs, the azimuth seam, NaN and infinite components, zero length
EDGE_DIRS = [(0.0, 1.0, 0.0), (-0.0, -1.0, -0.0), (0.0, -1.0, -0.0),
             (-0.0, 0.5, 0.7), (0.0, 0.5, 0.7), (1e-30, 0.3, 0.7),
             (-0.0, 0.0, -0.0), (float("nan"), 0.4, 0.5),
             (0.3, float("nan"), 0.5), (float("inf"), 0.4, 0.5),
             (0.3, float("-inf"), 0.5), (0.3, 0.4, float("inf")),
             (0.0, 0.0, 0.0), (1e20, 1.0, 1.0)]


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


@contextlib.contextmanager
def render_timer(r):
    """While open, each ``r.render`` call's wall seconds, synchronised at
    both ends, go to the yielded dict's ``render_s``."""
    import torch

    timing = {}
    orig = type(r).render

    def timed(self, *a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = orig(self, *a, **k)
        torch.cuda.synchronize()
        timing["render_s"] = time.perf_counter() - t
        return out

    type(r).render = timed
    try:
        yield timing
    finally:
        type(r).render = orig


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` runs, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# The port's kernels by the names of their __global__ functions.
B1_KERNELS = ("compact_kernel", "closest_kernel", "anyhit_kernel",
              "nee_shadow_kernel")


class Recorder:
    """Wraps a module attribute to keep the arguments of its last ``keep``
    calls; ``inject`` adds keyword arguments to every call (not recorded)."""

    def __init__(self, module, name, keep=4, inject=None):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.calls = []

        def wrapper(*args, **kwargs):
            self.calls = (self.calls + [(args, kwargs)])[-keep:]
            return self.orig(*args, **kwargs, **(inject or {}))

        setattr(module, name, wrapper)

    def restore(self):
        setattr(self.module, self.name, self.orig)


def build_example(*args, **kwargs):
    """voxelrt_torch.app.examples.build_example (examples/*.py unedited)."""
    sys.path.insert(0, HERE)
    from voxelrt_torch.app.examples import build_example as build

    return build(*args, **kwargs)


class OpCounter:
    """Counts the PyTorch operators dispatched inside a ``with`` block, views
    and other operators that launch nothing left out: on the card, the eager
    kernels launched."""

    NO_KERNEL = ("view", "reshape", "expand", "unsqueeze", "squeeze", "select",
                 "slice", "alias", "permute", "transpose", "as_strided",
                 "detach", "t.", "unbind", "split", "_unsafe_view",
                 "_reshape_alias", "lift_fresh", "empty", "sym_", "numel",
                 "is_", "_local_scalar_dense")

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self
        self.count = 0
        self.names = collections.Counter()

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                name = func.__name__
                if not name.startswith(counter.NO_KERNEL):
                    counter.count += 1
                    counter.names[name.split(".")[0]] += 1
                return func(*args, **(kwargs or {}))

        self._mode = Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)


def sky_args(scene):
    """The arguments HeadlessRenderer.prepare_data gives prepare_sky."""
    r = scene.renderer
    return (np.asarray(scene._light_direction, np.float32),
            np.asarray(scene._light_color, np.float32) * r.cfg.light_weight,
            float(scene._light_cone_cos_theta_max))


def phase_sky(cache_dir):
    """Phase 16: example7's low-sun sky at ``skybox_res=SKY7_GOLDEN_RES``
    and every other knob at its default, computed on the card into the
    empty ``cache_dir`` (the second call must find it there) and held to
    the JAX package's CPU sky of the same (``SKY7_GOLDEN``) at phase 32's
    bars. Then the same light at TINY_SKY knobs and ``skybox_res =
    SKY_BATCHED_RES`` on the card and on the CPU: the card must batch
    its chunks (``chunks_per_batch`` above 1)."""
    import torch

    from voxelrt_torch.sky import atmos

    scene = build_example("example7", None, skybox_res=SKY7_GOLDEN_RES)
    cfg = scene.renderer.cfg
    args = sky_args(scene)
    with open(os.path.join(HERE, SKY7_GOLDEN[:-len(".npz")] + ".json")) as fh:
        record = json.load(fh)
    key = atmos._cache_key(cfg, *args)
    if key != record["key"]:
        fail(f"phase 16: the port keys example7's sky {key}, the golden "
             f"{record['key']}")
    if os.listdir(cache_dir) or atmos.load_sky(
            cfg, *args, "cpu", cache_dir) is not None:
        fail("phase 16 needs a sky that no cache holds")
    stats = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with OpCounter() as ops:
        # no device named: the entry point's default is the card
        sky = atmos.prepare_sky(cfg, *args, quiet=True, cache_dir=cache_dir,
                                stats=stats)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    res = cfg.skybox_res
    for name, m in (("scattering", sky.skybox_scattering),
                    ("transmittance", sky.skybox_transmittance)):
        if m.shape != (res, res, 3) or not np.isfinite(m).all():
            fail(f"sky {name} map is not finite or has the wrong shape")
        if float(m.std()) <= 1e-6:
            fail(f"sky {name} map is constant")
    hit = {}
    t0 = time.perf_counter()
    again = atmos.prepare_sky(cfg, *args, quiet=True, cache_dir=cache_dir,
                              stats=hit)
    hit_s = time.perf_counter() - t0
    if not hit.get("cache_hit") or not np.array_equal(
            again.skybox_scattering, sky.skybox_scattering):
        fail("the second prepare_sky did not load the cached sky")
    with tempfile.TemporaryDirectory() as gdir:
        shutil.copyfile(os.path.join(HERE, SKY7_GOLDEN),
                        os.path.join(gdir, f"sky_{key}.npz"))
        golden = atmos.load_sky(cfg, *args, "cpu", gdir)
    agree = sky_agreement(cfg, args, sky, golden, torch.device("cuda"))
    del sky, again, golden, scene
    torch.cuda.empty_cache()
    tiny = dataclasses.replace(cfg, **dict(TINY_SKY,
                                           skybox_res=SKY_BATCHED_RES))
    maps = {}
    tiny_s = {}
    tiny_stats = {"cuda": {}, "cpu": {}}
    for d in ("cuda", "cpu"):
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            maps[d] = atmos.prepare_sky(tiny, *args, quiet=True,
                                        cache_dir=tmp, device=d,
                                        stats=tiny_stats[d])
            tiny_s[d] = time.perf_counter() - t0
    if not tiny_stats["cuda"]["chunks_per_batch"] > 1:
        fail(f"phase 16: the card put {tiny_stats['cuda']['chunks_per_batch']}"
             f" chunk(s) of the {SKY_BATCHED_RES}^2 sky through each op")
    ok = np.ones((SKY_BATCHED_RES,) * 2, bool)
    for f in ("skybox_scattering", "skybox_transmittance"):
        ok &= np.isclose(getattr(maps["cuda"], f), getattr(maps["cpu"], f),
                         rtol=2e-4, atol=1e-7).all(-1)
    out = dict(skybox_res=res, total_s=total_s, lut_s=stats["lut_s"],
               cloud_s=stats["cloud_s"], sky_s=stats["sky_s"],
               chunks_per_batch=stats["chunks_per_batch"], peak_gb=peak_gb,
               eager_kernels=ops.count, cache_hit_s=hit_s,
               golden=SKY7_GOLDEN, key=key,
               golden_seconds_on_cpu=record["seconds"], agreement=agree,
               tiny_res=SKY_BATCHED_RES, tiny_card_s=tiny_s["cuda"],
               tiny_cpu_s=tiny_s["cpu"],
               tiny_chunks_per_batch={d: v["chunks_per_batch"]
                                      for d, v in tiny_stats.items()},
               tiny_share_outside=float(1.0 - ok.mean()))
    # Texels of the cloud layer flip on a last-bit difference (a density
    # lookup lands in the neighbouring texture cell): 2.9% of them between
    # an H100 and the CPU path since the positions are formed with one
    # rounding and the square roots correctly rounded on both (3.2% before).
    # The bar lies just above that, so that a fault in the cloud march that
    # moves a few percent of the texels fails.
    if out["tiny_share_outside"] > 0.04:
        fail("the card's sky disagrees with the CPU's")
    return out


def check_sky_bars(phase, a):
    """Fails unless ``sky_agreement``'s figures ``a`` meet phase 32's
    bars: the texel share, both relative RMSEs, the cloud ambient and the
    transmittance LUT."""
    if a["share"] < SKY_SHARE_BAR:
        fail(f"phase {phase}: {a['share']} of the sky's texels within "
             f"tolerance, under {SKY_SHARE_BAR}")
    for m, bar in SKY_REL_RMSE_BARS.items():
        if not a[f"rel_rmse_{m}"] < bar:
            fail(f"phase {phase}: the sky's {m} relative RMSE "
                 f"{a[f'rel_rmse_{m}']} is not under {bar}")
    if not (a["ambient_ok"] and a["lut_ok"]):
        fail(f"phase {phase}: the cloud ambient or the transmittance LUT is "
             "off the JAX package's")


def report_sky(out):
    """Prints phase 16's row; fails on any miss of phase 32's bars."""
    a = out["agreement"]
    print(f"sky precompute (16): example7's low-sun sky at "
          f"{out['skybox_res']}^2 and the default knobs, computed on the "
          f"card into an empty cache in {out['total_s']:.2f} s (the JAX "
          f"package on the CPU {out['golden_seconds_on_cpu']:.1f} s), "
          f"against the JAX package's ({out['golden']}): {a['share']:.6f} "
          f"of texels within rtol {SKY_RTOL} / atol {SKY_ATOL} (bar "
          f"{SKY_SHARE_BAR}; {a['missed']} miss), relative RMSE scattering "
          f"{a['rel_rmse_scattering']:.3e} (bar "
          f"{SKY_REL_RMSE_BARS['scattering']}), transmittance "
          f"{a['rel_rmse_transmittance']:.3e} (bar "
          f"{SKY_REL_RMSE_BARS['transmittance']}), cloud ambient "
          f"{a['ambient_max_abs']:.3e} apart, LUT {a['lut_max_abs']:.3e}; "
          f"the texels that miss by layer {json.dumps(a['layers'])}; "
          f"{json.dumps({k: v for k, v in out.items() if k != 'agreement'})}",
          flush=True)
    print(f"sky precompute (16): the same light at TINY_SKY knobs and "
          f"{out['tiny_res']}^2, card against CPU: "
          f"{out['tiny_share_outside']:.6f} of texels outside rtol 2e-4 / "
          f"atol 1e-7 (bar 0.04), chunks a tensor op "
          f"{json.dumps(out['tiny_chunks_per_batch'])}, card "
          f"{out['tiny_card_s']:.2f} s, CPU {out['tiny_cpu_s']:.2f} s",
          flush=True)
    check_sky_bars("16", a)


def shipped_sky(name, cache):
    """Copies the JAX package's TINY_SKY sky of example ``name``
    (``GOLDEN_DIR/<name>_sky_tiny.npz``) into ``cache`` as the
    ``sky_<key>.npz`` its record names, where ``prepare_sky`` finds it;
    returns that file's name."""
    base = os.path.join(HERE, GOLDEN_DIR, f"{name}_sky_tiny")
    with open(base + ".json") as fh:
        file = f"sky_{json.load(fh)['key']}.npz"
    shutil.copyfile(base + ".npz", os.path.join(cache, file))
    return file


def phase_examples(smi):
    """Phase 17: every example at its default config (1280x720) with one
    launch of EXAMPLE_SPP samples on the card, through
    tools/run_example_torch.py's function, each held to the JAX package's
    CPU render of the same (``GOLDEN_DIR``; example6's is phase 29's) with
    ``held_to_golden``. example6 lights its scene from the repo's shipped
    sky, example7 and example10 from the JAX package's TINY_SKY sky of
    each; an empty cache must stay so. Fails on the first scene above
    ``FULLRES_BAR``; returns the rows, each with the launches of its render
    alone (the counters set to 0 just before it, read just after)."""
    import torch

    sys.path.insert(0, os.path.join(HERE, "tools"))
    from run_example_torch import run_example

    from voxelrt_torch.app.examples import NAMES
    from voxelrt_torch.ops import _cuda
    from voxelrt_torch.render import pathtracer as pt

    rows = []
    for name in NAMES:
        over = dict(samples_per_launch=EXAMPLE_SPP)
        with tempfile.TemporaryDirectory() as cache:
            shipped = []
            if name in EXAMPLE_SKIES:
                shipped = [shipped_sky(name, cache)]
                over.update(TINY_SKY)
            rec = Recorder(pt, "raytrace", keep=4) if name in TWIN_SCENES \
                else None
            _cuda.reset_launch_counts()
            try:
                img, fig = run_example(name, None, (1280, 720), EXAMPLE_SPP,
                                       save=False, sky_cache_dir=cache,
                                       **over)
            finally:
                if rec is not None:
                    rec.restore()
            launches = {k: v for k, v in _cuda.LAUNCHES.items() if v}
            if sorted(os.listdir(cache)) != shipped:
                fail(f"{name}: the sky was recomputed, not loaded")
        if float(img.std()) <= 1e-4:
            fail(f"{name}: image is constant")
        sky = name in ("example6",) + EXAMPLE_SKIES
        for k in ("point_fetch", "bilinear_fetch_dirs"):
            if (launches.get(k, 0) > 0) != sky:
                fail(f"{name}: {k} launches {launches.get(k, 0)}, sky={sky}")
        golden = (FULLRES_GOLDEN if name == "example6" else
                  os.path.join(GOLDEN_DIR,
                               f"{name}_1280x720_{EXAMPLE_SPP}spp.png"))
        out = held_to_golden(
            f"17_{name}", img, golden, launches,
            ("traverse",) + (("point_fetch", "bilinear_fetch_dirs")
                             if sky else ()),
            smi, name=name, spp=EXAMPLE_SPP, setup_s=fig["setup_s"],
            render_s=fig["render_s"], sky=shipped[0] if shipped else None,
            mean=float(img.mean()), std=float(img.std()))
        report_golden("17", f"{name}, {EXAMPLE_SPP} spp in one launch "
                      f"(set-up {fig['setup_s']:.2f} s, render "
                      f"{fig['render_s']:.2f} s)", out)
        if rec is not None:
            # the primaries' dispatch (depth 0), the twin on
            # B1_TWIN_SAMPLES of its 16 samples
            out["b1_depth0"] = c = b1_check(rec.calls[0], chunk=1280 * 720,
                                            max_chunks=B1_TWIN_SAMPLES)
            print(f"B1 on {name}'s depth 0: {json.dumps(c)}", flush=True)
            if not c["ok"]:
                fail(f"B1 disagrees with its twin on {name}'s primaries")
            del rec
        rows.append(out)
        torch.cuda.empty_cache()
    return rows


def distinct_texels(fx, fy, res):
    """The texels a bilinear fetch at (fx, fy) reads: its four corners, by
    the twin's arithmetic (ops/texfetch.py), counted once each."""
    import torch

    fx = torch.clamp(torch.where(torch.isfinite(fx), fx, 0.0), -1.0e6, 1.0e6)
    fy = torch.clamp(torch.where(torch.isfinite(fy), fy, 0.0), -1.0e6, 1.0e6)
    ix = torch.floor(fx).to(torch.int64)
    iy = torch.floor(fy).to(torch.int64)
    tex = [torch.remainder(ix + cx, res) * res + torch.remainder(iy + cy, res)
           for cx, cy in ((0, 0), (1, 0), (0, 1), (1, 1))]
    return torch.unique(torch.cat(tex)).numel()


def b2_check(words, wid, reps=10):
    """One call of B2 against its twin, both on the card: every output word
    compared. Times: events around ``reps`` calls of the wrapper, the card's
    time a call, the twin's and ``pairs[idx]``'s (the one PyTorch call that
    computes the same); the bound from the bytes (4 B index and 8 B out a
    lane, 8 B a distinct texel)."""
    import torch

    from voxelrt_torch.ops import texfetch as tf

    n = wid.shape[0]
    a0, a1 = tf.point_fetch_words(words, wid)
    p0, p1 = tf.point_fetch_words_plain(words, wid)
    unequal = int((a0 != p0).sum().item()) + int((a1 != p1).sum().item())
    pairs = words.view(-1, 2)
    texels = torch.unique(wid).numel()
    return dict(n=n, texels=texels, unequal=unequal, ok=unequal == 0,
                ms_with_wrapper=cuda_ms(
                    lambda: tf.point_fetch_words(words, wid), reps),
                device_ms=device_ms(
                    lambda: tf.point_fetch_words(words, wid), reps),
                plain_ms=cuda_ms(
                    lambda: tf.point_fetch_words_plain(words, wid), reps),
                library_ms=cuda_ms(lambda: pairs[wid >> 1], reps),
                bound_ms=(n * (4 + 8) + texels * 8) / HBM_BYTES_PER_S * 1e3)


def b3_check(name, args, kw, reps=10):
    """One call of a B3 entry (``name``, as the wrapper is called in
    ops/texfetch.py) against its twin, both on the card: every output
    compared by its int32 bits. dirs2's twin reads the two maps' own packed
    words, so the check also holds the interleaved table. Times: events
    around ``reps`` calls of the wrapper, the card's time a call, the
    twin's; the bound from the bytes (each input once, each output once,
    each distinct texel once) and the operations (B3_OPS) of this call's
    data."""
    import torch

    from voxelrt_torch.ops import texfetch as tf

    res = args[{"bilinear_fetch_packed": 3,
                "bilinear_fetch_dirs2": 4}.get(name, 2)]
    if name == "bilinear_fetch_packed":
        coords, lane_bytes, texel_bytes = args[1:3], 8 + 12, 8
        ops = B3_OPS["packed"]
        plain = lambda: tf.bilinear_fetch_packed_plain(*args)  # noqa: E731
    elif name == "bilinear_fetch_dirs":
        u3 = args[3] if len(args) > 3 else kw.get("u3")
        coords = tf.texel_coords(args[1], res, u3)
        lane_bytes, texel_bytes = 12 + 12 * (u3 is not None) + 12, 8
        ops = B3_OPS["dirs_jitter" if u3 is not None else "dirs"]
        plain = lambda: tf.bilinear_fetch_dirs_plain(*args, **kw)  # noqa
    elif name == "bilinear_fetch_dirs2":
        d, u3 = args[3], args[5]
        coords = tf.texel_coords(d, res, u3)
        lane_bytes, texel_bytes, ops = 24 + 24, 16, B3_OPS["dirs2"]
        plain = lambda: tf.bilinear_fetch_dirs2_plain(  # noqa: E731
            args[0], args[1], d, res, u3)
    else:
        fail(f"unknown B3 entry {name}")
    fn = getattr(tf, name)

    def call():
        return fn(*args, **kw)

    k, p = call(), plain()
    k = k if isinstance(k, tuple) else (k,)
    p = p if isinstance(p, tuple) else (p,)
    unequal = sum(int((a.contiguous().view(torch.int32)
                       != b.contiguous().view(torch.int32)).sum().item())
                  for a, b in zip(k, p))
    max_err = max((a - b).abs().max().item() for a, b in zip(k, p))
    finite = all(bool(torch.isfinite(a).all().item()) for a in k)
    n = coords[0].shape[0]
    texels = distinct_texels(*coords, res)
    t_bytes = (n * lane_bytes + texels * texel_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = n * ops / FP32_OPS_PER_S * 1e3
    return dict(entry=name, n=n, texels=texels, unequal=unequal,
                max_abs_err=max_err, finite=finite,
                ok=unequal == 0 and finite,
                ms_with_wrapper=cuda_ms(call, reps),
                device_ms=device_ms(call, reps), plain_ms=cuda_ms(plain, 3),
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def phase_draws(r, sizes=((1280, 720), (1920, 1080))):
    """Phase 7c: kernel D against ``fold_in`` then ``Pcg3dDraws`` by bits on
    the main path's own lanes and keys (the wavefront of a 16-sample launch
    of ``r``'s config and the sample keys of its first launch), at each of
    ``sizes``, on ``r``'s device, for every slot the sample reads: one
    launch of all the slots, each row against the eager slot, and the
    route's launches (8 slots a depth, then ReSTIR's slot) against its
    rows. Then a depth's
    launch on the card (``device_ms``) and with its wrapper, its byte bound
    (each lane's pixel and key read once, its 8 uniforms written once) and
    the eager fold and hash of the same 8 slots."""
    import torch

    from voxelrt_torch.ops import draws_kernel, prng
    from voxelrt_torch.render import pathtracer as pt
    from voxelrt_torch.render import pipeline

    dev = r.state.color.device
    n_slots = 8 * r.cfg.max_ray_depth + 1
    ranges = [(8 * d, 8) for d in range(r.cfg.max_ray_depth)]
    ranges.append((n_slots - 1, 1))

    def bits(x):
        return x.view(torch.int32)

    out = []
    for res in sizes:
        cfg = dataclasses.replace(r.cfg, image_res=res)
        h = res[1]
        u, v, s_of_ray = pipeline.wavefront_constants(cfg, 1.0, dev)
        keys, _ = pipeline.launch_keys(
            prng.fold_in(prng.fold_in(r.key, 0), 0), cfg.samples_per_launch)
        keys = keys.to(dev)
        sk = (keys[0][s_of_ray], keys[1][s_of_ray])
        del s_of_ray
        n = u.shape[0]

        def eager(slots):
            pid = u.to(torch.int64) * h + v.to(torch.int64)
            kd = prng.fold_in(sk, pid)
            d = pt.Pcg3dDraws(kd[0], kd[1])
            return [d[s] for s in slots]

        def launch():
            return draws_kernel.pcg3d_draws(u, v, sk, h, 0, 8)

        whole = draws_kernel.pcg3d_draws(u, v, sk, h, 0, n_slots)
        slots_differ = [s for s, e in enumerate(eager(range(n_slots)))
                        if not torch.equal(bits(whole[s]), bits(e))]
        ranges_differ = [
            [lo, k] for lo, k in ranges
            if not torch.equal(bits(draws_kernel.pcg3d_draws(u, v, sk, h, lo,
                                                             k)),
                               bits(whole[lo:lo + k]))]
        del whole
        ms = device_ms(launch, 10)
        bound_ms = n * (8 + 16 + 4 * 8) / HBM_BYTES_PER_S * 1e3
        out.append(dict(
            res=f"{res[0]}x{res[1]}", lanes=n, slots=n_slots,
            slots_differ=slots_differ, ranges_differ=ranges_differ,
            device_ms=ms, ms_with_wrapper=cuda_ms(launch, 10),
            bound_ms=bound_ms, bound_by="bytes",
            roofline_pct=100.0 * bound_ms / ms,
            eager_ms=cuda_ms(lambda: eager(range(8)), 3),
            ok=not slots_differ and not ranges_differ))
        del u, v, sk, keys
        torch.cuda.empty_cache()
    return out


def phase_hit(r, sizes=(14_745_600, 33_177_600)):
    """Phase 7d: kernel H against the eager glue of ``next_hit`` by bits on
    a depth-1 state of the main path: the closest-hit call of depth 1 in
    one launch of ``r`` (its rays, mask and NEE arguments, copied as the
    call was made), at each lane count of ``sizes``: the launch's own
    14,745,600 lanes, and for more the state's lanes repeated. At each
    count: B1's inputs (``hit_prepare`` against ``hit_prepare_eager``) and
    the whole call (the Hit and the NEE verdicts) on both routes, by their
    bits; a depth's two launches on the card (``device_ms``, the merge on
    B1's outputs of the same call), their byte bound
    (``benchmark/metrics/hit_bytes.py``, from the call's alive lanes) and
    the eager glue of the same call less B1."""
    import math

    import torch

    from benchmark.metrics.hit_bytes import launch_bytes
    from voxelrt_torch.ops import hit_kernel, prng
    from voxelrt_torch.ops.v3 import V3
    from voxelrt_torch.render import pathtracer as pt
    from voxelrt_torch.render import pipeline

    calls = []  # the launch's closest-hit calls, one a depth: depth 1's kept
    next_hit = pt.next_hit

    def keep(cfg, scene, params, pos, d, mask, *a, **kw):
        if not kw.get("shadow_ray"):
            calls.append((cfg, scene, params, V3(*(c.clone() for c in pos)),
                          V3(*(c.clone() for c in d)), mask.clone(), kw)
                         if len(calls) == 1 else None)
        return next_hit(cfg, scene, params, pos, d, mask, *a, **kw)

    pt.next_hit = keep
    try:
        pipeline.accumulate(r.cfg, r.scene_data, r._params(1e9), r.state,
                            prng.key(11))
    finally:
        pt.next_hit = next_hit
    cfg, scene, params, pos0, d0, mask0, kw0 = calls[1]
    del calls

    def bits(x):
        return x.view(torch.int32) if x.is_floating_point() else x

    def flat(x):
        for c in x:
            if isinstance(c, (tuple, list)):
                yield from flat(c)
            elif c is not None:
                yield c

    out = []
    for m in sizes:
        def rep(x):
            return x.repeat(math.ceil(m / x.shape[0]))[:m].contiguous()

        pos, d = V3(*map(rep, pos0)), V3(*map(rep, d0))
        mask = rep(mask0)
        kw = dict(kw0, nee_u=tuple(map(rep, kw0["nee_u"])))
        inputs_differ = sum(
            not torch.equal(bits(a), bits(b)) for a, b in zip(
                flat(hit_kernel.hit_prepare(cfg, params, pos, d, mask, True)),
                flat(pt.hit_prepare_eager(cfg, params, pos, d, mask, True))))
        kept = {}
        raytrace = pt.raytrace

        def keep_tr(*a, **k):
            kept["tr"] = tr_ = raytrace(*a, **k)
            return tr_

        pt.raytrace = keep_tr
        try:
            got = pt.next_hit(cfg, scene, params, pos, d, mask, **kw)
        finally:
            pt.raytrace = raytrace
        tr = kept.pop("tr")
        applies = hit_kernel.hit_kernel_applies
        hit_kernel.hit_kernel_applies = lambda c, dv: False
        try:
            want = pt.next_hit(cfg, scene, params, pos, d, mask, **kw)
        finally:
            hit_kernel.hit_kernel_applies = applies
        fields_differ = sum(not torch.equal(bits(a), bits(b))
                            for a, b in zip(flat(got), flat(want)))
        del got, want

        def eager():
            floor = pt.floor_plane(params, pos, d, mask)
            pt.hit_prepare_eager(cfg, params, pos, d, mask, True, floor)
            pt.hit_merge_eager(cfg, params, pos, d, mask, tr, floor)

        prepare_ms = device_ms(
            lambda: hit_kernel.hit_prepare(cfg, params, pos, d, mask, True),
            10)
        merge_ms = device_ms(
            lambda: hit_kernel.hit_merge(cfg, params, pos, d, mask, tr), 10)
        alive = int(mask.sum())
        bound_ms = (launch_bytes(m, alive, "prepare", True)
                    + launch_bytes(m, alive, "merge", True)
                    ) / HBM_BYTES_PER_S * 1e3
        out.append(dict(
            lanes=m, alive=alive, inputs_differ=inputs_differ,
            fields_differ=fields_differ, prepare_ms=prepare_ms,
            merge_ms=merge_ms, device_ms=prepare_ms + merge_ms,
            bound_ms=bound_ms, bound_by="bytes",
            roofline_pct=100.0 * bound_ms / (prepare_ms + merge_ms),
            eager_ms=cuda_ms(eager, 3),
            ok=inputs_differ == 0 and fields_differ == 0))
        del pos, d, mask, kw, tr
        torch.cuda.empty_cache()
    return out


def phase_shadow_path(main_steady_ms):
    """Phase 14: example6 at 1280x720, 16 samples per launch, with the
    explicit sun-shadow dispatch, the bilinear sky fetch and the per-ray NEE
    transmittance (SHADOW_PATH)."""
    import torch

    from voxelrt_torch.ops import _cuda
    from voxelrt_torch.render import pathtracer as pt
    from voxelrt_torch.sky import atmos

    scene = build_example("example6", None, samples_per_launch=MAIN_SPL,
                          **SHADOW_PATH)
    r = scene.renderer
    r.prepare_data()
    depth = r.cfg.max_ray_depth
    rec_b1 = Recorder(pt, "raytrace", keep=8)
    # every B3-family call of the last launch: the per-ray NEE fetch at each
    # depth, then the escape fetch of both maps
    rec_b3 = [Recorder(atmos, "bilinear_fetch_dirs", keep=depth),
              Recorder(atmos, "bilinear_fetch_dirs2", keep=1)]
    _cuda.reset_launch_counts()
    torch.cuda.synchronize()
    img = r.render(spp=MAIN_SPL)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.render(spp=2 * MAIN_SPL)
    torch.cuda.synchronize()
    steady_ms = (time.perf_counter() - t0) / (2 * MAIN_SPL) * 1e3
    launches = dict(_cuda.LAUNCHES)
    rec_b1.restore()
    for rec in rec_b3:
        rec.restore()
    w, h = r.cfg.image_res
    if img.shape != (w, h, 3) or not np.isfinite(img).all() or \
            float(img.std()) <= 1e-4:
        fail("shadow path: image is not finite, constant or misshaped")
    n_launch = 3
    want = dict(traverse=2 * depth * n_launch, traverse_shadow=depth * n_launch,
                traverse_compact=2 * depth * n_launch, traverse_nee=0,
                bilinear_fetch=0, bilinear_fetch_dirs=depth * n_launch,
                bilinear_fetch_dirs2=n_launch, point_fetch=0)
    for k, v in want.items():
        if launches[k] != v:
            fail(f"shadow path: {launches[k]} {k} launches, expected {v}")
    print(f"shadow path: example6 {w}x{h}, {json.dumps(SHADOW_PATH)}, "
          f"samples_per_launch={MAIN_SPL}, steady per_spp_ms {steady_ms:.3f} "
          f"(main path in this run: {main_steady_ms:.3f}), launches "
          f"{launches}", flush=True)
    # the last launch's dispatches: per depth a closest-hit one without NEE,
    # then a shadow-mode one
    calls = rec_b1.calls
    if len(calls) != 2 * depth or \
            sum(bool(c[1].get("any_hit")) for c in calls) != depth:
        fail("shadow path: the B1 dispatches were not recorded")
    b1 = dict(closest=[], shadow=[])
    for call in calls:
        mode = "shadow" if call[1].get("any_hit") else "closest"
        d = len(b1[mode])
        c = b1_check(call, chunk=w * h, max_chunks=B1_TWIN_SAMPLES)
        b1[mode].append(c)
        print(f"B1 {mode} depth {d}: {json.dumps(c)}", flush=True)
        if not c["ok"]:
            fail(f"B1's {mode} dispatch at depth {d} disagrees with its twin")
    del rec_b1, calls
    calls = [("bilinear_fetch_dirs", c) for c in rec_b3[0].calls] + [
        ("bilinear_fetch_dirs2", c) for c in rec_b3[1].calls]
    if len(calls) != depth + 1:
        fail("shadow path: the B3-family calls were not recorded")
    b3 = []
    for i, (name, (args, kw)) in enumerate(calls):
        c = b3_check(name, args, kw)
        c["call"] = (f"per-ray NEE, depth {i}" if i < depth
                     else "escape fetch, both maps")
        b3.append(c)
        print(f"B3 at the shadow path's wavefront, {c['call']}: "
              f"{json.dumps(c)}", flush=True)
        if c["n"] != MAIN_SPL * w * h or not c["ok"]:
            fail(f"B3 ({c['call']}) is not bit-equal to its twin")
    del rec_b3, calls
    b3_per_launch = (launches["bilinear_fetch_dirs"]
                     + launches["bilinear_fetch_dirs2"]) / n_launch
    # one more launch with every PyTorch operator counted by name: the sky's
    # projection runs in the kernels, so no eager atan2 or acos may run
    with OpCounter() as ops:
        r.render(spp=MAIN_SPL)
    torch.cuda.synchronize()
    projection_ops = {k: ops.names[k] for k in ("atan2", "acos")}
    print(f"shadow path: {b3_per_launch:g} B3-family launches a launch; one "
          f"launch dispatches {ops.count} eager operators, the projection's "
          f"atan2/acos among them {projection_ops}", flush=True)
    if any(projection_ops.values()):
        fail("shadow path: the sky projection ran as eager kernels")
    del r, scene
    torch.cuda.empty_cache()
    # small renders from one seed: the explicit dispatch against in-kernel
    # NEE (same estimator, stochastic sky), and the whole path on the card
    # against the CPU
    def small(device, **over):
        s = build_example("example6", device, (128, 72), samples_per_launch=2,
                          **over)
        return s.finish(spp=4, save=False)

    def rmse(a, b):
        return float(np.sqrt(np.mean((a - b) ** 2)))

    explicit = rmse(small("cuda", nee_in_kernel=False), small("cuda"))
    card_cpu = rmse(small("cuda", **SHADOW_PATH), small("cpu", **SHADOW_PATH))
    print(f"small renders (example6 128x72, 4 spp): explicit shadow dispatch "
          f"vs in-kernel NEE RMSE {explicit:.3e}; shadow path card vs CPU "
          f"RMSE {card_cpu:.3e}", flush=True)
    if not explicit < 1e-4 or not card_cpu < 1e-4:
        fail("the shadow path's small renders disagree")
    return dict(steady_per_spp_ms=steady_ms, launches=launches,
                b1_closest=b1["closest"], b1_shadow=b1["shadow"], b3=b3,
                b3_per_launch=b3_per_launch, launch_eager_ops=ops.count,
                explicit_vs_in_kernel_rmse=explicit,
                card_vs_cpu_rmse=card_cpu)


def device_events(p):
    """(name, ms) of every event the card ran in the finished profiler
    session ``p``, read from the raw trace: ``key_averages()`` builds the
    whole event tree first, which takes tens of seconds at a ReSTIR
    launch's 130,000 kernels."""
    import torch

    return [(e.name(), e.duration_ns() / 1e6)
            for e in p.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation()]


def profile_call(fn):
    """Device time and kernel count of one call of ``fn``, which has run
    before, from torch.profiler tracing the card's activity only, and the
    traced call's wall ms. A session with no kernel events is taken again,
    up to three times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        events = device_events(p)
        if events:
            break
    return dict(device_ms=sum(t for _, t in events), kernels=len(events),
                traced_wall_ms=wall_ms)


def phase_restir(main_steady_ms):
    """Phase 18: example6 at 1280x720 with ReSTIR-PT at the JAX defaults (32
    taps, radius 24, one sample a launch), its shipped sky: RESTIR_SPP spp
    through the renderer in two calls of half as many (the second gives the
    steady rate) with the launch counters set to 0 just before and read just
    after, a profiled launch and a profiled GRIS pass on the last launch's
    inputs; then, on the last launch's recorded inputs, B1's GRIS
    revalidation dispatch (shadow mode, no sun-open early-out, one ray a
    pixel), B2's inline escape fetch at depth 1 and B3's call in
    ``restir.shift_source`` (the stored NEE directions of every pixel, read
    as strided views of a packed (n, 3) tensor) against their twins by
    int32 bits."""
    import torch

    from voxelrt_torch.ops import _cuda
    from voxelrt_torch.render import pathtracer as pt
    from voxelrt_torch.render import restir as rs
    from voxelrt_torch.sky import atmos

    scene = build_example("example6", None, use_restir_pt=True)
    r = scene.renderer
    r.prepare_data()
    cfg = r.cfg
    if (cfg.restir_taps, cfg.restir_radius, cfg.samples_per_launch) != (
            32, 24.0, 1):
        fail("the ReSTIR path does not run at the JAX defaults")
    w, h = cfg.image_res
    depth, taps = cfg.max_ray_depth, cfg.restir_taps
    # a launch: the primaries, a sun-shadow dispatch a depth, the bounces'
    # closest hits, then the revalidation; B3: the per-ray NEE fetch a depth
    # and the NEE sample's, then the GRIS pass's one on the stored NEE
    # directions
    per_launch_b1 = 2 * depth + 1
    rec_b1 = Recorder(pt, "raytrace", keep=per_launch_b1)
    rec_b2 = Recorder(atmos, "point_fetch_words", keep=2 * depth)
    rec_b3 = Recorder(atmos, "bilinear_fetch_dirs", keep=1)
    rec_gris = Recorder(rs, "spatial_gris", keep=1)
    _cuda.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.render(spp=RESTIR_SPP // 2)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    img = r.render(spp=RESTIR_SPP // 2)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    first_ms = (t2 - t0) / RESTIR_SPP * 1e3
    steady_ms = (t2 - t1) / (RESTIR_SPP // 2) * 1e3
    launches = dict(_cuda.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for rec in (rec_b1, rec_b2, rec_b3, rec_gris):
        rec.restore()
    if img.shape != (w, h, 3) or not np.isfinite(img).all() or \
            float(img.std()) <= 1e-4:
        fail("ReSTIR path: image is not finite, constant or misshaped")
    n_launch = RESTIR_SPP
    want = dict(traverse=per_launch_b1 * n_launch,
                traverse_compact=per_launch_b1 * n_launch,
                traverse_shadow=(depth + 1) * n_launch, traverse_nee=0,
                point_fetch=2 * depth * n_launch, bilinear_fetch=0,
                bilinear_fetch_dirs=(depth + 2) * n_launch,
                bilinear_fetch_dirs2=0)
    for k, v in want.items():
        if launches[k] != v:
            fail(f"ReSTIR path: {launches[k]} {k} launches, expected {v}")
    # the GRIS pass by events before any profiling, as the launches were
    gargs, gkw = rec_gris.calls[-1]
    gris_ms = cuda_ms(lambda: rs.spatial_gris(*gargs, **gkw), 1)
    prof = profile_launch(r, steady_ms)
    gris_prof = profile_call(lambda: rs.spatial_gris(*gargs, **gkw))
    print(f"ReSTIR path: example6 {w}x{h}, {taps} taps radius "
          f"{cfg.restir_radius}, one sample a launch: per_spp_ms "
          f"{first_ms:.3f} over the first {RESTIR_SPP} spp, {steady_ms:.3f} "
          f"over the last {RESTIR_SPP // 2} (main path in this run: {main_steady_ms:.3f}), peak "
          f"{peak_gb:.2f} GB, launches {launches}; profiled launch: "
          f"{json.dumps(prof)}; GRIS pass: {gris_ms:.3f} ms by events, "
          f"{json.dumps(gris_prof)}", flush=True)
    if prof["by_group_ms"]["traverse_kernel"] <= 0.0:
        fail("the profiled ReSTIR launch shows no B1 device time")
    del rec_gris

    calls = rec_b1.calls
    args, kw = calls[-1]
    if not (kw.get("any_hit") and not kw.get("use_sun_open")
            and args[1].x.shape[0] == w * h):
        fail("ReSTIR path: the last B1 dispatch is not the revalidation")
    reval = b1_check(calls[-1], chunk=w * h)
    print(f"B1 GRIS revalidation: {json.dumps(reval)}", flush=True)
    print(f"B1 GRIS revalidation: most advances of a ray "
          f"{reval['most_advances_of_a_ray']} of {reval['n']}, B1's cap "
          f"{reval['advance_cap']}", flush=True)
    if not reval["ok"]:
        fail("B1's revalidation dispatch disagrees with its twin")
    # its empty samples' zero-direction rays are misses short of the cap
    # (ROADMAP.md §3 item 7); rays at the cap are written out for the CPU's
    # four traversals before the run fails
    if not reval["most_advances_of_a_ray"] < reval["advance_cap"]:
        n_capped = write_capped_rays(calls[-1], w * h, gargs, gkw)
        fail(f"{n_capped} revalidation rays ran to B1's advance cap; "
             f"written to chiprun_out/{CAPPED_RAYS}")
    del rec_b1, calls, args, kw, gargs, gkw
    # the depth-1 escape fetch's scattering words
    b2 = b2_check(*rec_b2.calls[2][0])
    print(f"B2 inline escape fetch at depth 1: {json.dumps(b2)}", flush=True)
    if not b2["ok"] or b2["n"] != w * h:
        fail("B2's inline fetch disagrees with its twin")
    del rec_b2
    (tab, d, res), kw = rec_b3.calls[-1]
    if d.x.stride(0) != 3 or d.x.shape[0] != w * h:
        fail("ReSTIR path: the last B3 call is not the GRIS pass's packed "
             "one")
    b3 = b3_check("bilinear_fetch_dirs", (tab, d, res), kw)
    print(f"B3 in the GRIS pass, packed directions: {json.dumps(b3)}",
          flush=True)
    if not b3["ok"]:
        fail("B3 in the GRIS pass is not bit-equal to its twin")
    del rec_b3, tab, d, r, scene
    torch.cuda.empty_cache()
    return dict(first_per_spp_ms=first_ms, steady_per_spp_ms=steady_ms,
                peak_gb=peak_gb, launches=launches, profile=prof,
                gris_ms=gris_ms, gris_profile=gris_prof, b1=reval, b2=b2,
                b3=b3)


def write_capped_rays(rec_args, chunk, gargs, gkw):
    """Writes the rays of the recorded revalidation dispatch ``rec_args``
    whose advances reached B1's cap (``capped_rays``), each with whether
    its sample is an escape (``revalidation_escapes`` on the GRIS pass
    ``spatial_gris(*gargs, **gkw)``), to ``chiprun_out/CAPPED_RAYS``;
    returns their count."""
    escape = revalidation_escapes(gargs, gkw, rec_args[0])
    capped = b1_check(rec_args, chunk=chunk, capture=True)["capped"]
    capped["escape"] = escape[capped["index"]].astype(np.uint8)
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    np.savez_compressed(os.path.join(HERE, "chiprun_out", CAPPED_RAYS),
                        **capped)
    return int(capped["index"].size)


def revalidation_escapes(gargs, gkw, b1_args):
    """Reruns the GRIS pass ``spatial_gris(*gargs, **gkw)`` and returns,
    per pixel as numpy bools, whether the sample its visibility
    revalidation traces towards is an escape (``rc_normal`` zero: the
    ``escape`` mask the pass computes just before that dispatch, whose
    ``occluded`` test then cannot fire). The rerun's revalidation rays
    must be ``b1_args``' own, the recorded dispatch's."""
    import torch

    from voxelrt_torch.render import pathtracer as pt
    from voxelrt_torch.render import restir as rs

    seen = dict(zero=None, escape=None, rays=None)
    is_zero, next_hit, raytrace = rs._is_zero3, pt.next_hit, pt.raytrace

    def zero(a):
        seen["zero"] = out = is_zero(a)
        return out

    def hit(*a, shadow_ray=False, **k):
        if shadow_ray:
            seen["escape"] = seen["zero"]
        return next_hit(*a, shadow_ray=shadow_ray, **k)

    def trace(*a, **k):
        if k.get("any_hit") and not k.get("use_sun_open"):
            seen["rays"] = (a[1], a[2])
        return raytrace(*a, **k)

    rs._is_zero3, pt.next_hit, pt.raytrace = zero, hit, trace
    try:
        rs.spatial_gris(*gargs, **gkw)
    finally:
        rs._is_zero3, pt.next_hit, pt.raytrace = is_zero, next_hit, raytrace
    if seen["escape"] is None or seen["rays"] is None or not all(
            torch.equal(a, b) for x, y in zip(seen["rays"], b1_args[1:3])
            for a, b in zip(x, y)):
        fail("ReSTIR path: the GRIS pass's rerun did not trace the "
             "recorded revalidation rays")
    return seen["escape"].cpu().numpy()


def phase_routes():
    """Phase 19: example6's main path (16 samples a launch) with
    ``sort_rays=True`` and with ``rng_draws='table'``, each against the
    default route in turns (default, other, other, default), ROUTE_SPP spp a
    turn after a warm-up launch whose launches are counted. The sorted
    route's recorded dispatches, unsorted back, must equal bitwise the
    dispatch that ``next_hit`` makes in ray order (its unsorted branch's
    arguments); on each route one B1 dispatch at depth 1 (its first
    ROUTE_TWIN_RAYS rays through the slow twin), B2's call and B3's
    cone-centre call are held to their twins."""
    import torch

    from voxelrt_torch.ops import _cuda
    from voxelrt_torch.ops import dda_kernel as dk
    from voxelrt_torch.render import pathtracer as pt
    from voxelrt_torch.sky import atmos

    routes = {}
    scenes = {}
    for tag, over in (("default", {}), ("sort_rays", dict(sort_rays=True)),
                      ("table", dict(rng_draws="table"))):
        s = build_example("example6", None, samples_per_launch=MAIN_SPL,
                          **over)
        s.renderer.prepare_data()
        scenes[tag] = s
    for tag in ("sort_rays", "table"):
        r = scenes[tag].renderer
        rec_b1 = Recorder(pt, "raytrace", keep=8)
        rec_sorted = Recorder(pt, "_trace_voxels_sorted", keep=7)
        rec_b2 = Recorder(atmos, "point_fetch_words", keep=1)
        rec_b3 = Recorder(atmos, "bilinear_fetch_dirs", keep=1)
        _cuda.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        img = r.render(spp=MAIN_SPL)
        torch.cuda.synchronize()
        launches = dict(_cuda.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        for rec in (rec_b1, rec_sorted, rec_b2, rec_b3):
            rec.restore()
        if not np.isfinite(img).all() or float(img.std()) <= 1e-4:
            fail(f"{tag}: image is not finite or constant")
        depth = r.cfg.max_ray_depth
        sort = tag == "sort_rays"
        # the sorted route shades eagerly (B3's cone centre at each depth),
        # the table route through the shade kernel (B3's once a launch)
        want = dict(traverse=2 * depth if sort else depth,
                    traverse_shadow=depth if sort else 0,
                    traverse_nee=0 if sort else depth, point_fetch=1,
                    bilinear_fetch_dirs=depth + 1 if sort else 2,
                    shade=0 if sort else depth)
        for k, v in want.items():
            if launches[k] != v:
                fail(f"{tag}: {launches[k]} {k} launches, expected {v}")
        out = dict(launches=launches, peak_gb=peak_gb)
        if sort:
            if len(rec_sorted.calls) != 2 * depth - 1:
                fail("sort_rays: the sorted dispatches were not recorded")
            bad = 0
            for (cfg, tables, o, d, mask, shadow, sun), _ in rec_sorted.calls:
                a = pt._trace_voxels_sorted(cfg, tables, o, d, mask, shadow,
                                            sun)
                # next_hit's unsorted branch, as it calls B1
                b = dk.raytrace(tables, o, d, pt.EPS,
                                torch.where(mask, pt.INF, 0.0),
                                cfg.max_dda_advances, alive=mask,
                                any_hit=shadow, fetch_colors=not shadow,
                                use_sun_open=sun, sun_mode=cfg.dda_sun_mode,
                                nee_src_open=cfg.dda_nee_src_open == "on")
                bad += int(_b1_differs(a, b).sum().item())
            out["unsorted_back_mismatched"] = bad
            print(f"sort_rays: {len(rec_sorted.calls)} sorted dispatches of "
                  f"the last launch, unsorted back against next_hit's "
                  f"dispatch in ray order: "
                  f"{bad} rays differ", flush=True)
            if bad:
                fail("the sorted route's outputs differ from ray order")
        del rec_sorted
        # depth 1's closest-hit dispatch: the third of a sorted launch's
        # (after the primaries' and depth 0's shadow), the second of a
        # table launch's
        c = b1_check(rec_b1.calls[2 if sort else 1], chunk=ROUTE_TWIN_RAYS,
                     max_chunks=1)
        out["b1_depth1"] = c
        out["b2"] = b2_check(*rec_b2.calls[-1][0])
        out["b3"] = b3_check("bilinear_fetch_dirs", *rec_b3.calls[-1])
        print(f"{tag}: launches {launches}, peak {peak_gb:.2f} GB; B1 depth "
              f"1 {json.dumps(c)}; B2 {json.dumps(out['b2'])}; B3 "
              f"{json.dumps(out['b3'])}", flush=True)
        if not (c["ok"] and out["b2"]["ok"] and out["b3"]["ok"]):
            fail(f"{tag}: a kernel call disagrees with its twin")
        del rec_b1, rec_b2, rec_b3
        routes[tag] = out
    scenes["default"].renderer.render(spp=MAIN_SPL)  # its warm-up launch

    def turn(tag):
        r = scenes[tag].renderer
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.render(spp=ROUTE_SPP)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / ROUTE_SPP * 1e3

    ab = {}
    for tag in ("sort_rays", "table"):
        ab[tag] = [(t, turn(t)) for t in ("default", tag, tag, "default")]
        print(f"A/B per_spp_ms, {tag} against the default route in turns: "
              f"{ab[tag]}", flush=True)
    del scenes
    torch.cuda.empty_cache()
    return dict(routes=routes, ab_per_spp_ms=ab)


def phase_restir_small():
    """Phase 20: example2 with ReSTIR at the golden test's 8 taps of radius
    6 (example2_restir of tests/test_examples_golden.py, at 4 spp where the
    golden takes 16: tests/test_torch_examples.py holds the CPU path at 16
    against the golden) and example6 with ReSTIR at the defaults (1 spp), at
    128x72, on the card and on the port's CPU path."""
    rows = {}
    for name, spp, over in (
            ("example2", 4, dict(restir_taps=8, restir_radius=6.0)),
            ("example6", 1, {})):
        imgs = {}
        for dev in ("cuda", "cpu"):
            s = build_example(name, dev, (128, 72), use_restir_pt=True,
                              **over)
            imgs[dev] = s.finish(spp=spp, save=False)
        rmse = float(np.sqrt(np.mean((imgs["cuda"] - imgs["cpu"]) ** 2)))
        far = float((np.abs(imgs["cuda"] - imgs["cpu"]) > 1e-2).any(-1)
                    .mean())
        rows[name] = dict(spp=spp, rmse=rmse, share_beyond_1e_2=far)
        print(f"small ReSTIR render ({name} 128x72, {spp} spp): card vs CPU "
              f"path RMSE {rmse:.3e}, {far:.5f} of pixels beyond 1e-2",
              flush=True)
        # The two run the same operations and differ in float32 last bits,
        # which a weighted selection can turn into another sample for a
        # pixel: at most 0.1% of the pixels may differ beyond 1e-2 (a
        # tenth of the tests' 1% share against the JAX package), and the
        # RMSE stays below 5e-3, a third of the golden bar.
        if not np.isfinite(imgs["cuda"]).all() or far > 1e-3 or \
                not rmse < 5e-3:
            fail(f"{name} with ReSTIR: the card disagrees with the CPU path")
    return rows


def phase_restir_quality():
    """Phase 21: tools/restir_quality_torch.py on example6 at 1280x720 (a
    256-spp reference, ReSTIR off and on at 1, 2 and 4 spp)."""
    sys.path.insert(0, os.path.join(HERE, "tools"))
    import restir_quality_torch as rq

    rows = rq.quality_rows("example6", (1280, 720), 256, [1, 2, 4])
    for row in rows:
        print(f"ReSTIR quality, example6 1280x720: {json.dumps(row)}",
              flush=True)
        if not all(np.isfinite(v) for v in row.values()) or \
                row["rmse_plain"] <= 0.0 or row["rmse_restir"] <= 0.0:
            fail("ReSTIR quality: a row is not finite")
    return rows


def phase_probe():
    """Phase 15: P against its plain version for every variant at two
    iteration counts, then tools/cuda_probe.py's measurement."""
    import torch

    sys.path.insert(0, os.path.join(HERE, "tools"))
    import cuda_probe

    from voxelrt_torch.ops import _cuda
    from voxelrt_torch.ops import probe as pr

    dev = torch.device("cuda")
    n_blocks, check_iters = 512, (16, 64)
    x, tab = cuda_probe.probe_inputs(n_blocks, 0, dev, x_scale=2048.0)
    checks = {}
    for v in pr.VARIANTS:
        worst = worst_abs = 0.0
        for it in check_iters:
            ko, ka = pr.probe(x, tab, v, it)
            po, pa = pr.probe_plain(x, tab, v, it)
            for a, b in ((ko, po), (ka, pa)):
                rel = ((a - b).abs() / b.abs().clamp(min=1e-30)).max().item()
                worst = max(worst, rel)
                worst_abs = max(worst_abs, (a - b).abs().max().item())
                exact = v != "alu20"
                if (exact and not torch.equal(a, b)) or rel > 1e-6:
                    fail(f"P[{v}] at {it} iterations disagrees with its "
                         f"plain version (max relative error {rel:.3e})")
        it = check_iters[1]
        ops = n_blocks * 1024 * it * PROBE_OPS[v]
        nbytes = n_blocks * 1024 * 4 * 3 + tab.numel() * 4
        t_ops = ops / FP32_OPS_PER_S * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        checks[v] = dict(
            iters=it, max_rel_err=worst, max_abs_err=worst_abs,
            ms_with_wrapper=cuda_ms(lambda: pr.probe(x, tab, v, it), 10),
            device_ms=device_ms(lambda: pr.probe(x, tab, v, it), 10),
            plain_ms=cuda_ms(lambda: pr.probe_plain(x, tab, v, it), 1),
            bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes")
    _cuda.reset_launch_counts()
    table = cuda_probe.run_probe(pr.VARIANTS, n_blocks=n_blocks, trials=3)
    launches = _cuda.LAUNCHES["probe"]
    if launches <= 0:
        fail("the probe's entry point launched no kernel")
    for v, f in table.items():
        if not (f["ms_hi"] > f["ms_lo"] > 0.0):
            fail(f"P[{v}]: times do not grow with the iteration count")
        print(f"P {v:8s} equal to plain (max rel err "
              f"{checks[v]['max_rel_err']:.1e}); {checks[v]['device_ms']:.4f} "
              f"ms at {checks[v]['iters']} iterations on the device, "
              f"{checks[v]['ms_with_wrapper']:.4f} with the wrapper (plain "
              f"{checks[v]['plain_ms']:.1f} ms); "
              f"{f['ns_per_iter_per_block']:.3f} ns/iter/block over "
              f"{f['blocks']} blocks, loop {f['loop_ns_per_iter']:.1f} "
              f"ns/iter at one block per multiprocessor", flush=True)
    return dict(checks=checks, table=table, launches=launches,
                n_blocks=n_blocks)


def _ray_slice(x, n, lo, hi):
    """Rays lo:hi of one recorded B1 argument (per-ray tensors, the V3s of
    them and the NEE dict); launch scalars pass through."""
    import torch

    from voxelrt_torch.ops.v3 import V3

    if isinstance(x, V3):
        return V3(*(_ray_slice(c, n, lo, hi) for c in x))
    if isinstance(x, dict):
        return {k: _ray_slice(v, n, lo, hi) for k, v in x.items()}
    if isinstance(x, torch.Tensor) and x.dim() == 1 and x.shape[0] == n:
        return x[lo:hi]
    return x


def _b1_differs(a, b, lo=0):
    """Per-ray mask over ``b``'s rays: where rays lo: of result ``a`` and
    result ``b`` differ in any output both return (inf equals inf)."""
    hi = lo + b.distance.shape[0]
    bad = a.distance[lo:hi] != b.distance
    for f in ("iters", "color_word", "active", "nee_visible"):
        x, y = getattr(a, f), getattr(b, f)
        if x is not None and y is not None:
            bad |= x[lo:hi] != y
    if a.ipos is not None and b.ipos is not None:
        for x, y in zip((*a.ipos, *a.normal), (*b.ipos, *b.normal)):
            bad |= x[lo:hi] != y
    return bad


class AdvanceTally:
    """Inside a ``with`` block, sums the advances of every march the twin
    runs (``dda_kernel._run``), in call order: within one twin call the
    primaries' march comes first, then the NEE shadow rays' if any; and
    keeps the most advances any one ray took, and the final state of each
    march (``states``)."""

    def __enter__(self):
        from voxelrt_torch.ops import dda_kernel as dk

        self.dk, self.orig, self.sums, self.most = dk, dk._run, [], 0
        self.states = []

        def run(*a, **k):
            st = self.orig(*a, **k)
            self.sums.append(int(st["adv"].sum().item()))
            self.states.append(st)
            if st["adv"].numel():
                self.most = max(self.most, int(st["adv"].max().item()))
            return st

        dk._run = run
        return self

    def __exit__(self, *exc):
        self.dk._run = self.orig


def capped_rays(args, kw, k, st, lo, cap):
    """The rays of one twin chunk (``st``: the final state of its
    primaries' march, rays ``lo:`` of the dispatch) whose advances reached
    ``cap``: index, grid-space origin and direction, ``tmin``, ``tmax`` and
    the ``alive`` byte as the dispatch was given them, the kernel's
    ``distance``, and the twin's final state (advances, ``t``, cell,
    hit, exhausted, active). A dict of numpy arrays, one row a ray."""
    import torch

    from voxelrt_torch.ops import dda_kernel as dk

    sel = torch.nonzero(st["adv"] >= cap).squeeze(1)
    idx = sel + lo
    origin, direction, tmin, tmax = args[1:5]
    n = origin.x.shape[0]
    tmax = (tmax if isinstance(tmax, torch.Tensor)
            else torch.full((n,), float(tmax), device=origin.x.device))
    alive = kw.get("alive")
    px, py, pz = dk._unpack_word(st["word"][sel])[:3]

    def np_(x):
        return x.cpu().numpy()

    return dict(
        index=np_(idx), origin=np_(torch.stack(list(origin), -1)[idx]),
        direction=np_(torch.stack(list(direction), -1)[idx]),
        tmin=np.full(idx.numel(), float(tmin), np.float32),
        tmax=np_(tmax[idx]),
        alive=(np_(alive[idx] != 0).astype(np.uint8) if alive is not None
               else np.ones(idx.numel(), np.uint8)),
        kernel_distance=np_(k.distance[idx]), twin_advances=np_(st["adv"][sel]),
        twin_t=np_(st["t"][sel]),
        twin_cell=np_(torch.stack([px, py, pz], -1)).astype(np.int32),
        twin_hit=np_(st["hit"][sel]), twin_exhausted=np_(st["exh"][sel]),
        twin_active=np_(st["active"][sel]))


def b1_check(rec_args, chunk, reps=3, max_chunks=None, capture=False,
             tail=False):
    """B1 kernel vs twin on one recorded dispatch (closest hit, with or
    without in-kernel NEE, or shadow mode), all outputs bit-equal.

    The kernel runs the whole dispatch once under
    ``torch.cuda.set_sync_debug_mode("error")``, so that a host
    synchronisation in the wrapper fails the run; once with the sun-open
    early-out off (``sun_mode='off'``, or ``use_sun_open=False`` in shadow
    mode), which must change no output. The twin runs in runs of ``chunk``
    rays (one sample's wavefront each), which bounds its temporaries, over
    the first ``max_chunks`` of them (None: all), or with ``tail`` the last
    ones, which hold the dispatch's highest lane indices; on each the
    kernel runs again on that chunk alone (another list order, the same
    outputs and counts), and on the first the twin runs with the early-out
    off too.
    ``ms_with_wrapper`` is the CUDA-event time of the whole wrapper,
    ``device_ms`` the card's time for the dispatch's three passes,
    ``sun_off_ms`` the event time with the early-out off. With
    ``capture``, ``capped`` holds the compared rays whose advances reached
    the dispatch's cap (``capped_rays``). ``plain_ms`` is
    the twin's time scaled to the whole dispatch. The bound
    counts the primaries' advances (the kernel's own ``iters`` in
    closest-hit mode, the twin's on the compared chunks scaled to the
    dispatch in shadow mode) and the NEE shadow rays' (the twin's, scaled).
    Returns a dict of figures."""
    import torch

    from voxelrt_torch.ops import dda_kernel as dk

    args, kw = rec_args
    tables, rest = args[0], args[1:]
    n = rest[0].x.shape[0]
    shadow = bool(kw.get("any_hit"))
    sun_off = dict(kw, **(dict(use_sun_open=False) if shadow
                          else dict(sun_mode="off")))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        k = dk.raytrace(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    k_off = dk.raytrace(*args, **sun_off)
    torch.cuda.synchronize()
    counts = k.counts.tolist()
    mask_alive = int((kw["alive"] != 0).sum().item())
    off_bad = int(_b1_differs(k_off, k).sum().item())
    n_cmp = n if max_chunks is None else min(n, chunk * max_chunks)
    lo0 = n - n_cmp if tail else 0
    tot = dict(mism=0, chunk_bad=0, twin_off_bad=0, prim_adv=0, nee_adv=0,
               most_adv=0)
    cap = args[5] if len(args) > 5 else kw.get("max_advances", 512)
    capped = []
    max_err = 0.0
    plain_ms = 0.0
    for lo in range(lo0, lo0 + n_cmp, chunk):
        hi = min(lo0 + n_cmp, lo + chunk)
        sa = [_ray_slice(a, n, lo, hi) for a in rest]
        skw = {name: _ray_slice(v, n, lo, hi) for name, v in kw.items()}
        with AdvanceTally() as adv:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            p = dk.raytrace_plain(tables, *sa, **skw)
            end.record()
            torch.cuda.synchronize()
        plain_ms += start.elapsed_time(end)
        tot["prim_adv"] += adv.sums[0]
        tot["nee_adv"] += sum(adv.sums[1:])
        tot["most_adv"] = max(tot["most_adv"], adv.most)
        if capture:
            capped.append(capped_rays(args, kw, k, adv.states[0], lo, cap))
        del adv
        tot["mism"] += int(_b1_differs(k, p, lo).sum().item())
        kd = k.distance[lo:hi]
        both = torch.isfinite(kd) & torch.isfinite(p.distance)
        max_err = max(max_err, torch.where(
            both, (kd - p.distance).abs(), torch.zeros_like(kd)).max().item())
        kc = dk.raytrace(tables, *sa, **skw)
        tot["chunk_bad"] += int(_b1_differs(kc, p).sum().item()) + int(
            not torch.equal(kc.counts, p.counts))
        if lo == lo0:
            po = dk.raytrace_plain(
                tables, *sa, **{name: _ray_slice(v, n, lo, hi)
                                for name, v in sun_off.items()})
            tot["twin_off_bad"] += int(_b1_differs(k_off, po, lo).sum().item())
        del p, kc
    scale = n / n_cmp
    prim_adv = (tot["prim_adv"] * scale if shadow
                else int(k.iters.to(torch.int64).sum().item()))
    nee_adv = tot["nee_adv"] * scale
    out = dict(n=n, compared=n_cmp, compared_from=lo0, alive=counts[0],
               nee_marched=counts[1], nee_settled=counts[2],
               mismatched=tot["mism"], mismatch_frac=tot["mism"] / n_cmp,
               chunk_mismatched=tot["chunk_bad"],
               sun_off_mismatched=off_bad + tot["twin_off_bad"],
               max_abs_err=max_err,
               hits=int(torch.isfinite(k.distance).sum().item()),
               primary_advances=prim_adv, nee_advances=nee_adv,
               most_advances_of_a_ray=tot["most_adv"], advance_cap=cap)
    if capture:
        out["capped"] = {f: np.concatenate([c[f] for c in capped])
                         for f in capped[0]}
    out["ok"] = (tot["mism"] == 0 and tot["chunk_bad"] == 0
                 and out["sun_off_mismatched"] == 0 and counts[0] == mask_alive)
    out["ms_with_wrapper"] = cuda_ms(lambda: dk.raytrace(*args, **kw), reps)
    out["device_ms"] = device_ms(lambda: dk.raytrace(*args, **kw), reps)
    out["sun_off_ms"] = cuda_ms(lambda: dk.raytrace(*args, **sun_off), reps)
    out["plain_ms"] = plain_ms * scale
    out["bound_ms"], out["bound_by"] = b1_bound_ms(args, kw, counts[0],
                                                   prim_adv + nee_adv)
    return out


def profile_launch(r, launch_wall_ms, moving=False):
    """Device time of one accumulate launch by kernel, from torch.profiler
    tracing the card's activity only: the port's kernels, and everything
    else (PyTorch's own elementwise, indexing and reduction kernels). The
    device's idle share is taken against ``launch_wall_ms``, the wall time
    of an unprofiled launch, since tracing lengthens the launch it traces.
    ``moving``: a moving frame (render scale 0.5, history cap 50) from the
    renderer's current state, whose previous matrices must differ from the
    current ones; else a still launch. The profiler drops a session's
    kernel events now and then: a trace with none of B1's is taken again,
    up to three times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from voxelrt_torch.ops import prng
    from voxelrt_torch.render import pipeline

    params = r._params(50.0 if moving else 999999999.0)
    scale = 0.5 if moving else 1.0
    key = prng.fold_in(r.key, 10_000)
    pipeline.accumulate(r.cfg, r.scene_data, params, r.state, key, moving,
                        scale)
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            t0 = time.perf_counter()
            pipeline.accumulate(r.cfg, r.scene_data, params, r.state, key,
                                moving, scale)
            torch.cuda.synchronize()
            traced_wall_ms = (time.perf_counter() - t0) * 1e3
        events = device_events(p)
        if any(k in name for name, _ in events for k in B1_KERNELS):
            break
    # the port's kernels by the names of their __global__ functions; B1's
    # three passes count as one group
    names = {"traverse_kernel": B1_KERNELS,
             "point_kernel": ("point_kernel",),
             "bilinear_kernel": ("bilinear_kernel", "dirs_kernel",
                                 "dirs2_kernel"),
             "taps_kernel": ("taps_kernel",)}
    groups = dict.fromkeys([*names, "other"], 0.0)
    b1_passes = dict.fromkeys(B1_KERNELS, 0.0)
    # Only the device's own events: a runtime entry on the host side would
    # repeat the device time of the kernels it launched.
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for name, t in events:
        by_name[name][0] += t
        by_name[name][1] += 1
    top = []
    for name, (t, count) in by_name.items():
        g = next((k for k, frags in names.items()
                  if any(f in name for f in frags)), "other")
        groups[g] += t
        for k in B1_KERNELS:
            if k in name:
                b1_passes[k] += t
        top.append((t, count, name[:80]))
    dev_ms = sum(groups.values())
    top.sort(reverse=True)
    return dict(wall_ms=launch_wall_ms, traced_wall_ms=traced_wall_ms,
                device_ms=dev_ms, kernels=len(events),
                idle_share=1.0 - dev_ms / launch_wall_ms,
                by_group_ms=groups, b1_by_pass_ms=b1_passes,
                top_kernels=[dict(ms=t, count=c, name=k) for t, c, k in top[:12]])


def b4_bound_ms(args, kw):
    """B4's least time for one call, each byte once: the source region's
    texels (current colour 12 B, history 16 B, normals 4 B, and the depth
    when the depth gate is on and the extra scalar when given, 4 B each),
    the 64 B of proj_inv with the depth gate, the per-lane inputs the
    kernel reads (texture coordinate 8 B, the reprojection's x and y 8 B,
    the centre normal 12 B, and the centre depth 4 B with the depth gate)
    and every output once (current 12 B, w_sum 4 B, history 16 B, and 4 B
    of filtered extra when given). The arithmetic (4 or 16 taps of about 40
    float32 operations a lane) is counted beside it."""
    cur, extra, texcoord = args[0], args[5], args[6]
    gate, with_extra = kw["gate_depth"], extra is not None
    texels = cur.shape[0] * cur.shape[1]
    m = texcoord.shape[0] * texcoord.shape[1]
    nbytes = (texels * (12 + 16 + 4 + 4 * gate + 4 * with_extra) + 64 * gate
              + m * (8 + 8 + 12 + 4 * gate) + m * (32 + 4 * with_extra))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    taps = 16 if kw["catmullrom"] else 4
    t_ops = m * taps * 40.0 / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def b4_check(args, kw, reps=10):
    """B4 kernel vs twin on one set of ``temporal_taps`` arguments, both on
    the card: every output bit-equal. Also the kernel's routes (blocks,
    blocks whose history box overflowed shared memory, lanes that gathered
    their history taps from global memory, texels staged), its time by
    events around the wrapper and its device time, the twin's time and the
    bound."""
    import torch

    from voxelrt_torch.ops import resample as rs

    routes = torch.zeros(4, dtype=torch.int32, device=args[6].device)
    k = rs.temporal_taps(*args, **kw, counts=routes)
    p = rs.temporal_taps_plain(*args, **kw)
    torch.cuda.synchronize()
    m = args[6].shape[0] * args[6].shape[1]
    unequal, max_err, finite = 0, 0.0, True
    for a, b in zip(k, p):
        if (a is None) != (b is None):
            fail("B4 and its twin disagree on the extra output")
        if a is None:
            continue
        finite = finite and bool(torch.isfinite(a).all().item())
        differ = (a.view(torch.int32) != b.view(torch.int32)).reshape(
            m, -1).any(-1)
        unequal += int(differ.sum().item())
        max_err = max(max_err, (a - b).abs().max().item())
    blocks, box_h, lanes_h, staged = routes.tolist()
    out = dict(m=m, n=args[0].shape[0] * args[0].shape[1],
               catmullrom=bool(kw["catmullrom"]),
               gate_depth=bool(kw["gate_depth"]),
               with_extra=args[5] is not None, unequal_lanes=unequal,
               max_abs_err=max_err, finite=finite, blocks=blocks,
               box_overflow_blocks=box_h, global_lanes=lanes_h,
               global_lane_share=lanes_h / m,
               texels_staged_per_block=staged / max(blocks - box_h, 1),
               has_hist_share=(k[1] > 1e-3).float().mean().item())
    out["ok"] = finite and unequal == 0

    def call():
        return rs.temporal_taps(*args, **kw)

    out["ms_with_wrapper"] = cuda_ms(call, reps)
    out["device_ms"] = device_ms(call, reps)
    out["plain_ms"] = cuda_ms(lambda: rs.temporal_taps_plain(*args, **kw), 3)
    out["bound_ms"], out["bound_by"] = b4_bound_ms(args, kw)
    return out


def http_get(port, path):
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}{path}", timeout=30) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def viewer_visit(scene, max_frames, csv_path):
    """Serve ``scene`` through the browser viewer in a thread, act as its
    page (landing page, frames, input, /stat until it reports a moving
    stretch, an unknown path), and wait for the loop to end. Returns a dict
    of figures; fails on any wrong answer."""
    from voxelrt_torch.app import viewer

    port_box, done, errors = [], threading.Event(), []
    t_ready = []

    def ready(port):
        t_ready.append(time.perf_counter())
        port_box.append(port)

    def run():
        try:
            viewer.serve(scene, port=0, max_frames=max_frames,
                         stats_csv=csv_path, ready_cb=ready)
        except BaseException as e:  # reported by the main thread below
            errors.append(repr(e))
        finally:
            t_ready.append(time.perf_counter())
            done.set()

    th = threading.Thread(target=run, daemon=True)
    th.start()
    deadline = time.time() + 300
    while not port_box and not done.is_set() and time.time() < deadline:
        time.sleep(0.01)
    if not port_box:
        fail(f"viewer never bound a port: {errors}")
    port = port_box[0]
    code, body = http_get(port, "/")
    if code != 200 or b"frame.png" not in body:
        fail("viewer landing page is wrong")
    # hold W from the first frames on, as a user who starts walking
    code, body = http_get(port, "/input?keys=w&dx=0.01&dy=0")
    if code != 200 or body != b"ok":
        fail("viewer /input did not answer ok")
    png = b""
    while not png and not done.is_set() and time.time() < deadline:
        code, png = http_get(port, "/frame.png")
        time.sleep(0.03)
    if png[:8] != b"\x89PNG\r\n\x1a\n":
        fail("viewer served no PNG frame")
    saw_moving = False
    stat = {}
    while not done.is_set() and time.time() < deadline:
        stat = json.loads(http_get(port, "/stat")[1])
        if stat.get("moving"):
            saw_moving = True
            break
        time.sleep(0.03)
    http_get(port, "/input?keys=&dx=0&dy=0")
    if http_get(port, "/nope")[0] != 404:
        fail("viewer did not answer 404 to an unknown path")
    done.wait(timeout=300)
    th.join(timeout=30)
    if th.is_alive() or errors:
        fail(f"viewer loop did not end cleanly: {errors}")
    if not saw_moving:
        fail("viewer /stat never reported a moving frame")
    with open(csv_path) as fh:
        rows = [ln.strip().split(",") for ln in fh.readlines()[1:]]
    if len(rows) != max_frames:
        fail(f"viewer recorded {len(rows)} frames, expected {max_frames}")
    mv = sorted(float(r[2]) for r in rows if r[4] == "1")
    st = sorted(float(r[2]) for r in rows[2:] if r[4] == "0")
    return dict(frames=len(rows), moving_frames=len(mv), png_bytes=len(png),
                served_frame_ms=(t_ready[-1] - t_ready[0]) / len(rows) * 1e3,
                render_moving_ms=mv[len(mv) // 2] if mv else None,
                render_still_ms=st[len(st) // 2] if st else None,
                last_stat=stat)


def drive_camera_path(scene, tag, on_frame=None):
    """Phase 9's camera path (``N_MOVING`` frames of ``MOVE``, then
    ``N_STILL`` of ``HOLD``) through ``Scene.run_frames``, the launch
    counters and the peak memory set to 0 just before it and read just
    after; fails unless the rows' moving flags follow the path. Returns
    (the last image, the figures: seconds with set-up, launches, peak GB,
    each frame's wall ms and the median moving and still frame ms, the
    first two of each left out)."""
    import torch

    from voxelrt_torch.ops import _cuda
    from voxelrt_torch.utils.profiling import FrameStats

    with open(os.devnull, "w") as null:
        stats = FrameStats(out=null)
        _cuda.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        img = scene.run_frames([dict(MOVE) for _ in range(N_MOVING)]
                               + [dict(HOLD) for _ in range(N_STILL)],
                               stats=stats, on_frame=on_frame)
        torch.cuda.synchronize()
        path_s = time.perf_counter() - t0
        launches = dict(_cuda.LAUNCHES)
    flags = [row["moving"] for row in stats.rows]
    if flags != [True] * N_MOVING + [False] * N_STILL:
        fail(f"{tag}: wrong moving flags {flags}")
    walls = [row["wall_ms"] for row in stats.rows]
    mv_ms = sorted(walls[2:N_MOVING])
    st_ms = sorted(walls[N_MOVING + 2:])
    return img, dict(path_s=path_s, launches=launches,
                     peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                     walls=walls, moving_frame_ms=mv_ms[len(mv_ms) // 2],
                     still_frame_ms=st_ms[len(st_ms) // 2])


def run_path(scene, frames):
    """Drive ``scene.run_frames`` over ``frames``; returns (images taken
    with on_frame, FrameStats rows)."""
    from voxelrt_torch.utils.profiling import FrameStats

    imgs = []
    with open(os.devnull, "w") as null:
        stats = FrameStats(out=null)
        scene.run_frames([dict(f) for f in frames], stats=stats,
                         on_frame=lambda i, img: imgs.append(np.array(img)))
    return imgs, stats.rows


class Timed:
    """Wraps a module function to add the seconds of each call to
    ``self.s``."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.s = []

        def wrapper(*args, **kwargs):
            t = time.perf_counter()
            out = self.orig(*args, **kwargs)
            self.s.append(time.perf_counter() - t)
            return out

        setattr(module, name, wrapper)

    def restore(self):
        setattr(self.module, self.name, self.orig)


def phase_checkpoint(tmp):
    """Phase 22: checkpoint/resume on example6 at 1280x720. The main path,
    64 spp at chunk=16: uninterrupted, then a run that checkpoints at 32 and
    stops at 48, resumed from the checkpoint in a fresh HeadlessRenderer to
    64; the same with ReSTIR (one sample a launch) at 4 spp, checkpointed at
    2. The bar is the JAX package's (tests/test_checkpoint.py:70): max abs
    difference 1e-6."""
    import torch

    from voxelrt_torch.utils import checkpoint as ck

    def fresh(scene):
        """A new HeadlessRenderer for ``scene``, as a new session has."""
        scene._renderer = None
        r = scene.renderer
        r.prepare_data()
        return r

    rows = {}
    for tag, spp, chunk, over in (
            ("main", MAIN_SPP, MAIN_SPL, dict(samples_per_launch=MAIN_SPL)),
            ("restir", 4, 1, dict(use_restir_pt=True,
                                  samples_per_launch=1))):
        scene = build_example("example6", None, **over)
        img_full = fresh(scene).render(spp=spp, chunk=chunk,
                                       log_every=10**9)
        path = os.path.join(tmp, f"{tag}.npz")
        save = Timed(ck, "save_render_state")
        load = Timed(ck, "load_render_state")
        try:
            half = spp // 2
            fresh(scene).render(spp=half + chunk, chunk=chunk,
                                checkpoint_every=half, checkpoint_path=path,
                                log_every=10**9)
            r = fresh(scene)
            img = r.render(spp=spp, chunk=chunk, resume_from=path,
                           log_every=10**9)
        finally:
            save.restore()
            load.restore()
        if len(save.s) != 1 or len(load.s) != 1:
            fail(f"checkpoint ({tag}): {len(save.s)} saves and "
                 f"{len(load.s)} loads, expected one each")
        diff = float(np.abs(img - img_full).max())
        row = dict(spp=spp, chunk=chunk, killed_at=half, max_abs_diff=diff,
                   bitwise_equal=bool(np.array_equal(img, img_full)),
                   file_mb=os.path.getsize(path) / 1e6,
                   state_mb=sum(
                       t.numel() * t.element_size()
                       for t in _state_tensors(r.state)) / 1e6,
                   save_s=save.s[0], load_s=load.s[0],
                   resumed_spp=int(r.state.spp))
        rows[tag] = row
        w, h = scene.config.image_res
        print(f"checkpoint ({tag}, example6 {w}x{h}): {json.dumps(row)}",
              flush=True)
        if not np.isfinite(img).all() or not diff <= 1e-6 or \
                row["resumed_spp"] != spp:
            fail(f"checkpoint ({tag}): the resumed image differs from the "
                 "uninterrupted one")
        del r, scene
        torch.cuda.empty_cache()
    return rows


def _state_tensors(state):
    import dataclasses

    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if f.name == "reservoirs" and v is not None:
            for slot in v:
                yield from slot.values()
        elif hasattr(v, "element_size"):
            yield v


def phase_native(tmp):
    """Phase 23: the native runtime. ``make -C native`` on a copy of
    ``native/`` in ``tmp``, so the checkout holds no build afterwards
    (setuptools needs Python's headers, which a card host may lack); when it
    builds, the extension is loaded from there for this phase only:
    ``encode_png`` of example6's 1280x720 frame against the port's Python
    encoder (the decoded pixels equal), ``build_occupancy`` on example6's
    world against numpy (bit-equal), and a served viewer frame split into
    its render, ``fetch_image``, ``to_uint8_rows`` and encode."""
    from voxelrt_torch.utils import image, native
    from voxelrt_torch.world import build_occupancy_pyramid

    # the Makefile runs `python setup.py`: this interpreter, whose headers
    # and ABI the extension must match, under that name
    bindir = os.path.join(tmp, "bin")
    os.makedirs(bindir, exist_ok=True)
    with open(os.path.join(bindir, "python"), "w") as fh:
        fh.write(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
    os.chmod(os.path.join(bindir, "python"), 0o755)
    env = dict(os.environ, PATH=bindir + os.pathsep + os.environ["PATH"])
    src = os.path.join(tmp, "native")
    shutil.copytree(os.path.join(HERE, "native"), src,
                    ignore=shutil.ignore_patterns("build", "*.so"))
    t0 = time.perf_counter()
    mk = subprocess.run(["make", "-C", src], capture_output=True, text=True,
                        timeout=300, env=env)
    build_s = time.perf_counter() - t0
    ext = native.load_extension(src) if mk.returncode == 0 else None
    built = ext is not None
    out = dict(native_built=built, build_s=build_s)
    if not built:
        lines = (mk.stderr or mk.stdout).strip().splitlines()
        out["compiler_last_line"] = lines[-1] if lines else ""
    scene = build_example("example6", None)
    rows = np.ascontiguousarray(image.to_uint8_rows(
        scene.finish(spp=4, save=False)))
    h, w, _ = rows.shape
    path = os.path.join(tmp, "frame.png")

    def encode_ms(encode, reps=5):
        t = time.perf_counter()
        for _ in range(reps):
            png = encode(rows, w, h, 3)
        return (time.perf_counter() - t) / reps * 1e3, png

    out["encode_python_ms"], png_p = encode_ms(image.encode_png)
    with open(path, "wb") as fh:
        fh.write(png_p)
    if not np.array_equal(image._read_png_minimal(path), rows):
        fail("native phase: the Python encoder's PNG does not decode to "
             "its pixels")
    if built:
        saved = native._native, native._tried
        native._native, native._tried = ext, True
        try:
            out["encode_native_ms"], png_n = encode_ms(native.encode_png)
            with open(path, "wb") as fh:
                fh.write(png_n)
            out["decoded_equal"] = bool(np.array_equal(
                image._read_png_minimal(path), rows))
            out["png_bytes"] = dict(native=len(png_n), python=len(png_p))
            world = scene.world
            t = time.perf_counter()
            words = native.build_occupancy(world.material, world.grid_res,
                                           world.n_lods)
            out["occupancy_native_ms"] = (time.perf_counter() - t) * 1e3
            t = time.perf_counter()
            want = build_occupancy_pyramid(world.material != 0, world.n_lods)
            out["occupancy_numpy_ms"] = (time.perf_counter() - t) * 1e3
            out["occupancy_equal"] = bool(np.array_equal(words, want))
            out["served_frame"] = served_frame_split(scene, tmp)
        finally:
            native._native, native._tried = saved
        if not (out["decoded_equal"] and out["occupancy_equal"]):
            fail(f"native phase: the native runtime disagrees: {out}")
    print(f"native runtime: {json.dumps(out)}", flush=True)
    return out


def served_frame_split(scene, tmp, max_frames=16):
    """The viewer's frames (example6 at 1280x720, served over HTTP) split
    into the render (FrameStats' synced wall time), ``fetch_image``,
    ``to_uint8_rows`` and the encode: the medians of the still frames."""
    from voxelrt_torch.utils import image

    r = scene.renderer
    fetch = {"s": []}
    orig_fetch = r.fetch_image

    def timed_fetch(*a, **k):
        t = time.perf_counter()
        img = orig_fetch(*a, **k)
        fetch["s"].append(time.perf_counter() - t)
        return img

    r.fetch_image = timed_fetch
    rows = Timed(image, "to_uint8_rows")
    enc = Timed(image, "encode_png")
    try:
        view = viewer_visit(scene, max_frames,
                            os.path.join(tmp, "viewer_stats.csv"))
    finally:
        rows.restore()
        enc.restore()
        del r.fetch_image

    def med(xs):
        xs = sorted(xs[2:] or xs)  # past the first frames' warm-up
        return xs[len(xs) // 2] * 1e3

    return dict(served_frame_ms=view["served_frame_ms"],
                render_still_ms=view["render_still_ms"],
                render_moving_ms=view["render_moving_ms"],
                fetch_image_ms=med(fetch["s"]),
                to_uint8_rows_ms=med(rows.s), encode_ms=med(enc.s),
                frames=view["frames"])


def phase_portable():
    """Phase 24: B1 (closest hit) and the portable traversal
    ``ops/dda.raytrace`` on the same primaries on the card: one sample of
    the main path's depth-0 dispatch, 921,600 rays, counted by the rule of
    tests/test_dda_pallas.py:52-66; at most 1% may disagree."""
    import torch

    from voxelrt_torch.ops import dda as pdda
    from voxelrt_torch.ops import dda_kernel as dk
    from voxelrt_torch.ops import prng
    from voxelrt_torch.render import pathtracer as pt
    from voxelrt_torch.render import pipeline

    scene = build_example("example6", None, samples_per_launch=1)
    r = scene.renderer
    r.prepare_data()
    rec = Recorder(pt, "raytrace", keep=8)
    try:
        pipeline.accumulate(r.cfg, r.scene_data, r._params(1e9), r.state,
                            prng.key(5))
    finally:
        rec.restore()
    tables, origin, direction, tmin, tmax = rec.calls[0][0][:5]
    n = origin.x.shape[0]
    res = tables.grid_res
    pyr = pdda.OccupancyPyramid(r.scene_data.occ_words, res,
                                int(np.log2(res)))
    o = torch.stack(list(origin), -1)
    d = torch.stack(list(direction), -1)

    def b1():
        return dk.raytrace(tables, origin, direction, tmin, tmax)

    def portable():
        return pdda.raytrace(pyr, o, d, tmin, tmax)

    got = b1()
    ref = portable()
    bad = pdda.disagreements(ref, got.distance, torch.stack(list(got.ipos), -1),
                             torch.stack(list(got.normal), -1))
    n_bad = int(bad.sum())
    hits = int(torch.isfinite(ref.distance).sum())
    row = dict(rays=n, hits=hits, disagree=n_bad, disagree_frac=n_bad / n,
               b1_ms=device_ms(b1, 10), portable_ms=cuda_ms(portable, 2),
               portable_most_advances=int(ref.iters.max()),
               b1_most_advances=int(got.iters.max()))
    print(f"portable traversal vs B1 (example6 primaries, one sample): "
          f"{json.dumps(row)}", flush=True)
    if n != r.cfg.image_res[0] * r.cfg.image_res[1] or n_bad > 0.01 * n \
            or hits == 0:
        fail("the portable traversal and B1 disagree on more than 1% of "
             "the primaries")
    return row


def phase_multidevice(card, smi):
    """Phase 25: multi-device rendering on example6 at 1280x720, on a mesh
    of ``card`` twice (dp=2) and, when there are several, of every card.
    ``parallel_render`` (4 spp) against one device. The still frame
    partitioned over 'dp' (``sharded_accumulate_n``): a 16-sample launch,
    every field of the gathered state ``torch.equal`` to one device's; a
    second launch from the partitioned state with any host synchronisation
    an error, equal to one device's second launch; its wall ms, each
    device's peak memory, and a profiled launch's kernels and device ms,
    beside one device's; a still→moving→still sequence (a reset, two moving
    frames at half scale, a reset, a still launch), equal on every field;
    and ReSTIR at the JAX defaults (32 taps, radius 24) partitioned for 4
    spp (timed after a 1-spp render), equal on every field, both reservoir
    slots included."""
    import torch

    from voxelrt_torch.ops import prng
    from voxelrt_torch.parallel import sharding
    from voxelrt_torch.render import pipeline

    scene = build_example("example6", None, samples_per_launch=MAIN_SPL)
    r = scene.renderer
    r.prepare_data()
    cfg, sd = r.cfg, r.scene_data
    still, moving = r._params(1e9), r._params(50.0)
    key = prng.key(9)
    home = sd.occ_words.device

    def walled(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    def runner(mesh):
        if mesh is None:
            return pipeline.accumulate_n
        return lambda *a: sharding.sharded_accumulate_n(*a, mesh=mesh)

    def launch(mesh, st):
        return runner(mesh)(cfg, sd, still, st, key, False, 1.0, MAIN_SPL)

    def sequence(mesh, st):
        run = runner(mesh)
        st = pipeline.reset_framebuffer(st)
        for i in range(2):
            st = run(cfg, sd, moving, st, prng.key(100 + i), True, 0.5, 1)
        st = pipeline.reset_framebuffer(st)
        return run(cfg, sd, still, st, prng.key(102), False, 1.0, MAIN_SPL)

    def peak_run(mesh, fn):
        devs = [home] if mesh is None else mesh.distinct()
        torch.cuda.synchronize()
        for d in devs:
            torch.cuda.reset_peak_memory_stats(d)
        out, ms = walled(fn)
        return out, ms, {str(d): torch.cuda.max_memory_allocated(d) / 1e9
                         for d in devs}

    def render(mesh):
        return sharding.parallel_render(cfg, sd, still, key, 4, mesh)

    w = cfg.image_res[0]
    meshes = {f"{card} x2 (dp=2)": sharding.make_mesh([card] * 2, dp=2)}
    n_cards = torch.cuda.device_count()
    if n_cards > 1 and w % n_cards == 0:
        meshes[f"{n_cards} cards"] = sharding.make_mesh()
    elif n_cards > 1:
        print(f"multi-device: {w} rows do not split into {n_cards} blocks; "
              "the mesh of every card is not run", flush=True)
    one = sharding.make_mesh([card])
    st0 = pipeline.init_state(cfg, home)
    render(one)
    img1, img1_ms = walled(lambda: render(one))
    launch(None, st0)  # past first calls
    st1, st1_ms, st1_peak = peak_run(None, lambda: launch(None, st0))
    st1_prof = profile_call(lambda: launch(None, st0))
    st2 = launch(None, st1)
    seq1 = sequence(None, st1)

    rscene = build_example("example6", None, use_restir_pt=True)
    rr = rscene.renderer
    rr.prepare_data()
    rcfg = rr.cfg
    if (rcfg.restir_taps, rcfg.restir_radius, rcfg.samples_per_launch) != (
            32, 24.0, 1):
        fail("multi-device: the ReSTIR render does not run at the JAX "
             "defaults")
    rparams = rr._params(1e9)

    def restir(mesh, spp=4):
        return runner(mesh)(rcfg, rr.scene_data, rparams,
                            pipeline.init_state(rcfg, home), key, False, 1.0,
                            spp)

    restir(None, 1)  # past first calls
    rst1, rst1_ms = walled(lambda: restir(None))
    rows = {}
    for name, mesh in meshes.items():
        render(mesh)
        img, ms = walled(lambda: render(mesh))
        launch(mesh, st0)
        part, part_ms, part_peak = peak_run(mesh, lambda: launch(mesh, st0))
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            part2 = launch(mesh, part)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        prof = profile_call(lambda: launch(mesh, st0))
        seq = sequence(mesh, part)
        restir(mesh, 1)
        rst, rst_ms = walled(lambda: restir(mesh))
        blocks = [(str(b.color.device), b.color.shape[0]) for b in part]
        bad = dict(
            parallel_render=[] if torch.equal(img, img1) else ["image"],
            still_launch=unequal_fields(st1, part),
            second_launch_sync_checked=unequal_fields(st2, part2),
            still_moving_still=unequal_fields(seq1, seq),
            restir_4spp=unequal_fields(rst1, rst))
        rows[name] = dict(
            unequal_fields=bad, blocks=blocks,
            parallel_render_ms=ms, parallel_render_one_device_ms=img1_ms,
            partitioned_launch_ms=part_ms, one_device_launch_ms=st1_ms,
            partitioned_peak_gb=part_peak, one_device_peak_gb=st1_peak,
            partitioned_profile=prof, one_device_profile=st1_prof,
            restir_4spp_ms=rst_ms, restir_4spp_one_device_ms=rst1_ms,
            sequence_ends_partitioned=isinstance(seq, tuple))
        print(f"multi-device ({name}; {smi}): {json.dumps(rows[name])}",
              flush=True)
        if any(bad.values()):
            fail(f"multi-device ({name}): the partitioned render is not "
                 f"equal to one device's: {bad}")
        if [d for d, _ in blocks] != [str(mesh.devices[i][0])
                                      for i in range(mesh.shape["dp"])] \
                or sum(n for _, n in blocks) != w \
                or not rows[name]["sequence_ends_partitioned"]:
            fail(f"multi-device ({name}): the state is not partitioned over "
                 "the mesh's 'dp' devices")
        del part, part2, seq, rst
    if not torch.isfinite(img1).all() or float(img1.std()) <= 0.0 or \
            not torch.isfinite(rst1.color).all() or \
            float(st1.color.std()) <= 0.0:
        fail("multi-device: the one-device images are not finite or constant")
    del st1, st2, seq1, rst1, rr, rscene, r, scene
    torch.cuda.empty_cache()
    return rows


BENCH_KEYS = ("metric", "value", "unit", "vs_baseline")
TRACE_TWIN_RAYS = 65_536  # of each trace-bench set go through B1's twin


def phase_bench(smi):
    """Phase 26: ``bench_torch.py`` at its defaults (example6, 1280x720, 512
    spp, 16 samples a launch) in a fresh process, as a user runs it: its one
    JSON line on stdout with ``bench.py``'s keys and ``vs_baseline`` null,
    its info dict on stderr, measured to the end (``extrapolated`` false),
    and ``compile_s`` in its parts. The kernels are built by phase 2, so its
    ``kernels_s`` is their load."""
    import torch

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join(HERE, "bench_torch.py")],
                          capture_output=True, text=True, timeout=600,
                          cwd=HERE)
    wall_s = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"bench_torch.py exited {proc.returncode}: {proc.stderr[-2000:]}")
    lines = proc.stdout.strip().splitlines()
    if len(lines) != 1:
        fail(f"bench_torch.py printed {len(lines)} lines on stdout")
    line = json.loads(lines[0])
    info = json.loads(proc.stderr.strip().splitlines()[-1])
    if tuple(line) != BENCH_KEYS or line["vs_baseline"] is not None or \
            line["metric"] != "time_to_512spp_720p":
        fail(f"bench_torch.py's line is not bench.py's: {line}")
    if info["extrapolated"] or info["measured_spp"] != 512:
        fail(f"bench_torch.py did not measure all 512 spp: {info}")
    parts = info["kernels_s"] + info["first_launch_s"] + info["warmup_rest_s"]
    if abs(parts - info["compile_s"]) > 0.01 or not line["value"] > 0.0:
        fail(f"bench_torch.py's compile_s is not its parts' sum: {info}")
    for kname in ("traverse", "point_fetch", "bilinear_fetch_dirs"):
        if not info["launches"].get(kname):
            fail(f"bench_torch.py launched no {kname}")
    print(json.dumps(line), flush=True)
    print(f"bench_torch.py ({smi}): {json.dumps(info)}; process wall "
          f"{wall_s:.1f} s", flush=True)
    return dict(line=line, info=info, wall_s=wall_s)


def _b1_sample_check(tables, s, idx):
    """Rays ``idx`` of trace-bench set ``s``: the kernel's outputs on the
    whole set against B1's twin on those rays alone, every output by bits.
    Returns (rays that differ, largest distance gap)."""
    import torch

    from tools import trace_bench_torch as tbt
    from voxelrt_torch.ops import dda_kernel as dk
    from voxelrt_torch.ops.v3 import V3

    k = tbt.trace(tables, s)
    sub = V3(*(c[idx] for c in s.o)), V3(*(c[idx] for c in s.d))
    tmax = s.tmax[idx] if isinstance(s.tmax, torch.Tensor) else s.tmax
    alive = s.alive[idx] if s.alive is not None else None
    p = dk.raytrace_plain(tables, *sub, tbt.TMIN, tmax, alive=alive,
                          any_hit=s.any_hit, fetch_colors=not s.any_hit,
                          use_sun_open=s.use_sun_open)
    bad = k.distance[idx] != p.distance
    for f in ("iters", "color_word", "active"):
        x, y = getattr(k, f), getattr(p, f)
        if x is not None:
            bad |= x[idx] != y
    if k.ipos is not None:
        for x, y in zip((*k.ipos, *k.normal), (*p.ipos, *p.normal)):
            bad |= x[idx] != y
    kd = k.distance[idx]
    both = torch.isfinite(kd) & torch.isfinite(p.distance)
    err = torch.where(both, (kd - p.distance).abs(), torch.zeros_like(kd))
    return int(bad.sum().item()), float(err.max().item())


def phase_trace_bench(smi):
    """Phase 27: ``tools/trace_bench_torch.py`` on its four ray sets
    (primary, bounce, shadow in shadow mode, random; the synthetic 128^3
    world, 921,600 rays each in tile order): B1's device ms, Mrays/s, bound
    and share, advances and slowest-warp statistics; and on a strided
    sample of TRACE_TWIN_RAYS rays of each set, every output of the
    kernel's dispatch bit-equal to B1's twin."""
    import torch

    from tools import trace_bench_torch as tbt

    dev = torch.device("cuda", torch.cuda.current_device())
    tables, sets = tbt.ray_sets(dev)
    out = {}
    for name, s in sets.items():
        fig, _ = tbt.measure(tables, s)
        n = fig["n"]
        idx = torch.arange(0, n, max(1, n // TRACE_TWIN_RAYS),
                           device=dev)[:TRACE_TWIN_RAYS]
        fig["twin_rays"] = int(idx.shape[0])
        fig["twin_mismatched"], fig["max_abs_err"] = _b1_sample_check(
            tables, s, idx)
        out[name] = fig
        print(f"trace bench {name} ({smi}): {json.dumps(fig)}", flush=True)
        if fig["twin_mismatched"]:
            fail(f"trace bench: B1 disagrees with its twin on the {name} "
                 "set")
        if not fig["device_ms"] > 0.0 or fig["alive"] != n:
            fail(f"trace bench: the {name} set was not traced")
    return out


def phase_multichip_report(card, smi):
    """Phase 28: ``tools/multichip_report_torch.py``'s report: example6's
    still step (two 16-sample launches) at 1280x720 partitioned at dp=8
    (160-row blocks) and dp=32 (40-row blocks, off the tile columns), and
    at dp=4 × sp=2 (320-row blocks, each block's samples over two devices
    and the trace gathered), on
    ``card`` dp times or, on a host with several cards, on every card;
    every field equal to one device's after each launch, with the halo
    rows and bytes, each device's device ms and peak memory and the launch's
    wall ms and kernels beside one device's."""
    from tools import multichip_report_torch as mrt

    scene = build_example("example6", card, samples_per_launch=MAIN_SPL)
    r = scene.renderer
    r.prepare_data()
    rep = mrt.report(r.cfg, r.scene_data, r._params(1e9), card, [8, 32],
                     MAIN_SPL, smi=smi,
                     out=lambda ln: print(f"multichip report: {ln}",
                                          flush=True))
    # the 'sp' axis: dp=4 blocks, each block's samples over 2 devices
    sp = mrt.report(r.cfg, r.scene_data, r._params(1e9), card, [4],
                    MAIN_SPL, sp=2, smi=smi,
                    out=lambda ln: print(f"multichip report: {ln}",
                                         flush=True))
    rep["meshes"]["dp=4 sp=2"] = row = sp["meshes"]["dp=4"]
    rep["ok"] = rep["ok"] and sp["ok"]
    if len(row["devices"]) != 8 or not row["trace_gather_bytes"] > 0:
        fail(f"multichip report (dp=4 sp=2): {len(row['devices'])} devices, "
             f"{row['trace_gather_bytes']} B of trace gathered")
    w = r.cfg.image_res[0]
    for name, row in rep["meshes"].items():
        if not row["equal"]:
            fail(f"multichip report ({name}): the partitioned state is not "
                 f"equal to one device's: {row['unequal_fields']}")
        if [b["rows"] for b in row["blocks"]] != [w // row["dp"]] * row["dp"]:
            fail(f"multichip report ({name}): wrong blocks {row['blocks']}")
    del r, scene
    import torch

    torch.cuda.empty_cache()
    return rep


def held_to_golden(tag, img, golden_rel, launches, need, smi, golden=None,
                   **extra):
    """``img`` held to the JAX package's golden ``golden_rel`` (made on the
    CPU by ``tests/test_torch_golden.py --regen``), or to the image
    ``golden`` in memory, which ``golden_rel`` then names: the RMSE, the
    RMSE of the port's image rounded to 8 bits as a PNG golden was (an
    image in memory is rounded alike for it), the
    share of pixels whose channels all lie within 2/255, the pixels beyond
    it and the 16 that differ most, and the launches. Fails when the image
    is not finite or has the wrong shape, or when a kernel in ``need`` was
    not launched; the caller holds the RMSE to ``FULLRES_BAR``. The port's
    image goes to ``chiprun_out/golden_<tag>.png``."""
    from voxelrt_torch.utils.image import read_png, to_uint8_rows, write_png

    if golden is None:
        golden = golden_8bit = read_png(os.path.join(HERE, golden_rel))
    else:
        golden_8bit = to_uint8_rows(golden)[::-1].transpose(1, 0, 2) \
            / np.float32(255)
    if img.shape != golden.shape or not np.isfinite(img).all():
        fail(f"{tag}: the image is not finite or has the wrong shape")
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    write_png(os.path.join(HERE, "chiprun_out", f"golden_{tag}.png"), img)
    diff = np.abs(img - golden).max(-1)
    rounded = to_uint8_rows(img)[::-1].transpose(1, 0, 2) / np.float32(255)
    worst = np.argsort(diff, axis=None)[::-1][:16]
    out = dict(
        golden=golden_rel, res=list(img.shape[:2]), **extra,
        rmse=float(np.sqrt(np.mean((img - golden) ** 2))),
        rmse_8bit=float(np.sqrt(np.mean((rounded - golden_8bit) ** 2))),
        within_2_255=float((diff <= 2 / 255).mean()),
        beyond_2_255_pixels=int((diff > 2 / 255).sum()),
        # the 8-bit RMSE with the pixels beyond 2/255 left out (their
        # differences set to 0), so that the two parts add in quadrature
        rmse_8bit_within=float(np.sqrt(np.mean(
            np.where((diff <= 2 / 255)[..., None], rounded - golden_8bit,
                     0.0) ** 2))),
        max_abs=float(diff.max()), bar=FULLRES_BAR, launches=launches,
        worst_pixels=[dict(u=int(u), v=int(v), diff=float(diff[u, v]),
                           port=img[u, v].tolist(),
                           golden=golden[u, v].tolist())
                      for u, v in zip(*np.unravel_index(worst, diff.shape))],
        device=smi)
    for k in need:
        if not launches.get(k):
            fail(f"{tag}: kernel {k} was not launched")
    return out


def report_golden(phase, what, out, against="the JAX package's CPU render"):
    """Prints phase ``phase``'s row against its golden, ``against``; fails
    above the bar."""
    worst = out["worst_pixels"]
    print(f"full-width golden ({phase}): {what} at {out['res'][0]}x"
          f"{out['res'][1]} against {against}: RMSE "
          f"{out['rmse']:.6f} (bar {FULLRES_BAR}; the port's image rounded "
          f"to 8 bits {out['rmse_8bit']:.6f}), {out['within_2_255']:.6f} of "
          f"pixels within 2/255 ({out['beyond_2_255_pixels']} beyond), "
          f"largest difference {out['max_abs']:.4f}, launches "
          f"{json.dumps(out['launches'])}, on {out['device']}; the worst "
          f"pixels (u, v, largest channel difference): "
          f"{[(p['u'], p['v'], round(p['diff'], 4)) for p in worst]}",
          flush=True)
    if not out["rmse"] <= FULLRES_BAR:
        fail(f"phase {phase}: RMSE {out['rmse']} against {against} is above "
             f"{FULLRES_BAR}")


def finish_from_shipped_sky(tag, spp, name="example6", **config_over):
    """Example ``name`` through ``Scene.finish(spp)`` on the card at its
    default config with ``config_over``, from the Scene's default seed, a
    sky loaded from ``data/skycache/`` (an empty ``sky_cache_dir`` must stay
    empty); returns (image, Scene.finish seconds, launches)."""
    import torch

    from voxelrt_torch.ops import _cuda

    with tempfile.TemporaryDirectory() as cache:
        scene = build_example(name, None, sky_cache_dir=cache,
                              **config_over)
        _cuda.reset_launch_counts()
        t0 = time.perf_counter()
        img = scene.finish(spp=spp, save=False)
        torch.cuda.synchronize()
        finish_s = time.perf_counter() - t0
        launches = {k: v for k, v in _cuda.LAUNCHES.items() if v}
        if os.listdir(cache):
            fail(f"{tag}: the sky was recomputed, not loaded from "
                 "data/skycache/")
    return img, finish_s, launches


def phase_fullres_golden(smi):
    """Phase 29: example6, unedited, at its default RenderConfig (1280x720)
    with ``samples_per_launch=FULLRES_SPL``: one launch through
    ``Scene.finish`` on the card, held to ``FULLRES_GOLDEN`` at RMSE
    ``FULLRES_BAR``, the bar of tests/test_examples_golden.py."""
    img, finish_s, launches = finish_from_shipped_sky(
        "phase 29", FULLRES_SPL, samples_per_launch=FULLRES_SPL)
    return held_to_golden("29", img, FULLRES_GOLDEN, launches,
                          ("traverse", "point_fetch", "bilinear_fetch_dirs"),
                          smi, spp=FULLRES_SPL, finish_s=finish_s)


def phase_path_golden(frames, launches, smi):
    """Phase 30: phase 9's camera path (example6 at its default config, the
    Scene's default seed, ``Scene.run_frames`` over ``N_MOVING`` moving
    and ``N_STILL`` still frames, one sample a frame): its frames kept by
    number (counted from 1), each held to ``PATH_GOLDENS``' JAX render of
    the same at RMSE ``FULLRES_BAR``, with phase 9's launches."""
    return {n: held_to_golden(
        f"30_f{n}", frames[n], PATH_GOLDENS[n], launches,
        ("traverse", "point_fetch", "bilinear_fetch_dirs", "temporal_taps"),
        smi, frame=n, moving=n <= N_MOVING) for n in sorted(PATH_GOLDENS)}


def phase_restir_golden(smi):
    """Phase 31: example6 with ReSTIR-PT at the JAX defaults (32 taps of
    radius 24, one sample a launch), ``RESTIR_GOLDEN_SPP`` spp through
    ``Scene.finish`` on the card, held to ``RESTIR_GOLDEN`` at RMSE
    ``FULLRES_BAR``."""
    img, finish_s, launches = finish_from_shipped_sky(
        "phase 31", RESTIR_GOLDEN_SPP, use_restir_pt=True)
    return held_to_golden("31", img, RESTIR_GOLDEN, launches,
                          ("traverse", "traverse_shadow", "point_fetch",
                           "bilinear_fetch_dirs"),
                          smi, spp=RESTIR_GOLDEN_SPP, finish_s=finish_s)


def phase_restir_example2_golden(smi):
    """Phase 33: example2 (emissive voxels, no sun) with ReSTIR-PT at the
    JAX defaults, ``RESTIR_GOLDEN_SPP`` spp through ``Scene.finish`` on the
    card, held to ``EXAMPLE2_RESTIR_GOLDEN`` at RMSE ``FULLRES_BAR``."""
    img, finish_s, launches = finish_from_shipped_sky(
        "phase 33", RESTIR_GOLDEN_SPP, "example2", use_restir_pt=True)
    return held_to_golden("33", img, EXAMPLE2_RESTIR_GOLDEN, launches,
                          ("traverse",), smi, spp=RESTIR_GOLDEN_SPP,
                          finish_s=finish_s)


def phase_ref_res(smi):
    """Phase 34: example6 at the reference's own resolution, ``REF_RES``.
    The still: one launch of ``FULLRES_SPL`` samples through
    ``Scene.finish`` from a fresh ``Scene``, held to ``REF_GOLDEN`` at RMSE
    ``FULLRES_BAR``, then two more launches for the steady ``per_spp_ms``.
    The camera path: phase 9's frames through ``Scene.run_frames`` from a
    fresh ``Scene`` at its default config, frames 24 and 30 held to
    ``REF_PATH_GOLDENS``. The moving frames' 960x540 active grid does not
    tile (540 % 8 = 4), so their lanes must take the column-order route
    (``pipeline.block_tiled`` False) and the still frames the tiled one.
    Each part's launches are counted from 0 around it; peak memory and
    times beside them. Then, on the calls of one more still launch, B1's
    four dispatches (33.2M lanes each; the twin on the last sample's
    chunk, the highest lane indices), B2 and B3, and on the last moving
    frame's two calls B4 (518,400 texels, just under its MAX_TEXELS), each
    held bit-equal to its twin."""
    import torch

    from voxelrt_torch.ops import _cuda
    from voxelrt_torch.render import pipeline, temporal

    w, h = REF_RES
    need = ("traverse", "point_fetch", "bilinear_fetch_dirs")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as cache:
        scene = build_example("example6", None, sky_cache_dir=cache,
                              image_res=REF_RES,
                              samples_per_launch=FULLRES_SPL)
        r = scene.renderer
        _cuda.reset_launch_counts()
        with render_timer(r) as timing:
            t0 = time.perf_counter()
            img = scene.finish(spp=FULLRES_SPL, save=False)
            torch.cuda.synchronize()
            finish_s = time.perf_counter() - t0
        launches = {k: v for k, v in _cuda.LAUNCHES.items() if v}
        if os.listdir(cache):
            fail("phase 34: the sky was recomputed, not loaded from "
                 "data/skycache/")
    first_ms = timing["render_s"] / FULLRES_SPL * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.render(spp=2 * FULLRES_SPL)
    torch.cuda.synchronize()
    steady_ms = (time.perf_counter() - t0) / (2 * FULLRES_SPL) * 1e3
    still_peak_gb = torch.cuda.max_memory_allocated() / 1e9
    kernels = ref_res_still_checks(r, w * h)
    del r, scene
    torch.cuda.empty_cache()
    still = held_to_golden("34_still", img, REF_GOLDEN, launches, need, smi,
                           spp=FULLRES_SPL, finish_s=finish_s,
                           first_per_spp_ms=first_ms,
                           steady_per_spp_ms=steady_ms,
                           peak_gb=still_peak_gb)
    del img

    # the camera path: which route each frame's lanes took
    routes = collections.Counter()
    tiled_of = pipeline.block_tiled

    def watched(aw, ah, ra):
        out = tiled_of(aw, ah, ra)
        routes[(aw, ah, ra, out)] += 1
        return out

    frames = {}

    def keep_frame(i, frame):
        if i + 1 in REF_PATH_GOLDENS:
            frames[i + 1] = np.array(frame)

    mscene = build_example("example6", None, image_res=REF_RES)
    pipeline.block_tiled = watched
    rec_b4 = Recorder(temporal, "temporal_taps", keep=2)
    try:
        _, fig = drive_camera_path(mscene, "phase 34", keep_frame)
    finally:
        pipeline.block_tiled = tiled_of
        rec_b4.restore()
    mlaunches = {k: v for k, v in fig["launches"].items() if v}
    if len(rec_b4.calls) != 2:
        fail("phase 34: B4's calls were not recorded")
    kernels["b4"] = {}
    for (cargs, ckw), tag in zip(rec_b4.calls, ("diffuse", "specular")):
        c = kernels["b4"][tag] = b4_check(cargs, ckw)
        print(f"B4 at {w}x{h}, the last moving frame's {tag} pass: "
              f"{json.dumps(c)}", flush=True)
        if not c["ok"] or (c["m"], c["n"]) != (w * h, w * h // 4):
            fail(f"phase 34: B4 ({tag}) is not bit-equal to its twin at "
                 f"{w * h} lanes of {w * h // 4} texels")
    del rec_b4, cargs, ckw, mscene
    torch.cuda.empty_cache()
    aw, ah = w // 2, h // 2
    untiled = routes.get((aw, ah, aw, False), 0)
    tiled = routes.get((w, h, w, True), 0)
    if untiled < N_MOVING or tiled < N_STILL or set(routes) != {
            (aw, ah, aw, False), (w, h, w, True)}:
        fail(f"phase 34: the frames' lane orders {dict(routes)}: the "
             f"{aw}x{ah} moving frames must take the column-order route, "
             f"the {w}x{h} still ones the tiled one")
    if mlaunches.get("temporal_taps") != 2 * N_MOVING:
        fail(f"phase 34: {mlaunches.get('temporal_taps')} B4 launches over "
             f"the camera path, expected {2 * N_MOVING}")
    path = {n: held_to_golden(
        f"34_f{n}", frames[n], REF_PATH_GOLDENS[n], mlaunches,
        need + ("temporal_taps",), smi, frame=n, moving=n <= N_MOVING)
        for n in sorted(REF_PATH_GOLDENS)}
    return dict(res=list(REF_RES), still=still, path=path,
                path_s=fig["path_s"], moving_frame_ms=fig["moving_frame_ms"],
                still_frame_ms=fig["still_frame_ms"],
                frame_wall_ms=fig["walls"], path_peak_gb=fig["peak_gb"],
                path_launches=mlaunches, kernels=kernels,
                lane_routes={f"{a}x{b} rows {c} tiled={t}": v
                             for (a, b, c, t), v in routes.items()},
                device=smi)


def ref_res_still_checks(r, pixels):
    """Phase 34's kernel checks on one more still launch of renderer
    ``r`` (``pixels`` a sample): B1's four dispatches, the twin on the last
    sample's chunk, B2's escape fetch and B3's last call, each bit-equal to
    its twin. Returns their figures."""
    from voxelrt_torch.render import pathtracer as pt
    from voxelrt_torch.sky import atmos

    recs = (Recorder(pt, "raytrace", keep=4),
            Recorder(atmos, "point_fetch_words", keep=1),
            Recorder(atmos, "bilinear_fetch_dirs", keep=1))
    try:
        r.render(spp=FULLRES_SPL)
    finally:
        for rec in recs:
            rec.restore()
    rec_b1, rec_b2, rec_b3 = recs
    lanes = FULLRES_SPL * pixels
    if len(rec_b1.calls) != 4 or any(
            c[0][1].x.shape[0] != lanes for c in rec_b1.calls):
        fail(f"phase 34: B1's four dispatches of {lanes} rays were not "
             "recorded")
    out = dict(b1=[])
    for depth, call in enumerate(rec_b1.calls):
        c = b1_check(call, chunk=pixels, max_chunks=1, tail=True)
        out["b1"].append(c)
        print(f"B1 at the reference resolution, depth {depth}, the twin on "
              f"rays {c['compared_from']}-{c['n'] - 1}: {json.dumps(c)}",
              flush=True)
        if not c["ok"]:
            fail(f"phase 34: B1 at depth {depth} disagrees with its twin")
    out["b2"] = b2_check(*rec_b2.calls[-1][0])
    print(f"B2 at the reference resolution: {json.dumps(out['b2'])}",
          flush=True)
    if not out["b2"]["ok"] or out["b2"]["n"] != lanes:
        fail(f"phase 34: B2 is not bit-equal to its twin at {lanes} lanes")
    out["b3"] = b3_check("bilinear_fetch_dirs", *rec_b3.calls[-1])
    print(f"B3 at the reference resolution: {json.dumps(out['b3'])}",
          flush=True)
    if not out["b3"]["ok"]:
        fail("phase 34: B3 is not bit-equal to its twin")
    return out


def report_ref_res(out):
    """Prints phase 34's rows; fails above the bar."""
    st = out["still"]
    print(f"reference resolution (34): example6 at {out['res'][0]}x"
          f"{out['res'][1]}: per_spp_ms {st['first_per_spp_ms']:.3f} in the "
          f"first {FULLRES_SPL}-sample launch, {st['steady_per_spp_ms']:.3f} "
          f"steady over two more, peak {st['peak_gb']:.2f} GB; camera path "
          f"{out['path_s']:.2f} s, moving_frame_ms "
          f"{out['moving_frame_ms']:.3f} (960x540 active), still_frame_ms "
          f"{out['still_frame_ms']:.3f}, peak {out['path_peak_gb']:.2f} GB, "
          f"lane orders {json.dumps(out['lane_routes'])}, on "
          f"{out['device']}", flush=True)
    report_golden("34", f"example6, {FULLRES_SPL} spp in one launch, "
                  f"Scene.finish {st['finish_s']:.2f} s", st)
    for n, row in out["path"].items():
        report_golden("34", f"example6's camera path, frame {n} "
                      f"({'moving, untiled' if row['moving'] else 'still'})",
                      row)


def sky_layers(cfg, args, golden_trans, device):
    """Masks of a sky map's texels: above the horizon (the texel's
    direction points up) and in cloud (the golden's transmittance below
    0.99 of the clear sky's along the same direction, that is a cloud
    transmittance below 0.99; the clear sky's own transmittance is 0.89 at
    most, so the golden's alone cannot tell cloud from air)."""
    from voxelrt_torch.sky import atmos

    res = cfg.skybox_res
    dirs = atmos._texel_dirs(cfg, 0, res * res, device)
    cam = atmos.splat(atmos._f32(atmos.CAM_POS, device))
    # the transmittance depends on the march's steps, not on the sun or
    # multiple-scattering samples
    lean = dataclasses.replace(cfg, sky_sun_samples=1, sky_ms_samples=1,
                               sky_ms_steps=1)
    _, clear = atmos.atmospheric_scattering(lean, cam, dirs, *args,
                                            atmos.prng.key(0))
    clear = np.stack([c.cpu().numpy() for c in clear], -1).reshape(
        golden_trans.shape)
    above = dirs.y.cpu().numpy().reshape(res, res) > 0.0
    lit = clear[..., 0] > 0.0  # the red channel, the least dimmed
    cloud = lit & (golden_trans[..., 0]
                   < 0.99 * np.where(lit, clear[..., 0], 1.0))
    return above, cloud


def sky_agreement(cfg, args, sky, golden, device):
    """The port's sky ``sky`` against the JAX package's ``golden`` (both
    SkyData) at tests/test_torch_sky.py's bars: the share of texels whose
    three channels of both maps lie within ``SKY_RTOL``/``SKY_ATOL``, the
    maps' RMSE relative to the golden's mean, the cloud ambient and the
    transmittance LUT; the texels that miss, split by layer."""
    def close(a, b):
        return np.isclose(a, b, rtol=SKY_RTOL, atol=SKY_ATOL).all(-1)

    def rel_rmse(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.sqrt(np.mean((a - b) ** 2)) / np.abs(b).mean())

    def within(a, b, atol):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return bool((np.abs(a - b) <= atol + SKY_RTOL * np.abs(b)).all())

    ok = (close(sky.skybox_scattering, golden.skybox_scattering)
          & close(sky.skybox_transmittance, golden.skybox_transmittance))
    above, cloud = sky_layers(cfg, args, golden.skybox_transmittance, device)
    layers = {}
    for a_name, a in (("above", above), ("below", ~above)):
        for c_name, c in (("cloud", cloud), ("clear", ~cloud)):
            m = a & c
            layers[f"{a_name}_{c_name}"] = dict(
                texels=int(m.sum()), missed=int((m & ~ok).sum()))
    return dict(
        share=float(ok.mean()), missed=int((~ok).sum()),
        rel_rmse_scattering=rel_rmse(sky.skybox_scattering,
                                     golden.skybox_scattering),
        rel_rmse_transmittance=rel_rmse(sky.skybox_transmittance,
                                        golden.skybox_transmittance),
        ambient_max_abs=float(np.abs(sky.cloud_ambient
                                     - golden.cloud_ambient).max()),
        ambient_ok=within(sky.cloud_ambient, golden.cloud_ambient,
                          SKY_AMBIENT_ATOL),
        lut_max_abs=float(np.abs(sky.trans_lut - golden.trans_lut).max()),
        lut_ok=within(sky.trans_lut, golden.trans_lut, SKY_LUT_ATOL),
        layers=layers)


def phase_sky_golden(smi):
    """Phase 32: example6 at ``skybox_res=SKY_GOLDEN_RES``, every other
    knob at its default, from a fresh ``Scene`` with an empty sky cache:
    ``Scene.finish`` computes the sky on the card in ``prepare_data`` and
    renders one launch of ``FULLRES_SPL`` samples at 1280x720 with it. The
    sky is held to the JAX package's (``SKY_GOLDEN``, made on the CPU by
    ``tests/test_torch_golden.py --regen sky``) at tests/test_torch_sky.py's
    bars, and the image to the same render from a fresh ``Scene`` that
    loads the JAX package's sky, at RMSE ``FULLRES_BAR``. Each render's
    launches are counted from 0."""
    import torch

    from voxelrt_torch.ops import _cuda
    from voxelrt_torch.sky import atmos

    need = ("traverse", "point_fetch", "bilinear_fetch_dirs")
    t_phase = time.perf_counter()
    with open(os.path.join(HERE, SKY_GOLDEN[:-len(".npz")] + ".json")) as fh:
        record = json.load(fh)
    imgs, launches, finish_s = {}, {}, {}
    with tempfile.TemporaryDirectory() as gdir, \
            tempfile.TemporaryDirectory() as cdir:
        for tag, cache in (("golden", gdir), ("card", cdir)):
            scene = build_example(
                "example6", None, sky_cache_dir=cache,
                skybox_res=SKY_GOLDEN_RES, samples_per_launch=FULLRES_SPL)
            cfg = scene.renderer.cfg
            args = sky_args(scene)
            key = atmos._cache_key(cfg, *args)
            if key != record["key"]:
                fail(f"phase 32: the port keys example6's sky {key}, the "
                     f"golden {record['key']}")
            if tag == "golden":
                shutil.copyfile(os.path.join(HERE, SKY_GOLDEN),
                                os.path.join(gdir, f"sky_{key}.npz"))
            elif atmos.load_sky(cfg, *args, "cpu", cdir) is not None:
                fail("phase 32 needs a sky that no cache holds")
            stats = {}
            compute = atmos.prepare_sky

            def timed_sky(*a, **kw):
                t0 = time.perf_counter()
                out = compute(*a, **kw, stats=stats)
                torch.cuda.synchronize()
                stats["total_s"] = time.perf_counter() - t0
                return out

            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _cuda.reset_launch_counts()
            atmos.prepare_sky = timed_sky
            try:
                t0 = time.perf_counter()
                imgs[tag] = scene.finish(spp=FULLRES_SPL, save=False)
                torch.cuda.synchronize()
                finish_s[tag] = time.perf_counter() - t0
            finally:
                atmos.prepare_sky = compute
            launches[tag] = {k: v for k, v in _cuda.LAUNCHES.items() if v}
            if tag == "golden":
                if not stats["cache_hit"] or len(os.listdir(gdir)) != 1:
                    fail("phase 32: the JAX package's sky was not loaded")
                golden = scene.renderer.scene_data.sky
            else:
                if stats["cache_hit"] or len(os.listdir(cdir)) != 1:
                    fail("phase 32: the card did not compute the sky")
                sky, sky_stats = scene.renderer.scene_data.sky, stats
                peak_gb = torch.cuda.max_memory_allocated() / 1e9
                agree = sky_agreement(cfg, args, sky, golden,
                                      scene.renderer.device)
            del scene
    torch.cuda.empty_cache()
    render = held_to_golden(
        "32", imgs["card"], f"example6 lit by {SKY_GOLDEN}", launches["card"],
        need, smi, golden=imgs["golden"], spp=FULLRES_SPL,
        finish_s=finish_s["card"], golden_finish_s=finish_s["golden"],
        golden_launches=launches["golden"])
    for k in need:
        if not launches["golden"].get(k):
            fail(f"phase 32: kernel {k} was not launched in the render with "
                 "the JAX package's sky")
    return dict(skybox_res=SKY_GOLDEN_RES, golden=SKY_GOLDEN,
                golden_seconds_on_cpu=record["seconds"], key=record["key"],
                sky=agree, sky_s=sky_stats["total_s"],
                sky_stage_s={k: sky_stats[k] for k in (
                    "lut_s", "cloud_s", "sky_s", "chunks_per_batch")},
                peak_gb=peak_gb, render=render,
                phase_s=time.perf_counter() - t_phase, device=smi)


def report_sky_golden(out):
    """Prints phase 32's rows; fails on any miss of a bar."""
    a = out["sky"]
    print(f"sky golden (32): example6's sky at {out['skybox_res']}^2 and the "
          f"default knobs, computed on the card in {out['sky_s']:.2f} s "
          f"(stages {json.dumps(out['sky_stage_s'])}; the JAX package on "
          f"the CPU {out['golden_seconds_on_cpu']:.1f} s), against the JAX "
          f"package's: {a['share']:.6f} of texels within rtol {SKY_RTOL} / "
          f"atol {SKY_ATOL} (bar {SKY_SHARE_BAR}; {a['missed']} miss), "
          f"relative RMSE scattering {a['rel_rmse_scattering']:.3e} (bar "
          f"{SKY_REL_RMSE_BARS['scattering']}), transmittance "
          f"{a['rel_rmse_transmittance']:.3e} (bar "
          f"{SKY_REL_RMSE_BARS['transmittance']}), cloud ambient "
          f"{a['ambient_max_abs']:.3e} apart (atol {SKY_AMBIENT_ATOL}), "
          f"LUT {a['lut_max_abs']:.3e} (atol {SKY_LUT_ATOL}); the texels "
          f"that miss by layer {json.dumps(a['layers'])}; phase "
          f"{out['phase_s']:.2f} s, peak {out['peak_gb']:.2f} GB, on "
          f"{out['device']}", flush=True)
    report_golden("32", "example6 lit by the card's sky, "
                  f"{FULLRES_SPL} spp in one launch, Scene.finish with the "
                  f"sky {out['render']['finish_s']:.2f} s", out["render"],
                  against="the same lit by the JAX package's sky")
    check_sky_bars("32", a)


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a "
             "CUDA card")
    sys.path.insert(0, HERE)
    from voxelrt_torch.ops import _cuda
    from voxelrt_torch.ops import texfetch as tf
    from voxelrt_torch.render import pathtracer as pt
    from voxelrt_torch.sky import atmos

    dev = torch.device("cuda")
    # -- 1. device -------------------------------------------------------------
    smi = card_name(torch.device("cuda", 0))
    print(f"device: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}",
          flush=True)

    # -- 2. build --------------------------------------------------------------
    build_s, log = _cuda.build_all()
    regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
    print(f"build: {build_s:.2f} s for {len(_cuda.SOURCES)} sources | "
          + " ; ".join(regs), flush=True)

    # -- 3. scene set-up (the main path's own entry points) -----------------
    t0 = time.perf_counter()
    scene = build_example("example6", None, samples_per_launch=MAIN_SPL)
    r = scene.renderer
    r.prepare_data()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    w, h = scene.config.image_res
    print(f"setup: example6 {w}x{h}, {setup_s:.2f} s (world, tables, sky "
          "cache load, upload)", flush=True)

    # -- 4. main path: Scene.finish at 1280x720, spl 16 ------------------------
    rec_pt = Recorder(atmos, "point_fetch_words", keep=1)
    rec_bl = Recorder(atmos, "bilinear_fetch_dirs", keep=1)
    rec_b1 = Recorder(pt, "raytrace", keep=4)
    _cuda.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    with render_timer(r) as timing:
        t0 = time.perf_counter()
        img = scene.finish(spp=MAIN_SPP, save=False)
        torch.cuda.synchronize()
        finish_s = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    rec_pt.restore()
    rec_bl.restore()
    rec_b1.restore()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    per_spp_ms = timing["render_s"] / MAIN_SPP * 1e3
    print(f"main path: Scene.finish(spp={MAIN_SPP}) at {w}x{h}, "
          f"samples_per_launch={r.cfg.samples_per_launch}, finish "
          f"{finish_s:.2f} s, per_spp_ms {per_spp_ms:.3f}, setup_s "
          f"{setup_s:.3f}, peak {peak_gb:.2f} GB, launches {launches}",
          flush=True)
    if img.shape != (w, h, 3) or not np.isfinite(img).all():
        fail("image is not finite or has the wrong shape")
    if float(img.std()) <= 1e-4:
        fail("image is constant")
    for kname in ("traverse", "traverse_compact", "traverse_nee",
                  "point_fetch", "bilinear_fetch_dirs", "shade", "draws",
                  "hit_prepare", "hit_merge"):
        if launches[kname] <= 0:
            fail(f"kernel {kname} was not launched on the main path")
    # a launch: B2 once (the escape sky), B3 at directions twice (the cone
    # centre's NEE transmittance, once for every depth of the shade kernel,
    # and the escape's), and the shade kernel, kernel D and kernel H's two
    # stages at each depth
    n_launch = MAIN_SPP // MAIN_SPL
    want = dict(point_fetch=n_launch, bilinear_fetch=0,
                bilinear_fetch_dirs=2 * n_launch, bilinear_fetch_dirs2=0,
                shade=r.cfg.max_ray_depth * n_launch,
                draws=r.cfg.max_ray_depth * n_launch,
                hit_prepare=r.cfg.max_ray_depth * n_launch,
                hit_merge=r.cfg.max_ray_depth * n_launch)
    for kname, v in want.items():
        if launches[kname] != v:
            fail(f"main path: {launches[kname]} {kname} launches, expected "
                 f"{v}")
    print(f"image: mean {img.mean():.4f} std {img.std():.4f}", flush=True)

    # -- 5. B1 kernel vs twin on the main path's own dispatches ---------------
    # The last launch's four depths, 14.7M rays each (16 samples of
    # 921,600): depth 0 is the primary wavefront with in-kernel NEE, depths
    # 1-3 the bounce wavefronts; the twin runs one sample at a time, on
    # B1_TWIN_SAMPLES of the 16. Every output must be bit-equal, with the
    # config's sun_mode and with 'off'.
    b1 = []
    for depth, call in enumerate(rec_b1.calls):
        c = b1_check(call, chunk=w * h, max_chunks=B1_TWIN_SAMPLES)
        b1.append(c)
        print(f"B1 depth {depth}: {json.dumps(c)}", flush=True)
        if not c["ok"]:
            fail(f"B1 at depth {depth} disagrees with its twin")
    del rec_b1

    # -- 6. steady state and where the device time goes -------------------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.render(spp=MAIN_SPP)
    torch.cuda.synchronize()
    steady_ms = (time.perf_counter() - t0) / MAIN_SPP * 1e3
    prof = profile_launch(r, steady_ms * r.cfg.samples_per_launch)
    print(f"steady state: per_spp_ms {steady_ms:.3f} over {MAIN_SPP} "
          f"more spp; {prof['kernels']} kernels a still launch; one launch "
          f"profiled (idle share against the unprofiled launch): "
          f"{json.dumps(prof)}", flush=True)
    if prof["by_group_ms"]["traverse_kernel"] <= 0.0:
        fail("the profiled launch shows no B1 device time")

    # -- 7. B2 / B3 kernel vs twin on main-path inputs -------------------------
    b2 = b2_check(*rec_pt.calls[-1][0])
    print(f"B2: {json.dumps(b2)}", flush=True)
    if not b2["ok"]:
        fail("B2 disagrees with its twin")

    # B3's three entries, every output by its int32 bits: the main path's
    # own call (the cone centre, one lane), then a million random directions
    # (the edge cases first) through each entry, and B3's texel-coordinate
    # entry at those directions' coordinates and at random ones
    from voxelrt_torch.ops.v3 import V3

    sky6 = r.scene_data.sky
    (tab3, d1, res3), kw1 = rec_bl.calls[-1]
    g = torch.Generator(device="cpu").manual_seed(3)
    dm = torch.nn.functional.normalize(
        torch.randn((1 << 20, 3), generator=g), dim=1)
    dm[:len(EDGE_DIRS)] = torch.tensor(EDGE_DIRS)
    dm = dm.to(dev)
    um = torch.rand((1 << 20, 3), generator=g).to(dev)
    dmv, umv = V3(dm[:, 0], dm[:, 1], dm[:, 2]), V3(um[:, 0], um[:, 1],
                                                     um[:, 2])
    fxm = (torch.rand(1 << 20, generator=g) * (res3 + 4) - 2).to(dev)
    fym = (torch.rand(1 << 20, generator=g) * (res3 + 4) - 2).to(dev)
    fx1, fy1 = tf.texel_coords(d1, res3)
    b3_cases = {
        "dirs_n1": ("bilinear_fetch_dirs", (tab3, d1, res3), kw1),
        "dirs_n1M": ("bilinear_fetch_dirs", (sky6.packed_trans, dmv, res3),
                     {}),
        "dirs_jitter_n1M": ("bilinear_fetch_dirs",
                            (sky6.packed_scatt, dmv, res3, umv), {}),
        "dirs2_n1M": ("bilinear_fetch_dirs2",
                      (sky6.packed_scatt, sky6.packed_trans, sky6.packed_st,
                       dmv, res3, umv), {}),
        "packed_n1": ("bilinear_fetch_packed",
                      (tab3, fx1.contiguous(), fy1.contiguous(), res3), {}),
        "packed_n1M": ("bilinear_fetch_packed", (tab3, fxm, fym, res3), {})}
    b3 = {}
    for tag, (name, args, kw) in b3_cases.items():
        b3[tag] = b3_check(name, args, kw)
        print(f"B3 {tag}: {json.dumps(b3[tag])}", flush=True)
        if not b3[tag]["ok"]:
            fail(f"B3 ({tag}) is not bit-equal to its twin")
    del b3_cases, dm, um, dmv, umv

    # -- 7b. kernel S vs twin on the main path's own state ---------------------
    # Each depth of a 16-sample launch of the main path's renderer, 14.7M
    # lanes, its state taken as it enters the shading on the eager route;
    # kernel S and the twin shade it from the same copy.
    from tools import shade_kernel_torch as skt

    shade = []
    for depth in range(r.cfg.max_ray_depth):
        c = skt.run_depth(r, depth, reps=10)
        c["ok"] = (c["lanes_differ"] <= c["lanes"] // 1000
                   and c["worst_rel"] <= 1e-5 and c["dead_changed"] == 0)
        shade.append(c)
        print(f"S depth {depth}: {json.dumps(c)}", flush=True)
        if not c["ok"]:
            fail(f"kernel S at depth {depth} disagrees with its twin")
    torch.cuda.empty_cache()

    # -- 7c. kernel D vs Pcg3dDraws on the main path's own keys ---------------
    draws = phase_draws(r)
    for c in draws:
        print(f"D {c['res']}: {json.dumps(c)}", flush=True)
        if not c["ok"]:
            fail(f"kernel D at {c['res']} is not bit-equal to Pcg3dDraws")

    # -- 7d. kernel H vs the eager glue of next_hit on a depth-1 state ---------
    hit = phase_hit(r)
    for c in hit:
        print(f"H {c['lanes']}: {json.dumps(c)}", flush=True)
        if not c["ok"]:
            fail(f"kernel H at {c['lanes']} lanes is not bit-equal to the "
                 "eager next_hit")

    # -- 8. small render: card path vs the plain CPU path ----------------------
    small = {}
    for d in ("cuda", "cpu"):
        s = build_example("example6", d, image_res=(128, 72),
                          samples_per_launch=2)
        small[d] = s.finish(spp=4, save=False)
    rmse = float(np.sqrt(np.mean((small["cuda"] - small["cpu"]) ** 2)))
    print(f"small render (example6 128x72, 4 spp): card vs CPU path RMSE "
          f"{rmse:.3e}", flush=True)
    # The CPU path is held to the JAX package at an RMSE of 1e-4
    # (tests/test_torch_scene.py); the card path is held to the CPU path at
    # the same bar: the two run the same operations and differ only in
    # float32 last bits.
    if not rmse < 1e-4:
        fail("card render disagrees with the CPU path")

    # -- 9. the moving path at full width: Scene.run_frames ---------------------
    # A fresh example6 Scene with its default config (one sample per
    # launch), the camera path of tools/camera_path_bench.py: 24 moving
    # frames (640x360 active, B4 twice a frame), then 6 still ones.
    from voxelrt_torch.render import temporal

    mscene = build_example("example6", None)
    mr = mscene.renderer
    # B4's routes over every moving frame: blocks, blocks whose history box
    # overflowed shared memory, lanes that gathered from global memory,
    # texels staged
    b4_routes = torch.zeros(4, dtype=torch.int32, device=dev)
    rec_b4 = Recorder(temporal, "temporal_taps", keep=2,
                      inject=dict(counts=b4_routes))
    # the frames phase 30 holds to the JAX package's goldens (counted from 1)
    path_frames = {}

    def keep_frame(i, frame):
        if i + 1 in PATH_GOLDENS:
            path_frames[i + 1] = np.array(frame)

    try:
        mimg, mfig = drive_camera_path(mscene, "moving path", keep_frame)
    finally:
        rec_b4.restore()
    path_s, mlaunches, mpeak_gb = (mfig[k] for k in ("path_s", "launches",
                                                     "peak_gb"))
    walls = mfig["walls"]
    moving_frame_ms = mfig["moving_frame_ms"]
    still_frame_ms = mfig["still_frame_ms"]
    print(f"moving path: Scene.run_frames, {N_MOVING} moving + {N_STILL} "
          f"still frames at {w}x{h} (moving: 640x360 active), "
          f"samples_per_launch={mr.cfg.samples_per_launch}, "
          f"motion_filter={mr.cfg.motion_filter}, {path_s:.2f} s with "
          f"set-up, moving_frame_ms {moving_frame_ms:.3f}, still_frame_ms "
          f"{still_frame_ms:.3f}, first moving frame {walls[0]:.1f} ms, "
          f"peak {mpeak_gb:.2f} GB, launches {mlaunches}", flush=True)
    if mimg.shape != (w, h, 3) or not np.isfinite(mimg).all():
        fail("moving path: image is not finite or has the wrong shape")
    if float(mimg.std()) <= 1e-4:
        fail("moving path: image is constant")
    if mlaunches["temporal_taps"] != 2 * N_MOVING:
        fail(f"moving path: {mlaunches['temporal_taps']} B4 launches, "
             f"expected {2 * N_MOVING}")
    for kname in ("traverse", "point_fetch"):
        if mlaunches[kname] <= 0:
            fail(f"kernel {kname} was not launched on the moving path")

    blocks, box_h, lanes_h, staged = b4_routes.tolist()
    b4_path_routes = dict(
        blocks=blocks, box_overflow_block_share=box_h / blocks,
        global_lane_share=lanes_h / (2 * N_MOVING * w * h),
        texels_staged_per_block=staged / max(blocks - box_h, 1))
    print(f"B4 routes over the {N_MOVING} moving frames: "
          f"{json.dumps(b4_path_routes)}", flush=True)

    # -- 10. B4 kernel vs twin on the last moving frame's own calls ------------
    # Diffuse pass (depth gate, no extra) and specular pass (extra, no depth
    # gate), as recorded (Catmull-Rom) and with the bilinear taps; then the
    # diffuse call with the reprojection of the left half of the frame
    # scattered over the region (a sudden turn), which overflows those
    # blocks' boxes and sends them to the global route. Every output must be
    # bit-equal to the twin's.
    if len(rec_b4.calls) != 2:
        fail("moving path: B4's calls were not recorded")
    b4 = {}
    for (cargs, ckw), tag in zip(rec_b4.calls, ("diffuse", "specular")):
        if len(cargs) != 10 or set(ckw) != {"catmullrom", "gate_depth"}:
            fail("B4 was called in a form this script does not know")
        if not (ckw["catmullrom"] and ckw["gate_depth"] == (tag == "diffuse")
                and (cargs[5] is None) == (tag == "diffuse")):
            fail(f"B4's recorded call is not the {tag} pass")
        for cat in (True, False):
            name = f"{tag}_{'catmullrom' if cat else 'bilinear'}"
            b4[name] = b4_check(cargs, dict(ckw, catmullrom=cat))
            print(f"B4 {name}: {json.dumps(b4[name])}", flush=True)
            if not b4[name]["ok"]:
                fail(f"B4 ({name}) is not bit-equal to its twin")
    cargs, ckw = rec_b4.calls[0]
    g = torch.Generator(device="cpu").manual_seed(6)
    turned = cargs[7].clone()
    turned[:w // 2, :, :2] = (torch.rand((w // 2, h, 2), generator=g) * 1.2
                              - 0.1).to(dev)
    b4["synthetic_turn"] = b4_check(cargs[:7] + (turned,) + cargs[8:], ckw)
    print(f"B4 synthetic_turn: {json.dumps(b4['synthetic_turn'])}",
          flush=True)
    if not b4["synthetic_turn"]["ok"]:
        fail("B4 (synthetic turn) is not bit-equal to its twin")
    if not b4["synthetic_turn"]["box_overflow_blocks"] > 0:
        fail("the synthetic turn did not send B4 to its global route")
    del rec_b4, cargs, turned

    # -- 11. one moving frame under the sync check, then profiled ----------------
    # Two moving frames first, so that the next reprojects a real history;
    # then the camera moves once more. One moving frame's device work
    # (pipeline.accumulate: the wavefront, B1-B4 and the temporal filters;
    # the frame's matrices are uploaded before it) runs with any host
    # synchronisation an error, then the frame is profiled.
    from voxelrt_torch.ops import prng
    from voxelrt_torch.render import pipeline

    mr.run_frames([dict(MOVE), dict(MOVE)], fetch_final=False)
    mscene.camera.orbit(*MOVE["orbit"])
    sparams = mr._params(50.0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pipeline.accumulate(mr.cfg, mr.scene_data, sparams, mr.state,
                            prng.fold_in(mr.key, 10_000), True, 0.5)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    del sparams
    mprof = profile_launch(mr, moving_frame_ms, moving=True)
    print(f"moving frame: its accumulate ran with host synchronisation an "
          f"error; {mprof['kernels']} kernels a moving frame; profiled (idle "
          f"share against phase 9's unprofiled moving_frame_ms): "
          f"{json.dumps(mprof)}", flush=True)
    if mprof["by_group_ms"]["taps_kernel"] <= 0.0:
        fail("the profiled moving frame shows no B4 device time")

    # -- 12. the viewer, over HTTP, on the card ----------------------------------
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    view = viewer_visit(mscene, 20, os.path.join(HERE, "chiprun_out",
                                                   "viewer_stats.csv"))
    print(f"viewer: {json.dumps(view)}", flush=True)
    del mr, mscene

    # -- 13. small moving path: card vs the plain CPU path -----------------------
    spath = {}
    for d in ("cuda", "cpu"):
        spath[d], _ = run_path(build_example("example6", d, image_res=(128, 72)),
                               [MOVE] * 3 + [HOLD] * 2)
    far = [float((np.abs(a - b) > 2e-3).any(-1).mean())
           for a, b in zip(spath["cuda"][:3], spath["cpu"][:3])]
    srmse = [float(np.sqrt(np.mean((a - b) ** 2)))
             for a, b in zip(spath["cuda"][3:], spath["cpu"][3:])]
    print(f"small moving path (example6 128x72, 3 moving + 2 still): card "
          f"vs CPU path, share of pixels beyond 2e-3 per moving frame {far}, "
          f"RMSE per still frame {srmse}", flush=True)
    # The bars the CPU path meets against the JAX package
    # (tests/test_torch_frames.py).
    if max(far) > 0.01 or not max(srmse) < 1e-4:
        fail("card moving path disagrees with the CPU path")

    del r, scene
    torch.cuda.empty_cache()

    # -- 14. the explicit shadow dispatch, bilinear sky, per-ray NEE ------------
    shadow = phase_shadow_path(steady_ms)

    # -- 15. the probe -----------------------------------------------------------
    probe = phase_probe()

    # -- 18-21. ReSTIR-PT, the sorted route and the table draws ----------------
    # (before the sky precompute, after which torch.profiler sees no kernel)
    phase_s = {}

    def timed(tag, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[tag] = time.perf_counter() - t0
        return out

    restir = timed("18", phase_restir, steady_ms)
    routes = timed("19", phase_routes)
    restir_small = timed("20", phase_restir_small)
    restir_quality = timed("21", phase_restir_quality)
    print(f"phases 18-21, seconds each: {json.dumps(phase_s)}", flush=True)

    # -- 22-25. checkpoint/resume, the native runtime, the portable
    # traversal, multi-device rendering ------------------------------------
    # (each phase's launches counted from 0; phase 24's include its timed
    # calls)
    phase_launches = {}

    def counted(tag, fn, *args):
        _cuda.reset_launch_counts()
        out = timed(tag, fn, *args)
        phase_launches[tag] = {k: v for k, v in _cuda.LAUNCHES.items() if v}
        return out

    with tempfile.TemporaryDirectory() as tmp:
        checkpoint = counted("22", phase_checkpoint, tmp)
        native_rt = counted("23", phase_native, tmp)
    portable = counted("24", phase_portable)
    multidevice = counted("25", phase_multidevice, torch.device("cuda", 0),
                          smi)

    # -- 26-28. bench_torch.py, the trace bench, the multichip report -------
    # (before the sky, after which torch.profiler sees no kernel; phase 26's
    # launches are its process's own, from its info dict)
    bench = timed("26", phase_bench, smi)
    phase_launches["26"] = dict(bench["info"]["launches"])
    trace_bench = counted("27", phase_trace_bench, smi)
    multichip = counted("28", phase_multichip_report,
                        torch.device("cuda", 0), smi)

    # -- 29. example6 at full width against the JAX package's golden --------
    fullres = counted("29", phase_fullres_golden, smi)
    report_golden("29", f"example6, {FULLRES_SPL} spp in one launch, "
                  f"Scene.finish {fullres['finish_s']:.2f} s", fullres)

    # -- 30-31. the camera path and ReSTIR against the JAX package's goldens
    t0 = time.perf_counter()
    path_golden = phase_path_golden(
        path_frames, {k: v for k, v in mlaunches.items() if v}, smi)
    phase_s["30"] = time.perf_counter() - t0
    for n, out in path_golden.items():
        report_golden("30", f"example6's camera path, frame {n} of phase 9 "
                      f"({'moving' if out['moving'] else 'still'})", out)
    restir_golden = counted("31", phase_restir_golden, smi)
    report_golden("31", f"example6 with ReSTIR-PT, {RESTIR_GOLDEN_SPP} spp, "
                  f"Scene.finish {restir_golden['finish_s']:.2f} s",
                  restir_golden)

    # -- 32. example6's sky computed on the card, against the JAX package's
    sky_golden = timed("32", phase_sky_golden, smi)
    phase_launches["32"] = sky_golden["render"]["launches"]
    report_sky_golden(sky_golden)

    # -- 33. example2 with ReSTIR against the JAX package's golden -----------
    restir2_golden = counted("33", phase_restir_example2_golden, smi)
    report_golden("33", f"example2 with ReSTIR-PT, {RESTIR_GOLDEN_SPP} spp, "
                  f"Scene.finish {restir2_golden['finish_s']:.2f} s",
                  restir2_golden)

    # -- 34. example6 at the reference's 1920x1080 against the JAX package's
    # (its launches: the still launch's and the camera path's, each counted
    # from 0 around it)
    ref_res = timed("34", phase_ref_res, smi)
    phase_launches["34"] = dict(collections.Counter(
        ref_res["still"]["launches"]) + collections.Counter(
        ref_res["path_launches"]))
    report_ref_res(ref_res)

    # -- 16. example7's sky on the card, against the JAX package's ------------
    with tempfile.TemporaryDirectory() as sky_cache:
        sky = counted("16", phase_sky, sky_cache)
    report_sky(sky)

    print(f"phases 22-34 and 16, seconds each: "
          f"{json.dumps({k: phase_s[k] for k in [*map(str, range(22, 35)), '16']})}"
          f", launches: {json.dumps(phase_launches)}", flush=True)

    # -- 17. every example against the JAX package's golden ------------------
    examples = timed("17", phase_examples, smi)
    # the scenes' own launches, each counted from 0 around its render
    ex_launches = dict(sum((collections.Counter(e["launches"])
                            for e in examples), collections.Counter()))
    phase_launches["17"] = ex_launches
    print(f"examples: {len(examples)} scenes at 1280x720, {EXAMPLE_SPP} spp, "
          f"{sum(e['setup_s'] + e['render_s'] for e in examples):.1f} s of "
          f"set-up and render, phase {phase_s['17']:.1f} s, "
          f"launches {json.dumps(ex_launches)}", flush=True)

    if "jax" in sys.modules or "voxelrt" in sys.modules:
        fail("the port imported jax or the voxelrt package")

    rk = ref_res["kernels"]
    b1_all = b1 + shadow["b1_closest"] + shadow["b1_shadow"] + [
        restir["b1"]] + [v["b1_depth1"] for v in routes["routes"].values()
                         ] + rk["b1"]
    b3_all = list(b3.values()) + shadow["b3"] + [restir["b3"]] + [
        v["b3"] for v in routes["routes"].values()] + [rk["b3"]]
    b4_all = list(b4.values()) + list(rk["b4"].values())
    check_keys = ("n", "device_ms", "ms_with_wrapper", "plain_ms",
                  "bound_ms", "bound_by")
    kernels = [
        dict(name="B1 traverse", route="cuda", source="voxelrt_torch/csrc/dda.cu",
             replaces="voxelrt/ops/dda_pallas.py:194",
             launches=launches["traverse"],
             max_abs_err=max(c["max_abs_err"] for c in b1_all),
             mismatch_frac=max(c["mismatch_frac"] for c in b1_all),
             ms=b1[0]["device_ms"], ms_with_wrapper=b1[0]["ms_with_wrapper"],
             plain_ms=b1[0]["plain_ms"],
             bound_ms=b1[0]["bound_ms"], bound_by=b1[0]["bound_by"],
             library_ms=None,
             shape=f"{b1[0]['n']} rays + NEE (depth 0 of a launch)",
             depth_ms=[c["device_ms"] for c in b1],
             depth_ms_with_wrapper=[c["ms_with_wrapper"] for c in b1],
             depth_by_pass_ms=prof["b1_by_pass_ms"],
             depth_plain_ms=[c["plain_ms"] for c in b1],
             depth_bound_ms=[c["bound_ms"] for c in b1],
             depth_bound_by=[c["bound_by"] for c in b1],
             depth_alive=[c["alive"] for c in b1],
             depth_nee_marched=[c["nee_marched"] for c in b1],
             depth_nee_settled=[c["nee_settled"] for c in b1],
             sun_off_ms=[c["sun_off_ms"] for c in b1],
             pass_launches={k: launches[k] for k in (
                 "traverse_compact", "traverse", "traverse_nee")},
             shadow_launches=shadow["launches"]["traverse_shadow"],
             shadow_pass_launches={k: shadow["launches"][k] for k in (
                 "traverse_compact", "traverse", "traverse_shadow",
                 "traverse_nee")},
             shadow_mismatched=sum(c["mismatched"]
                                   for c in shadow["b1_shadow"]),
             shadow_max_abs_err=max(c["max_abs_err"]
                                    for c in shadow["b1_shadow"]),
             shadow_ms=[c["device_ms"] for c in shadow["b1_shadow"]],
             shadow_ms_with_wrapper=[c["ms_with_wrapper"]
                                     for c in shadow["b1_shadow"]],
             shadow_sun_off_ms=[c["sun_off_ms"] for c in shadow["b1_shadow"]],
             shadow_alive=[c["alive"] for c in shadow["b1_shadow"]],
             shadow_plain_ms=[c["plain_ms"] for c in shadow["b1_shadow"]],
             shadow_bound_ms=[c["bound_ms"] for c in shadow["b1_shadow"]],
             shadow_bound_by=[c["bound_by"] for c in shadow["b1_shadow"]],
             shadow_path_closest_mismatched=sum(
                 c["mismatched"] for c in shadow["b1_closest"]),
             shadow_path_closest_ms=[c["device_ms"]
                                     for c in shadow["b1_closest"]],
             shadow_path_closest_ms_with_wrapper=[
                 c["ms_with_wrapper"] for c in shadow["b1_closest"]],
             shadow_path_closest_alive=[c["alive"]
                                        for c in shadow["b1_closest"]],
             shadow_path_closest_plain_ms=[c["plain_ms"]
                                           for c in shadow["b1_closest"]],
             shadow_path_closest_bound_ms=[c["bound_ms"]
                                           for c in shadow["b1_closest"]],
             shadow_path_closest_bound_by=[c["bound_by"]
                                           for c in shadow["b1_closest"]],
             restir_launches=restir["launches"]["traverse"],
             restir_shadow_launches=restir["launches"]["traverse_shadow"],
             restir_revalidation={k: restir["b1"][k] for k in (
                 "n", "alive", "mismatched", "device_ms", "ms_with_wrapper",
                 "plain_ms", "bound_ms", "bound_by", "most_advances_of_a_ray",
                 "advance_cap")},
             route_launches={k: v["launches"]["traverse"]
                             for k, v in routes["routes"].items()},
             route_depth1={k: {f: v["b1_depth1"][f] for f in (
                 "n", "alive", "mismatched", "device_ms", "ms_with_wrapper",
                 "plain_ms", "bound_ms", "bound_by")}
                 for k, v in routes["routes"].items()},
             sorted_unsorted_back_mismatched=routes["routes"]["sort_rays"][
                 "unsorted_back_mismatched"],
             ref_res_depths=[{f: c[f] for f in check_keys + (
                 "compared_from", "compared", "alive", "mismatched",
                 "most_advances_of_a_ray")} for c in rk["b1"]],
             trace_bench={k: {f: v[f] for f in (
                 "n", "hits", "mode", "device_ms", "mrays_per_s", "bound_ms",
                 "bound_by", "bound_share", "advances", "twin_rays",
                 "twin_mismatched")} | {
                 "slowest_warp": {f: v["warp"][f] for f in (
                     "slowest_mean", "slowest_p99", "slowest_max",
                     "lost_share")}}
                 for k, v in trace_bench.items()}),
        dict(name="B2 point_fetch_words", route="cuda",
             source="voxelrt_torch/csrc/texfetch.cu",
             replaces="voxelrt/ops/texfetch.py:156",
             launches=launches["point_fetch"],
             max_abs_err=float(b2["unequal"] + restir["b2"]["unequal"]
                               + rk["b2"]["unequal"]),
             ms=b2["device_ms"], ms_with_wrapper=b2["ms_with_wrapper"],
             plain_ms=b2["plain_ms"], bound_ms=b2["bound_ms"],
             bound_by="bytes", library_ms=b2["library_ms"],
             shape=f"{b2['n']} indices",
             restir_launches=restir["launches"]["point_fetch"],
             restir_inline_fetch=restir["b2"],
             ref_res_fetch={f: rk["b2"][f] for f in check_keys[:-1] + (
                 "unequal", "library_ms")},
             route_launches={k: v["launches"]["point_fetch"]
                             for k, v in routes["routes"].items()}),
        dict(name="B3 bilinear_fetch_dirs", route="cuda",
             source="voxelrt_torch/csrc/texfetch.cu",
             replaces="voxelrt/ops/texfetch.py:59",
             launches=launches["bilinear_fetch_dirs"],
             max_abs_err=max(c["max_abs_err"] for c in b3_all),
             unequal=sum(c["unequal"] for c in b3_all),
             ms=b3["dirs_n1"]["device_ms"],
             ms_with_wrapper=b3["dirs_n1"]["ms_with_wrapper"],
             plain_ms=b3["dirs_n1"]["plain_ms"],
             bound_ms=b3["dirs_n1"]["bound_ms"],
             bound_by=b3["dirs_n1"]["bound_by"], library_ms=None,
             shape="1 lane (main path: the cone centre's transmittance)",
             variant_ms={k: c["device_ms"] for k, c in b3.items()},
             variant_ms_with_wrapper={k: c["ms_with_wrapper"]
                                      for k, c in b3.items()},
             variant_plain_ms={k: c["plain_ms"] for k, c in b3.items()},
             variant_bound_ms={k: c["bound_ms"] for k, c in b3.items()},
             coords_entry_launches=launches["bilinear_fetch"],
             wavefront_lanes=shadow["b3"][0]["n"],
             wavefront_launches=shadow["launches"]["bilinear_fetch_dirs"],
             wavefront_ms=[c["device_ms"] for c in shadow["b3"][:-1]],
             wavefront_ms_with_wrapper=[c["ms_with_wrapper"]
                                        for c in shadow["b3"][:-1]],
             wavefront_plain_ms=[c["plain_ms"] for c in shadow["b3"][:-1]],
             wavefront_bound_ms=[c["bound_ms"] for c in shadow["b3"][:-1]],
             restir_launches=restir["launches"]["bilinear_fetch_dirs"],
             restir_gris_call={k: restir["b3"][k] for k in (
                 "n", "texels", "unequal", "device_ms", "ms_with_wrapper",
                 "plain_ms", "bound_ms", "bound_by")},
             route_launches={k: v["launches"]["bilinear_fetch_dirs"]
                             for k, v in routes["routes"].items()},
             ref_res_call={f: rk["b3"][f] for f in check_keys + (
                 "unequal",)}),
        dict(name="B3 bilinear_fetch_dirs2", route="cuda",
             source="voxelrt_torch/csrc/texfetch.cu",
             replaces="voxelrt/ops/texfetch.py:59",
             launches=shadow["launches"]["bilinear_fetch_dirs2"],
             max_abs_err=max(shadow["b3"][-1]["max_abs_err"],
                             b3["dirs2_n1M"]["max_abs_err"]),
             unequal=shadow["b3"][-1]["unequal"]
             + b3["dirs2_n1M"]["unequal"],
             ms=shadow["b3"][-1]["device_ms"],
             ms_with_wrapper=shadow["b3"][-1]["ms_with_wrapper"],
             plain_ms=shadow["b3"][-1]["plain_ms"],
             bound_ms=shadow["b3"][-1]["bound_ms"],
             bound_by=shadow["b3"][-1]["bound_by"], library_ms=None,
             shape=f"{shadow['b3'][-1]['n']} lanes (path A' escape fetch, "
                   "both maps; launches over its 48 spp)",
             texels=shadow["b3"][-1]["texels"]),
        dict(name="B4 temporal_taps", route="cuda",
             source="voxelrt_torch/csrc/resample.cu",
             replaces="voxelrt/ops/resample.py:128",
             launches=mlaunches["temporal_taps"],
             max_abs_err=max(c["max_abs_err"] for c in b4_all),
             unequal_lanes=sum(c["unequal_lanes"] for c in b4_all),
             ms=b4["diffuse_catmullrom"]["device_ms"],
             ms_with_wrapper=b4["diffuse_catmullrom"]["ms_with_wrapper"],
             plain_ms=b4["diffuse_catmullrom"]["plain_ms"],
             bound_ms=b4["diffuse_catmullrom"]["bound_ms"],
             bound_by=b4["diffuse_catmullrom"]["bound_by"],
             library_ms=None,
             shape=f"{b4['diffuse_catmullrom']['m']} lanes, "
                   f"{b4['diffuse_catmullrom']['n']} texels (diffuse pass, "
                   "Catmull-Rom)",
             variant_ms={k: c["device_ms"] for k, c in b4.items()},
             variant_ms_with_wrapper={k: c["ms_with_wrapper"]
                                      for k, c in b4.items()},
             variant_plain_ms={k: c["plain_ms"] for k, c in b4.items()},
             variant_bound_ms={k: c["bound_ms"] for k, c in b4.items()},
             path_routes=b4_path_routes,
             ref_res_variants={k: {f: c[f] for f in check_keys + (
                 "m", "unequal_lanes")} for k, c in rk["b4"].items()}),
        dict(name="S shade", route="cuda",
             source="voxelrt_torch/csrc/shade.cu",
             replaces=None,  # the JAX package leaves this block to XLA
             launches=launches["shade"],
             lanes_differ=sum(c["lanes_differ"] for c in shade),
             max_rel_err=max(c["worst_rel"] for c in shade),
             ms=shade[0]["device_ms"],
             ms_with_wrapper=shade[0]["ms_with_wrapper"],
             plain_ms=shade[0]["plain_ms"], bound_ms=shade[0]["bound_ms"],
             bound_by="bytes", library_ms=None,
             shape=f"{shade[0]['lanes']} lanes (depth 0 of a launch)",
             depth_ms=[c["device_ms"] for c in shade],
             depth_ms_with_wrapper=[c["ms_with_wrapper"] for c in shade],
             depth_plain_ms=[c["plain_ms"] for c in shade],
             depth_bound_ms=[c["bound_ms"] for c in shade],
             depth_alive=[c["alive"] for c in shade],
             depth_surf=[c["surf"] for c in shade],
             depth_lanes_differ=[c["lanes_differ"] for c in shade]),
        dict(name="D draws", route="cuda",
             source="voxelrt_torch/csrc/draws.cu",
             replaces=None,  # the JAX package leaves the draws to XLA
             launches=launches["draws"],
             slots_differ=sum(len(c["slots_differ"]) for c in draws),
             ms=draws[0]["device_ms"],
             ms_with_wrapper=draws[0]["ms_with_wrapper"],
             plain_ms=draws[0]["eager_ms"], bound_ms=draws[0]["bound_ms"],
             bound_by="bytes", library_ms=None,
             shape=f"{draws[0]['lanes']} lanes, 8 slots (a depth of a "
                   "launch); the eager fold_in and Pcg3dDraws as plain_ms",
             res_ms={c["res"]: c["device_ms"] for c in draws},
             res_bound_ms={c["res"]: c["bound_ms"] for c in draws},
             res_plain_ms={c["res"]: c["eager_ms"] for c in draws}),
        dict(name="H hit", route="cuda",
             source="voxelrt_torch/csrc/hit.cu",
             replaces=None,  # the JAX package leaves next_hit's glue to XLA
             launches=launches["hit_merge"],
             fields_differ=sum(c["fields_differ"] + c["inputs_differ"]
                               for c in hit),
             ms=hit[0]["device_ms"], ms_with_wrapper=None,
             plain_ms=hit[0]["eager_ms"], bound_ms=hit[0]["bound_ms"],
             bound_by="bytes", library_ms=None,
             shape=f"{hit[0]['lanes']} lanes, a depth-1 state (hit_prepare "
                   "and hit_merge); the eager glue less B1 as plain_ms",
             lanes_ms={c["lanes"]: c["device_ms"] for c in hit},
             lanes_bound_ms={c["lanes"]: c["bound_ms"] for c in hit},
             lanes_plain_ms={c["lanes"]: c["eager_ms"] for c in hit}),
        dict(name="P probe", route="cuda",
             source="voxelrt_torch/csrc/probe.cu",
             replaces="tools/pallas_probe.py:30",
             launches=probe["launches"],
             max_abs_err=max(c["max_abs_err"]
                             for c in probe["checks"].values()),
             max_rel_err=max(c["max_rel_err"]
                             for c in probe["checks"].values()),
             ms=probe["checks"]["fetch"]["device_ms"],
             ms_with_wrapper=probe["checks"]["fetch"]["ms_with_wrapper"],
             plain_ms=probe["checks"]["fetch"]["plain_ms"],
             bound_ms=probe["checks"]["fetch"]["bound_ms"],
             bound_by=probe["checks"]["fetch"]["bound_by"],
             library_ms=None,
             shape=f"{probe['n_blocks']} blocks of (8, 128) lanes, variant "
                   f"fetch, {probe['checks']['fetch']['iters']} iterations "
                   "(the errors are the largest of any variant)",
             variant_ms={k: c["device_ms"]
                         for k, c in probe["checks"].items()},
             variant_ms_with_wrapper={k: c["ms_with_wrapper"]
                                      for k, c in probe["checks"].items()},
             variant_plain_ms={k: c["plain_ms"]
                               for k, c in probe["checks"].items()},
             variant_bound_ms={k: c["bound_ms"]
                               for k, c in probe["checks"].items()},
             variant_ns_per_iter_per_block={
                 k: f["ns_per_iter_per_block"]
                 for k, f in probe["table"].items()},
             variant_loop_ns_per_iter={
                 k: f["loop_ns_per_iter"] for k, f in probe["table"].items()}),
    ]
    # each kernel's launches in phases 16, 17 and 22-34, by its counter
    counter = {"B1 traverse": "traverse", "B2 point_fetch_words": "point_fetch",
               "B3 bilinear_fetch_dirs": "bilinear_fetch_dirs",
               "B3 bilinear_fetch_dirs2": "bilinear_fetch_dirs2",
               "B4 temporal_taps": "temporal_taps", "S shade": "shade",
               "D draws": "draws", "H hit": "hit_merge", "P probe": "probe"}
    for k in kernels:
        k["phase_launches"] = {tag: v.get(counter[k["name"]], 0)
                               for tag, v in phase_launches.items()}
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(dict(kernels=kernels, setup_s=setup_s,
                       per_spp_ms=per_spp_ms, launches=launches,
                       samples_per_launch=MAIN_SPL,
                       peak_gb=peak_gb, small_rmse=rmse, device=smi,
                       steady_per_spp_ms=steady_ms, profile=prof,
                       b1_depths=b1, b3=b3, shade=shade, draws=draws,
                       hit=hit,
                       moving_frame_ms=moving_frame_ms,
                       still_frame_ms=still_frame_ms, moving_wall_ms=walls,
                       moving_launches=mlaunches, moving_peak_gb=mpeak_gb,
                       b4=b4, moving_profile=mprof, viewer=view,
                       small_path_far=far, small_path_rmse=srmse,
                       sky=sky, examples=examples,
                       example_launches=ex_launches, shadow_path=shadow,
                       probe=probe, restir_path=restir, routes=routes,
                       restir_small=restir_small,
                       restir_quality=restir_quality,
                       restir_phase_s=phase_s, checkpoint=checkpoint,
                       native=native_rt, portable_traversal=portable,
                       multidevice=multidevice,
                       new_phase_launches=phase_launches, bench=bench,
                       trace_bench=trace_bench, multichip_report=multichip,
                       fullres_golden=fullres, path_golden=path_golden,
                       restir_golden=restir_golden, sky_golden=sky_golden,
                       restir_example2_golden=restir2_golden,
                       ref_res=ref_res),
                  fh, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
