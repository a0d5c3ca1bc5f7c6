"""Smoke run of the PyTorch port on one CUDA card: build the kernels, hold
each against its plain PyTorch twin at main-path shapes, and drive the
example6 scene (terrain, trees, physical sky + clouds, sun) at 1280x720
through ``Scene.finish`` (still frames), ``Scene.run_frames`` (a moving
camera path) and the browser viewer.

    python3 chip_smoke.py

Phases, each printing its own line: 1 device, 2 build, 3 scene set-up, 4 the
still path (64 spp at 16 samples per launch, the launch counters set to 0
just before it and read just after), 5 B1 against its twin on that path's
own four dispatches, 6 the steady-state rate and a profiled launch, 7 B2 and
B3 against their twins on main-path inputs, 8 a small-render check of the
card path against the CPU path; 9 the moving path (24 moving frames at
640x360 active, then 6 still frames, counters set to 0 just before and read
just after), 10 B4 against its twin on the last moving frame's own two
calls, with both tap filters, 11 a profiled moving frame, 12 the viewer
driven over HTTP, 13 a small moving-path check of the card against the
CPU; then the kernels JSON line, the card's name and power limit, and the
result line ``{"ok": true, "device": {...}}`` last. Details go to
``chiprun_out/chip_smoke.json``. Any failure exits non-zero before the
result line. Without a CUDA card it exits 1 at once.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM non-tensor float32, NVIDIA data sheet
MAIN_SPP = 64
MAIN_SPL = 16
# The camera path of tools/camera_path_bench.py: orbit + dolly, then hold.
MOVE = {"orbit": (0.01, 0.002), "move_keys": ["w"], "dt": 0.02}
HOLD = {"dt": 0.02}
N_MOVING, N_STILL = 24, 6


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


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


class Recorder:
    """Wraps a module attribute to keep the arguments of its last ``keep``
    calls."""

    def __init__(self, module, name, keep=4):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.calls = []

        def wrapper(*args, **kwargs):
            self.calls = (self.calls + [(args, kwargs)])[-keep:]
            return self.orig(*args, **kwargs)

        setattr(module, name, wrapper)

    def restore(self):
        setattr(self.module, self.name, self.orig)


def build_example6(device, image_res=None, quiet=True):
    """example6's Scene on the port, built without editing examples/: the
    shared ``_common.make_scene`` is replaced before the module is imported."""
    sys.path.insert(0, os.path.join(HERE, "examples"))
    import _common

    from voxelrt_torch.scene import Scene

    def make_scene(argv=None, **kw):
        if image_res is not None:
            kw["image_res"] = image_res
        return Scene(quiet=quiet, device=device, **kw)

    _common.make_scene = make_scene
    sys.modules.pop("example6", None)
    import example6

    example6.initialize_voxels()
    return example6.scene


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


def b1_check(rec_args, chunk, reps=3):
    """B1 kernel vs twin on one recorded main-path dispatch, with the
    test_dda_pallas bar. The kernel runs on the whole dispatch; the twin in
    runs of ``chunk`` rays (one sample's wavefront each), which bounds its
    temporaries. Returns a dict of figures."""
    import torch

    from voxelrt_torch.ops import dda_kernel as dk

    args, kw = rec_args
    tables, rest = args[0], args[1:]
    n = rest[0].x.shape[0]
    k = dk.raytrace(*args, **kw)
    torch.cuda.synchronize()
    tot = dict(mism=0, col_bad=0, vis_agree=0, exact=0, hits=0)
    max_err = 0.0
    plain_ms = 0.0
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        sa = [_ray_slice(a, n, lo, hi) for a in rest]
        skw = {name: _ray_slice(v, n, lo, hi) for name, v in kw.items()}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        p = dk.raytrace_plain(tables, *sa, **skw)
        end.record()
        torch.cuda.synchronize()
        plain_ms += start.elapsed_time(end)
        kd = k.distance[lo:hi]
        hk, hp = torch.isfinite(kd), torch.isfinite(p.distance)
        same_cell = torch.stack([a[lo:hi] == b
                                 for a, b in zip(k.ipos, p.ipos)]).all(0)
        same_n = torch.stack([a[lo:hi] == b
                              for a, b in zip(k.normal, p.normal)]).all(0)
        both = hk & hp
        dd = torch.where(both, (kd - p.distance).abs(), torch.zeros_like(kd))
        mism = (hk != hp) | (both & (dd > 1e-2)) | (both & same_cell & ~same_n)
        tot["mism"] += int(mism.sum().item())
        tot["col_bad"] += int((both & same_cell & (k.color_word[lo:hi]
                                                   != p.color_word)).sum().item())
        if k.nee_visible is not None:
            tot["vis_agree"] += int((k.nee_visible[lo:hi]
                                     == p.nee_visible).sum().item())
        exact = ((kd == p.distance) | (~hk & ~hp)) & same_cell & same_n
        tot["exact"] += int(exact.sum().item())
        tot["hits"] += int(hk.sum().item())
        max_err = max(max_err, dd.max().item())
        del p
    vis_agree = tot["vis_agree"] / n if k.nee_visible is not None else 1.0
    out = dict(n=n, alive=int((kw["alive"] != 0).sum().item()),
               mismatch_frac=tot["mism"] / n, color_mismatch=tot["col_bad"],
               nee_visible_agree=vis_agree, exact_frac=tot["exact"] / n,
               max_abs_err=max_err, hits=tot["hits"],
               sum_iters=int(k.iters.to(torch.int64).sum().item()))
    out["ok"] = (out["mismatch_frac"] <= 0.01 and tot["col_bad"] == 0
                 and vis_agree >= 0.99)
    out["ms"] = cuda_ms(lambda: dk.raytrace(*args, **kw), reps)
    out["plain_ms"] = plain_ms
    out["bound_ms"], out["bound_by"] = b1_bound_ms(args, kw, out["alive"],
                                                   out["sum_iters"])
    return out


def b1_bound_ms(args, kw, n_alive, sum_iters):
    """B1's least time for one dispatch, from this dispatch's data.

    Bytes: the alive mask for every ray; origin, direction, a per-ray tmax
    and the NEE inputs (u0, u1, alt_t) only for the alive rays, since a dead
    ray reads nothing more; tmin and the NEE scalars once; the tables once;
    every output (distance, ipos, normal, iters, colour, active, and
    nee_visible with NEE) once for every ray. Operations: ~60 float32
    operations per traversal advance (csrc/dda.cu march step), times the
    advances that this dispatch's primaries took."""
    from voxelrt_torch.ops.dda_kernel import DeviceTables

    tables, n = args[0], args[1].x.shape[0]
    alive, nee, tmax = kw.get("alive"), kw.get("nee"), args[4]
    per_alive = 4 * 6
    if hasattr(tmax, "numel") and tmax.numel() == n:
        per_alive += 4
    if nee is not None:
        per_alive += 4 * 3
    nbytes = (n * (alive.element_size() if alive is not None else 0)
              + n_alive * per_alive
              + n * 4 * (10 + (nee is not None))
              + 4 + (48 if nee is not None else 0)
              + sum(getattr(tables, f).numel() * 4
                    for f in DeviceTables._fields[:-1]))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 60.0 * sum_iters / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def profile_launch(r, launch_wall_ms, moving=False):
    """Device time of one accumulate launch by kernel, from torch.profiler
    tracing the card's activity only: the port's kernels, and everything
    else (PyTorch's own elementwise, indexing and reduction kernels). The
    device's idle share is taken against ``launch_wall_ms``, the wall time
    of an unprofiled launch, since tracing lengthens the launch it traces.
    ``moving``: a moving frame (render scale 0.5, history cap 50) from the
    renderer's current state, whose previous matrices must differ from the
    current ones; else a still launch."""
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
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        pipeline.accumulate(r.cfg, r.scene_data, params, r.state, key,
                            moving, scale)
        torch.cuda.synchronize()
        traced_wall_ms = (time.perf_counter() - t0) * 1e3
    groups = {"traverse_kernel": 0.0, "point_kernel": 0.0,
              "bilinear_kernel": 0.0, "taps_kernel": 0.0, "other": 0.0}
    n_kernels = 0
    top = []
    # Only the device's own events: a runtime entry on the host side would
    # repeat the device time of the kernels it launched.
    for e in p.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = e.self_device_time_total / 1e3
        n_kernels += e.count
        g = next((k for k in groups if k in e.key), "other")
        groups[g] += t
        top.append((t, e.count, e.key[:80]))
    dev_ms = sum(groups.values())
    top.sort(reverse=True)
    return dict(wall_ms=launch_wall_ms, traced_wall_ms=traced_wall_ms,
                device_ms=dev_ms, kernels=n_kernels,
                idle_share=1.0 - dev_ms / launch_wall_ms,
                by_group_ms=groups,
                top_kernels=[dict(ms=t, count=c, name=k) for t, c, k in top[:12]])


def b4_bound_ms(args):
    """B4's least time for one call: every per-lane input read once (fxc,
    fyc, fxh, fyh, centre depth, centre normal: 32 B), every output written
    once (current 12 B, w_sum 4 B, history 16 B, and 4 B of filtered extra
    on the specular pass), and each source table the call reads (current and
    history 2 words each, previous normals, and the depth or the extra
    table) read once at 4 B a texel. The arithmetic (16 taps of about 40
    float32 operations a lane) is counted beside it."""
    cur, hist, pn, pd_lin, extra = args[:5]
    m = args[5].shape[0]
    ires_x, ires_y, catmull, gate_depth = args[11:15]
    n_tables = 5 + int(bool(gate_depth)) + int(extra is not None)
    nbytes = (m * (32 + 32 + (4 if extra is not None else 0))
              + ires_x * ires_y * 4 * n_tables)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = m * (16 if catmull else 4) * 40.0 / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def b4_check(args, reps=10):
    """B4 kernel vs twin on one set of ``temporal_taps`` arguments, both on
    the card: the share of lanes with any output outside 1e-6 relative."""
    import torch

    from voxelrt_torch.ops import resample as rs

    k = rs.temporal_taps(*args)
    p = rs.temporal_taps_plain(*args)
    torch.cuda.synchronize()
    m = args[5].shape[0]
    bad = torch.zeros(m, dtype=torch.bool, device=args[5].device)
    max_err = 0.0
    finite = True
    for a, b in zip(k, p):
        if a is None:
            if b is not None:
                fail("B4 and its twin disagree on the extra output")
            continue
        finite = finite and bool(torch.isfinite(a).all().item())
        far = ~torch.isclose(a, b, rtol=1e-6, atol=1e-9)
        bad |= far.reshape(m, -1).any(-1)
        max_err = max(max_err, (a - b).abs().max().item())
    out = dict(m=m, n=args[11] * args[12], catmullrom=bool(args[13]),
               gate_depth=bool(args[14]), with_extra=args[4] is not None,
               share_outside=bad.float().mean().item(), max_abs_err=max_err,
               finite=finite,
               w_sum_equal=bool(torch.equal(k[1], p[1])),
               has_hist_share=(k[1] > 1e-3).float().mean().item())
    out["ok"] = finite and out["share_outside"] <= 0.001
    out["ms"] = cuda_ms(lambda: rs.temporal_taps(*args), reps)
    out["plain_ms"] = cuda_ms(lambda: rs.temporal_taps_plain(*args), 3)
    out["bound_ms"], out["bound_by"] = b4_bound_ms(args)
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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
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
    scene = build_example6(None)
    import dataclasses

    scene.config = dataclasses.replace(scene.config,
                                       samples_per_launch=MAIN_SPL)
    r = scene.renderer
    r.prepare_data()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    w, h = scene.config.image_res
    print(f"setup: example6 {w}x{h}, {setup_s:.2f} s (world, tables, sky "
          "cache load, upload)", flush=True)

    # -- 4. main path: Scene.finish at 1280x720, spl 16 ------------------------
    rec_pt = Recorder(atmos, "point_fetch_words", keep=1)
    rec_bl = Recorder(atmos, "bilinear_fetch_packed", keep=1)
    rec_b1 = Recorder(pt, "raytrace", keep=4)
    timing = {}
    orig_render = type(r).render

    def timed_render(self, *a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        img = orig_render(self, *a, **k)
        torch.cuda.synchronize()
        timing["render_s"] = time.perf_counter() - t
        return img

    type(r).render = timed_render
    _cuda.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    img = scene.finish(spp=MAIN_SPP, save=False)
    torch.cuda.synchronize()
    finish_s = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    type(r).render = orig_render
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
    for kname in ("traverse", "point_fetch", "bilinear_fetch"):
        if launches[kname] <= 0:
            fail(f"kernel {kname} was not launched on the main path")
    print(f"image: mean {img.mean():.4f} std {img.std():.4f}", flush=True)

    # -- 5. B1 kernel vs twin on the main path's own dispatches ---------------
    # The last launch's four depths, 14.7M rays each (16 samples of
    # 921,600): depth 0 is the primary wavefront with in-kernel NEE, depths
    # 1-3 the bounce wavefronts; the twin runs one sample at a time.
    b1 = []
    for depth, call in enumerate(rec_b1.calls):
        c = b1_check(call, chunk=w * h)
        b1.append(c)
        print(f"B1 depth {depth}: {json.dumps(c)}", flush=True)
        if not c["ok"]:
            fail(f"B1 at depth {depth} disagrees with its twin")
    del rec_b1

    # -- 6. steady state and where the device time goes -------------------------
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.render(spp=2 * MAIN_SPP)
    torch.cuda.synchronize()
    steady_ms = (time.perf_counter() - t0) / (2 * MAIN_SPP) * 1e3
    prof = profile_launch(r, steady_ms * r.cfg.samples_per_launch)
    print(f"steady state: per_spp_ms {steady_ms:.3f} over {2 * MAIN_SPP} "
          f"more spp; one launch profiled (idle share against the "
          f"unprofiled launch): {json.dumps(prof)}", flush=True)

    # -- 7. B2 / B3 kernel vs twin on main-path inputs -------------------------
    (words, wid), _ = rec_pt.calls[-1]
    n2 = wid.shape[0]
    a0, a1 = tf.point_fetch_words(words, wid)
    p0, p1 = tf.point_fetch_words_plain(words, wid)
    b2_err = max((a0 != p0).sum().item(), (a1 != p1).sum().item())
    pairs = words.view(-1, 2)
    b2_ms = cuda_ms(lambda: tf.point_fetch_words(words, wid), 10)
    b2_plain = cuda_ms(lambda: tf.point_fetch_words_plain(words, wid), 10)
    b2_lib = cuda_ms(lambda: pairs[wid >> 1], 10)
    touched = torch.unique(wid).numel()
    b2_bound = (n2 * (4 + 8) + touched * 8) / HBM_BYTES_PER_S * 1e3
    print(f"B2: n {n2}, mismatched words {b2_err}, {touched} distinct texels",
          flush=True)
    if b2_err:
        fail("B2 disagrees with its twin")

    (tab3, fx1, fy1, res3), _ = rec_bl.calls[-1]
    g = torch.Generator(device="cpu").manual_seed(3)
    fxm = (torch.rand(1 << 20, generator=g) * (res3 + 4) - 2).to(dev)
    fym = (torch.rand(1 << 20, generator=g) * (res3 + 4) - 2).to(dev)
    b3 = {}
    for tag, fx, fy in (("n1", fx1, fy1), ("n1M", fxm, fym)):
        ka = tf.bilinear_fetch_packed(tab3, fx, fy, res3)
        pa = tf.bilinear_fetch_packed_plain(tab3, fx, fy, res3)
        err = (ka - pa).abs().max().item()
        rel = ((ka - pa).abs() / pa.abs().clamp(min=1e-30)).max().item()
        n3 = fx.shape[0]
        texels = min(4 * n3, res3 * res3)
        b3[tag] = dict(
            n=n3, max_abs_err=err, max_rel_err=rel,
            ms=cuda_ms(lambda: tf.bilinear_fetch_packed(tab3, fx, fy, res3),
                       10),
            plain_ms=cuda_ms(
                lambda: tf.bilinear_fetch_packed_plain(tab3, fx, fy, res3), 10),
            bound_ms=(n3 * (8 + 12) + texels * 8) / HBM_BYTES_PER_S * 1e3)
        print(f"B3 {tag}: {json.dumps(b3[tag])}", flush=True)
        if rel > 1e-6:
            fail(f"B3 ({tag}) disagrees with its twin")

    # -- 8. small render: card path vs the plain CPU path ----------------------
    small = {}
    for d in ("cuda", "cpu"):
        s = build_example6(d, image_res=(128, 72))
        s.config = dataclasses.replace(s.config, samples_per_launch=2)
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
    from voxelrt_torch.utils.profiling import FrameStats

    mscene = build_example6(None)
    mr = mscene.renderer
    rec_b4 = Recorder(temporal, "temporal_taps", keep=2)
    with open(os.devnull, "w") as null:
        mstats = FrameStats(out=null)
        _cuda.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        mimg = mscene.run_frames(
            [dict(MOVE) for _ in range(N_MOVING)]
            + [dict(HOLD) for _ in range(N_STILL)], stats=mstats)
        torch.cuda.synchronize()
        path_s = time.perf_counter() - t0
        mlaunches = dict(_cuda.LAUNCHES)
    rec_b4.restore()
    mpeak_gb = torch.cuda.max_memory_allocated() / 1e9
    flags = [row["moving"] for row in mstats.rows]
    walls = [row["wall_ms"] for row in mstats.rows]
    mv_ms = sorted(walls[2:N_MOVING])
    st_ms = sorted(walls[N_MOVING + 2:])
    moving_frame_ms = mv_ms[len(mv_ms) // 2]
    still_frame_ms = st_ms[len(st_ms) // 2]
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
    if flags != [True] * N_MOVING + [False] * N_STILL:
        fail(f"moving path: wrong moving flags {flags}")
    if mlaunches["temporal_taps"] != 2 * N_MOVING:
        fail(f"moving path: {mlaunches['temporal_taps']} B4 launches, "
             f"expected {2 * N_MOVING}")
    for kname in ("traverse", "point_fetch"):
        if mlaunches[kname] <= 0:
            fail(f"kernel {kname} was not launched on the moving path")

    # -- 10. B4 kernel vs twin on the last moving frame's own calls ------------
    # Diffuse pass (depth gate, no extra) and specular pass (extra, no depth
    # gate), as recorded (Catmull-Rom) and with the bilinear taps.
    if len(rec_b4.calls) != 2:
        fail("moving path: B4's calls were not recorded")
    b4 = {}
    for (cargs, ckw), tag in zip(rec_b4.calls, ("diffuse", "specular")):
        if len(cargs) != 11 or set(ckw) != {"ires_x", "ires_y", "catmullrom",
                                            "gate_depth"}:
            fail("B4 was called in a form this script does not know")
        if not (ckw["catmullrom"] and ckw["gate_depth"] == (tag == "diffuse")
                and (cargs[4] is None) == (tag == "diffuse")):
            fail(f"B4's recorded call is not the {tag} pass")
        for cat in (True, False):
            a = cargs + (ckw["ires_x"], ckw["ires_y"], cat,
                         ckw["gate_depth"])
            name = f"{tag}_{'catmullrom' if cat else 'bilinear'}"
            b4[name] = b4_check(a)
            print(f"B4 {name}: {json.dumps(b4[name])}", flush=True)
            if not b4[name]["ok"]:
                fail(f"B4 ({name}) disagrees with its twin")
    del rec_b4

    # -- 11. one moving frame profiled -------------------------------------------
    # Two moving frames first, so that the profiled one reprojects a real
    # history; then the camera moves once more.
    mr.run_frames([dict(MOVE), dict(MOVE)], fetch_final=False)
    mscene.camera.orbit(*MOVE["orbit"])
    mprof = profile_launch(mr, moving_frame_ms, moving=True)
    print(f"moving frame profiled (idle share against phase 9's unprofiled "
          f"moving_frame_ms): {json.dumps(mprof)}", flush=True)
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
        spath[d], _ = run_path(build_example6(d, image_res=(128, 72)),
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

    if "jax" in sys.modules or "voxelrt" in sys.modules:
        fail("the port imported jax or the voxelrt package")

    kernels = [
        dict(name="B1 traverse", route="cuda", source="voxelrt_torch/csrc/dda.cu",
             replaces="voxelrt/ops/dda_pallas.py:194",
             launches=launches["traverse"],
             max_abs_err=max(c["max_abs_err"] for c in b1),
             mismatch_frac=max(c["mismatch_frac"] for c in b1),
             ms=b1[0]["ms"], plain_ms=b1[0]["plain_ms"],
             bound_ms=b1[0]["bound_ms"], bound_by=b1[0]["bound_by"],
             library_ms=None,
             shape=f"{b1[0]['n']} rays + NEE (depth 0 of a launch)",
             depth_ms=[c["ms"] for c in b1],
             depth_plain_ms=[c["plain_ms"] for c in b1],
             depth_bound_ms=[c["bound_ms"] for c in b1]),
        dict(name="B2 point_fetch_words", route="cuda",
             source="voxelrt_torch/csrc/texfetch.cu",
             replaces="voxelrt/ops/texfetch.py:156",
             launches=launches["point_fetch"], max_abs_err=float(b2_err),
             ms=b2_ms, plain_ms=b2_plain, bound_ms=b2_bound,
             bound_by="bytes", library_ms=b2_lib, shape=f"{n2} indices"),
        dict(name="B3 bilinear_fetch_packed", route="cuda",
             source="voxelrt_torch/csrc/texfetch.cu",
             replaces="voxelrt/ops/texfetch.py:59",
             launches=launches["bilinear_fetch"],
             max_abs_err=max(b3["n1"]["max_abs_err"],
                             b3["n1M"]["max_abs_err"]),
             ms=b3["n1"]["ms"], plain_ms=b3["n1"]["plain_ms"],
             bound_ms=b3["n1"]["bound_ms"], bound_by="bytes",
             library_ms=None, shape="1 lane (main path)",
             n1M_ms=b3["n1M"]["ms"], n1M_plain_ms=b3["n1M"]["plain_ms"],
             n1M_bound_ms=b3["n1M"]["bound_ms"]),
        dict(name="B4 temporal_taps", route="cuda",
             source="voxelrt_torch/csrc/resample.cu",
             replaces="voxelrt/ops/resample.py:128",
             launches=mlaunches["temporal_taps"],
             max_abs_err=max(c["max_abs_err"] for c in b4.values()),
             share_outside=max(c["share_outside"] for c in b4.values()),
             ms=b4["diffuse_catmullrom"]["ms"],
             plain_ms=b4["diffuse_catmullrom"]["plain_ms"],
             bound_ms=b4["diffuse_catmullrom"]["bound_ms"],
             bound_by=b4["diffuse_catmullrom"]["bound_by"],
             library_ms=None,
             shape=f"{b4['diffuse_catmullrom']['m']} lanes, "
                   f"{b4['diffuse_catmullrom']['n']} texels (diffuse pass, "
                   "Catmull-Rom)",
             variant_ms={k: c["ms"] for k, c in b4.items()},
             variant_plain_ms={k: c["plain_ms"] for k, c in b4.items()},
             variant_bound_ms={k: c["bound_ms"] for k, c in b4.items()}),
    ]
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as fh:
        json.dump(dict(kernels=kernels, setup_s=setup_s,
                       per_spp_ms=per_spp_ms, launches=launches,
                       samples_per_launch=r.cfg.samples_per_launch,
                       peak_gb=peak_gb, small_rmse=rmse, device=smi,
                       steady_per_spp_ms=steady_ms, profile=prof,
                       b1_depths=b1, b3=b3, moving_frame_ms=moving_frame_ms,
                       still_frame_ms=still_frame_ms, moving_wall_ms=walls,
                       moving_launches=mlaunches, moving_peak_gb=mpeak_gb,
                       b4=b4, moving_profile=mprof, viewer=view,
                       small_path_far=far, small_path_rmse=srmse),
                  fh, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
