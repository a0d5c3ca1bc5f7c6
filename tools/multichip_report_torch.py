"""The still frame partitioned over 'dp' at full size, held to one device
and its traffic counted: the PyTorch port's twin of
``tools/multichip_report.py``.

    python3 tools/multichip_report_torch.py [--dp 8 32] [--device cuda:0]

It renders example6 at 1280×720 with ``samples_per_launch=16``
(``bench_torch.py``'s setting) through ``parallel.sharding.
sharded_accumulate_n``: two launches of the full progressive step (render,
temporal pipeline) from a fresh state on a mesh of each ``--dp`` (8:
160-row blocks; 32: 40-row blocks, off the 16-row tile columns). The
mesh's devices are the host's cards in turn, each holding dp / cards
neighbouring blocks, or one card dp times on a host with one. Every field
of the gathered state after each launch must be ``torch.equal`` to
``pipeline.accumulate_n``'s on one device (as
``tests/test_multichip_fullres.py`` requires of the JAX package); the tool
exits 1 if one is not. ``report`` runs the same on any configuration, scene
and mesh shape (ReSTIR's GRIS pass where the configuration has it, 'sp' > 1
too) and on the CPU with the kernels' plain twins (no times).

In place of the JAX tool's inventory of the collectives in XLA's HLO, it
counts what the partition moves, by wrapping the module's own functions:

* halo rows: for each block and launch, the rows of other blocks that
  ``parallel/sharding.py:rows`` copies to it (the GRIS taps' ceil(radius)
  rows each side, the prepass's 1 before and 2 after), their bytes, and
  the bytes that crossed from one device to another;
* trace gathers: the bytes ``make_sharded_trace`` concatenates from a
  block's 'sp' devices onto the block's (none at sp=1);
* on the card, each device's device ms and kernel count of a launch (a
  torch.profiler trace of the card's activity) and its peak memory, and the
  partitioned launch's wall ms beside one device's.

The counts rest on those functions being called through their modules'
names; a mesh with dp > 1 whose launches copied no halo row, or one with
sp > 1 that gathered no trace, is an error.

It prints its report, the whole of it as a JSON object last, and writes no
file. Without ``--device`` it runs on the CUDA cards and raises when there
is none.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tools.torch_measure import card_name, unequal_fields  # noqa: E402


def _nbytes(x):
    return x.numel() * x.element_size()


class Traffic:
    """Inside a ``with`` block, counts the rows that
    ``sharding.rows`` copies to a block while ``pipeline.resolve_frame``
    runs on it (one entry per block and launch, in order) and the bytes
    ``sharding._cat`` gathers from a block's 'sp' devices."""

    def __enter__(self):
        from voxelrt_torch.parallel import sharding
        from voxelrt_torch.render import pipeline

        self.sharding, self.pipeline = sharding, pipeline
        self.orig = (pipeline.resolve_frame, sharding.rows, sharding._cat)
        self.blocks = []  # one dict per resolve_frame call
        self.gather_bytes = 0
        self.gather_cross_bytes = 0
        resolve, rows, cat = self.orig
        cur = []

        def resolve_counted(*args, **kwargs):
            lo = kwargs.get("lo", 0)
            hi = lo + args[3].color.shape[0]
            entry = dict(lo=lo, hi=hi, before=0, after=0, rows=0, bytes=0,
                         cross_device_bytes=0, requests=0)
            self.blocks.append(entry)
            cur.append(entry)
            try:
                return resolve(*args, **kwargs)
            finally:
                cur.pop()

        def rows_counted(parts, bounds, get, lo, hi, device):
            out = rows(parts, bounds, get, lo, hi, device)
            if cur:
                e = cur[-1]
                e["requests"] += 1
                row_bytes = _nbytes(out[:1]) if out.shape[0] else 0
                for part, (a, b) in zip(parts, bounds):
                    a2, b2 = max(lo, a), min(hi, b)
                    if a2 >= b2:
                        continue
                    # the rows of [a2, b2) outside the resolving block
                    n = (b2 - a2) - max(0, min(b2, e["hi"])
                                        - max(a2, e["lo"]))
                    if n == 0:
                        continue
                    e["rows"] += n
                    e["bytes"] += n * row_bytes
                    if get(part).device != out.device:
                        e["cross_device_bytes"] += n * row_bytes
                e["before"] = max(e["before"], e["lo"] - max(lo, 0)
                                  if lo < e["lo"] else 0)
                e["after"] = max(e["after"], hi - e["hi"]
                                 if hi > e["hi"] else 0)
            return out

        def cat_counted(parts, device):
            import torch

            if isinstance(parts[0], torch.Tensor):
                for p in parts:
                    self.gather_bytes += _nbytes(p)
                    if p.device != torch.device(device):
                        self.gather_cross_bytes += _nbytes(p)
            return cat(parts, device)

        pipeline.resolve_frame = resolve_counted
        sharding.rows = rows_counted
        sharding._cat = cat_counted
        return self

    def __exit__(self, *exc):
        (self.pipeline.resolve_frame, self.sharding.rows,
         self.sharding._cat) = self.orig


def mesh_devices(device, dp, sp=1):
    """The mesh's devices, dp × sp of them: the CUDA cards in turn, each
    holding neighbouring blocks, or ``device`` every time off the card or
    on a host with one card."""
    import torch

    n = dp * sp
    if device.type != "cuda" or torch.cuda.device_count() < 2:
        return [device] * n
    cards = torch.cuda.device_count()
    return [torch.device("cuda", i * cards // n) for i in range(n)]


def profile_devices(fn):
    """Device ms and kernels of one call of ``fn`` on each card, from a
    torch.profiler trace of the cards' activity only (read from the raw
    trace, as ``chip_smoke.device_events`` does), and the traced wall ms.
    The profiler drops a session's kernel events now and then: a trace
    with none is taken again, up to three times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        per = {}
        for e in p.profiler.kineto_results.events():
            if e.device_type() != torch.autograd.DeviceType.CUDA or \
                    e.is_user_annotation():
                continue
            d = per.setdefault(f"cuda:{e.device_index()}",
                               dict(device_ms=0.0, kernels=0))
            d["device_ms"] += e.duration_ns() / 1e6
            d["kernels"] += 1
        if per:
            break
    return dict(by_device=per, traced_wall_ms=wall,
                kernels=sum(d["kernels"] for d in per.values()),
                device_ms=sum(d["device_ms"] for d in per.values()))


def report(cfg, scene, params, device, dps, n_samples, sp=1, key=None,
           smi=None, out=print):
    """The comparison and the counts for each dp of ``dps`` (see the
    module's docstring); returns a dict, ``ok`` false where any field
    differs."""
    import torch

    from voxelrt_torch.ops import prng
    from voxelrt_torch.parallel import sharding
    from voxelrt_torch.render import pipeline

    cuda = device.type == "cuda"
    key = prng.key(9) if key is None else key
    keys = (key, prng.fold_in(key, 1))
    w = cfg.image_res[0]

    def sync():
        if cuda:
            torch.cuda.synchronize()

    def two_launches(mesh):
        run = pipeline.accumulate_n if mesh is None else (
            lambda *a: sharding.sharded_accumulate_n(*a, mesh=mesh))
        states, st = [], pipeline.init_state(cfg, device)
        for k in keys:
            st = run(cfg, scene, params, st, k, False, 1.0, n_samples)
            states.append(st)
        return states

    def one_launch(mesh):
        run = pipeline.accumulate_n if mesh is None else (
            lambda *a: sharding.sharded_accumulate_n(*a, mesh=mesh))
        return run(cfg, scene, params, pipeline.init_state(cfg, device),
                   keys[0], False, 1.0, n_samples)

    def timed(mesh, devs):
        """Wall ms and each device's peak memory of one launch."""
        sync()
        for d in devs:
            torch.cuda.reset_peak_memory_stats(d)
        t0 = time.perf_counter()
        one_launch(mesh)
        sync()
        return ((time.perf_counter() - t0) * 1e3,
                {str(d): torch.cuda.max_memory_allocated(d) / 1e9
                 for d in devs})

    rep = dict(image_res=list(cfg.image_res), samples=n_samples,
               samples_per_launch=cfg.samples_per_launch,
               restir=bool(cfg.use_restir_pt),
               restir_radius=cfg.restir_radius if cfg.use_restir_pt else 0.0,
               card=smi, meshes={}, ok=True)
    want = two_launches(None)
    if cuda:
        one_launch(None)  # past first calls
        ms, peak = timed(None, [device])
        rep["one_device"] = dict(launch_ms=ms, peak_gb=peak,
                                 profile=profile_devices(
                                     lambda: one_launch(None)))
        out(f"one device: a launch {ms:.1f} ms, "
            f"{rep['one_device']['profile']['kernels']} kernels, "
            f"{rep['one_device']['profile']['device_ms']:.1f} device ms, "
            f"peak {peak} GB" + (f" ({smi})" if smi else ""))
    for dp in dps:
        if w % dp:
            raise ValueError(f"{w} rows do not split over dp={dp}")
        devs = mesh_devices(device, dp, sp)
        mesh = sharding.make_mesh(devs, dp=dp, sp=sp)
        if cuda:
            one_launch(mesh)  # past first calls at the blocks' shapes
        with Traffic() as tr:
            got = two_launches(mesh)
        if len(tr.blocks) != dp * len(keys) or (
                dp > 1 and not any(e["rows"] for e in tr.blocks)) or (
                sp > 1 and not tr.gather_bytes):
            raise RuntimeError(
                f"dp={dp} sp={sp}: the traffic counters saw "
                f"{len(tr.blocks)} block passes, "
                f"{sum(e['rows'] for e in tr.blocks)} halo rows and "
                f"{tr.gather_bytes} gathered bytes; sharding no longer "
                "calls the functions they wrap")
        bad = [unequal_fields(a, b) for a, b in zip(want, got)]
        bounds = sharding.block_bounds(got[-1])
        row = dict(
            dp=dp, sp=sp, devices=[str(d) for d in devs],
            blocks=[dict(rows=b - a, device=str(blk.color.device))
                    for (a, b), blk in zip(bounds, got[-1])],
            unequal_fields=bad, equal=not any(bad),
            halo=[tr.blocks[i * dp:(i + 1) * dp] for i in range(len(keys))],
            halo_bytes_per_launch=[sum(e["bytes"] for e in tr.blocks[
                i * dp:(i + 1) * dp]) for i in range(len(keys))],
            halo_cross_device_bytes_per_launch=[sum(
                e["cross_device_bytes"] for e in tr.blocks[
                    i * dp:(i + 1) * dp]) for i in range(len(keys))],
            trace_gather_bytes=tr.gather_bytes,
            trace_gather_cross_device_bytes=tr.gather_cross_bytes)
        if cuda:
            ms, peak = timed(mesh, mesh.distinct())
            row.update(launch_ms=ms, peak_gb=peak,
                       profile=profile_devices(lambda: one_launch(mesh)))
            one = rep["one_device"]
            row["launch_ms_vs_one_device"] = ms / one["launch_ms"]
            row["kernels_vs_one_device"] = (row["profile"]["kernels"]
                                            / one["profile"]["kernels"])
        rep["meshes"][f"dp={dp}"] = row
        rep["ok"] = rep["ok"] and row["equal"]
        del got
        h0 = row["halo"][0]
        out(f"dp={dp} sp={sp}: {len(bounds)} blocks of "
            f"{sorted(set(b['rows'] for b in row['blocks']))} rows on "
            f"{sorted(set(row['devices']))}; every field equal to one "
            f"device's: {row['equal']} {bad if not row['equal'] else ''}; "
            f"halo rows before/after a block {h0[len(h0) // 2]['before']}/"
            f"{h0[len(h0) // 2]['after']} (a middle block), "
            f"{row['halo_bytes_per_launch'][0]} B a launch "
            f"({row['halo_cross_device_bytes_per_launch'][0]} B across "
            f"devices); trace gathers {row['trace_gather_bytes']} B"
            + (f"; a launch {row['launch_ms']:.1f} ms "
               f"(x{row['launch_ms_vs_one_device']:.3f}), "
               f"{row['profile']['kernels']} kernels "
               f"(x{row['kernels_vs_one_device']:.2f}), "
               f"{row['profile']['device_ms']:.1f} device ms, peak "
               f"{row['peak_gb']} GB ({smi})" if cuda else ""))
    return rep


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dp", type=int, nargs="+", default=[8, 32])
    ap.add_argument("--sp", type=int, default=1,
                    help="devices a block's samples are spread over (the "
                         "'sp' axis; a mesh of dp x sp devices)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA cards, raising "
                         "without one)")
    args = ap.parse_args(argv)

    import torch

    from voxelrt_torch import resolve_device
    from voxelrt_torch.app.examples import build_example

    device = resolve_device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    sc = build_example("example6", device, (1280, 720), samples_per_launch=16)
    r = sc.renderer
    r.prepare_data()
    rep = report(r.cfg, r.scene_data, r._params(1e9), device, args.dp,
                 r.cfg.samples_per_launch, sp=args.sp,
                 smi=card_name(device))
    print(json.dumps(rep))
    if not rep["ok"]:
        print("FAIL: a partitioned state is not equal to one device's",
              file=sys.stderr)
        sys.exit(1)
    return rep


if __name__ == "__main__":
    main()
