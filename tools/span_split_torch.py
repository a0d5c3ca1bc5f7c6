"""Split a benchmark cell's traced chunk by the program's own spans, on the
card, and time the recorder.

    python3 tools/span_split_torch.py [--workload NAME] [--seed N]
                                      [--turns T] [--out PATH]

The cell is set up as ``benchmark/run.py`` sets it up, renders one chunk
and profiles one with the recorder on (both left out); then ``2 T`` chunks
are profiled as the benchmark's traced chunk is
(``benchmark/harness/trace.py``), the program's recorder on and forced off
in turns (on, off, off, on, ...). Printed, and written as JSON to
``--out`` when given:

* ``stages``: for the first chunk with the recorder on, each span name and
  depth with its stream self ms, its kernels (the runtime's launch calls
  made in its own host time, outside its children) and its idle ms (the
  device's gaps that began while it was the innermost open span), each
  summed over the chunk;
* ``coverage``: the stream ms of the eight stage metrics, ``kernels.b1``
  and the self time of ``pipeline.accumulate``, ``launch_keys`` and
  ``trace_frame`` against the chunk's busy and window ms; ``kernels.b1``'s
  stream ms against ``kernels.b1_ms_per_spp``;
* ``host_ms_per_launch``: ``pipeline.host_ms_per_launch`` of each chunk,
  recorder on and off, and the medians' difference; ``runtime``: the host's
  CUDA runtime calls in the chunks' enqueue by name, count and ms, summed
  over the chunks of each mode;
* ``metrics``: every per-layer metric of the first chunk with the recorder
  on, and of the first with it off;
* ``recorder_us_per_launch``: the host's µs for one launch's spans and
  counters (``launch_pattern``), inside a profiler session with the
  recorder on and forced off, on an idle stream.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STAGES = ("sample.raygen", "sample.draws", "sample.hit", "sample.shade",
          "sample.sky", "sample.epilogue", "pipeline.embed")
HOLDERS = ("pipeline.accumulate", "pipeline.launch_keys",
           "pipeline.trace_frame")


@contextlib.contextmanager
def recorder_off():
    """The program's recorder forced off inside a profiler session."""
    from voxelrt_torch.utils import profiling

    saved = profiling.span, profiling.count, profiling.recording
    profiling.span = lambda name, **attrs: profiling._NULL
    profiling.count = lambda name, value, **attrs: None
    profiling.recording = lambda: False
    try:
        yield
    finally:
        profiling.span, profiling.count, profiling.recording = saved


def launch_pattern(x, n):
    """The spans and counters one still launch records, with nothing inside
    them: 27 spans, 32 counters (``x``: B1's ``counts`` on the card)."""
    from voxelrt_torch.ops.dda_kernel import B1_COUNTS
    from voxelrt_torch.utils import profiling as p

    with p.span("pipeline.accumulate"):
        with p.span("pipeline.launch_keys"):
            pass
        with p.span("pipeline.trace_frame"):
            with p.span("sample.raygen"):
                pass
            for d in range(4):
                p.count("sample.lanes", n, depth=d)
                with p.span("sample.draws", depth=d):
                    p.count("draws.lanes", n, slots=8, lane_keys=True)
                with p.span("sample.hit", depth=d):
                    p.count("hit.lanes", n, nee=True, stage="prepare")
                    with p.span("kernels.b1"):
                        if p.recording():
                            p.count("b1.rays", n, any_hit=False)
                            for i, name in enumerate(B1_COUNTS):
                                p.count(name, x[i], any_hit=False)
                    p.count("hit.lanes", n, nee=True, stage="merge")
                with p.span("sample.shade", depth=d):
                    pass
            for name in ("sample.sky", "sample.epilogue", "pipeline.embed"):
                with p.span(name):
                    pass
        with p.span("pipeline.resolve_frame"):
            for name in ("temporal.prepass", "temporal.filter",
                         "temporal.filter_specular"):
                with p.span(name):
                    pass


def recorder_cost(reps=400):
    """µs a launch of ``launch_pattern`` in a CUDA profiler session, the
    recorder on and forced off, in turns (the median of five each)."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros(3, dtype=torch.int32, device="cuda")
    out = {"on": [], "off": []}
    for mode in ["on", "off", "off", "on"] * 2 + ["on", "off"]:
        ctx = recorder_off() if mode == "off" else contextlib.nullcontext()
        with profile(activities=[ProfilerActivity.CUDA]), ctx:
            t = time.perf_counter()
            for _ in range(reps):
                launch_pattern(x, 14_745_600)
            out[mode].append((time.perf_counter() - t) / reps * 1e6)
        torch.cuda.synchronize()
    return dict(out, median_on=statistics.median(out["on"]),
                median_off=statistics.median(out["off"]))


def label(s):
    d = s["attrs"].get("depth")
    return s["name"] if d is None else f"{s['name']}@{d}"


def innermost(points, spans):
    """For each time in ``points``, the index into ``spans`` (dicts with
    ``t0_ns``, ``t1_ns``) of the innermost span open then (start <= t <
    end), or None; spans nest."""
    marks = [(s["t1_ns"], 0, i) for i, s in enumerate(spans)]
    marks += [(s["t0_ns"], 1, i) for i, s in enumerate(spans)]
    marks += [(t, 2, j) for j, t in enumerate(points)]
    out, stack = [None] * len(points), []
    for _, kind, i in sorted(marks):
        if kind == 1:
            stack.append(i)
        elif kind == 0:
            stack.remove(i)
        else:
            out[i] = stack[-1] if stack else None
    return out


def split(traced, rec):
    """The per-stage split and the coverage of one traced chunk."""
    from benchmark.harness import trace

    spans = rec["spans"]
    spp = traced["spp"]
    rows = {}
    for s in spans:
        r = rows.setdefault(label(s), dict(stream_ms=0.0, kernels=0,
                                           idle_ms=0.0, spans=0))
        r["stream_ms"] += s["stream_self_ms"]
        r["spans"] += 1
    e0, e1 = traced["enqueue_ns"]
    launches = [s for name, s, _ in traced["runtime"]
                if "Launch" in name and e0 <= s < e1]
    outside = 0
    for i in innermost(launches, spans):
        if i is None:
            outside += 1
        else:
            rows[label(spans[i])]["kernels"] += 1
    gaps = trace.idle_gaps(traced["events"],
                           [(label(s), s["t0_ns"], s["t1_ns"])
                            for s in spans], traced["window_ns"])
    for name, sec in gaps.items():
        rows.setdefault(name, dict(stream_ms=0.0, kernels=0, idle_ms=0.0,
                                   spans=0))["idle_ms"] += sec * 1e3

    def total(names, key):
        return sum(s[key] for s in spans if s["name"] in names)

    cover = (total(STAGES, "stream_self_ms")
             + total(("pipeline.resolve_frame",), "stream_ms")
             + total(("kernels.b1",), "stream_ms")
             + total(HOLDERS, "stream_self_ms"))
    busy = trace.busy_ns(traced) / 1e6
    window = (traced["window_ns"][1] - traced["window_ns"][0]) / 1e6
    b1_names = traced["kernels"][traced["b1_source"]]
    b1 = sum(e - s for n, s, e in traced["events"]
             if trace.matches(n, b1_names)) / 1e6
    b1_stream = total(("kernels.b1",), "stream_ms")
    return dict(
        spp=spp, stages=rows, launch_calls_outside_spans=outside,
        coverage=dict(cover_ms=cover, busy_ms=busy, window_ms=window,
                      cover_over_busy=cover / busy,
                      cover_over_window=cover / window,
                      b1_stream_ms=b1_stream, b1_profiled_ms=b1,
                      b1_ratio=b1_stream / b1 if b1 else None),
        dropped=rec["dropped"])


def card_line():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "--id=0"], capture_output=True,
            text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="example6-still-720p")
    ap.add_argument("--seed", type=int, default=2 ** 31 + 11)
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark.harness import runner, spec
    from voxelrt_torch.utils import profiling

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    cell = spec.cell(args.workload)
    job = runner.kind_module(cell["traffic"]["kind"]).Run(cell, args.seed,
                                                          "cuda")
    job.setup()
    job.window(0.0)
    job.traced(spec.ROOT)
    peaks = spec.peaks(torch.cuda.get_device_name(job.device))
    host = {"on": [], "off": []}
    calls = {"on": {}, "off": {}}
    metrics, out = {}, dict(workload=args.workload, seed=args.seed,
                            card=card_line(), torch=torch.__version__)
    order = ["on", "off", "off", "on"] * ((args.turns + 1) // 2)
    for mode in order[:2 * args.turns]:
        ctx = recorder_off() if mode == "off" else contextlib.nullcontext()
        with ctx:
            traced = job.traced(spec.ROOT)
        rec = dict(setup={}, window=None, peaks=peaks, traced=traced)
        host[mode].append(spec.metric_reader(
            "pipeline.host_ms_per_launch")(rec))
        e0, e1 = traced["enqueue_ns"]
        for name, c0, c1 in traced["runtime"]:
            if e0 <= c0 < e1:
                n, ms = calls[mode].get(name, (0, 0.0))
                calls[mode][name] = (n + 1, ms + (c1 - c0) / 1e6)
        if mode not in metrics:
            metrics[mode] = runner.metrics_of(cell["per_layer"], rec)
        if mode == "on" and "split" not in out:
            out["split"] = split(traced, profiling.recorded(
                *traced["window_ns"]))
    job.close()
    out["recorder_us_per_launch"] = recorder_cost()
    out["metrics"] = metrics
    out["host_ms_per_launch"] = dict(
        host, median_on=statistics.median(host["on"]),
        median_off=statistics.median(host["off"]),
        cost_ms=statistics.median(host["on"])
        - statistics.median(host["off"]))
    out["runtime"] = calls
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    s = out["split"]
    print(f"{args.workload} on {out['card']}: {s['spp']} spp")
    for name, r in sorted(s["stages"].items(),
                          key=lambda kv: -kv[1]["stream_ms"]):
        print(f"  {name:28s} stream {r['stream_ms'] / s['spp']:9.4f} "
              f"ms/spp  kernels {r['kernels'] / s['spp']:8.2f}/spp  "
              f"idle {r['idle_ms']:8.3f} ms")
    print("coverage", json.dumps(s["coverage"]))
    print("host_ms_per_launch", json.dumps(out["host_ms_per_launch"]))
    print("runtime", json.dumps(calls))
    print("recorder_us_per_launch", json.dumps(out["recorder_us_per_launch"]))
    print("metrics", json.dumps(metrics))
    return out


if __name__ == "__main__":
    main()
