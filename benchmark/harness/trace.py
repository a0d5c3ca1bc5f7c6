"""The traced part of a ``--trace 1`` run: a chunk under ``torch.profiler``
(its CUDA activity: the card's events and the host's CUDA calls), host spans
recorded from the benchmark's own files around calls into the program's
layers, and what B1's dispatches were handed. Nothing inside the program
changes.

* Device events: every CUDA event of the session (kernels, copies, sets),
  each with its start and end on the profiler's clock, which is the host's
  wall clock in ns.
* Runtime calls: every call the host made into the CUDA runtime or driver
  (``cudaLaunchKernel``, ``cudaStreamSynchronize``, ...), with its start
  and end, so that the host's own time can be told from its waits on the
  card; the chunk's enqueue, from before its first call to the return of
  ``run_chunk``, is kept beside them.
* Host spans: ``time.time_ns()`` around the calls that ``accumulate_n``
  makes into the pipeline (``accumulate``, ``trace_frame``,
  ``resolve_frame``), into B1 (``pathtracer.raytrace``) and around the
  harness's synchronise, so that an idle gap on the device can be put down
  to what the host was doing when it began.
* B1's dispatches: for each, the ray count, the alive mask it was handed
  (summed after the session, so no kernel of the benchmark's runs inside
  it), whether tmax is per ray, NEE and shadow mode, and the tables' bytes.

The profiler drops a session's kernel events now and then. The count of
B1's kernels that it saw is held to the program's own counter
(``ops/_cuda.py``'s ``LAUNCHES``) over the same launches; a session where
they differ is taken again, up to ``ATTEMPTS`` times, and after that the
run fails rather than report a number.
"""

from __future__ import annotations

import glob
import os
import re
import time

ATTEMPTS = 3
B1_SOURCE = "dda"
# the counter's entries that each launch one of B1's kernels
B1_COUNTERS = ("traverse_compact", "traverse", "traverse_nee")


class ProfilerDropped(RuntimeError):
    pass


def port_kernels(root):
    """{source stem: set of ``__global__`` function names} of the
    program's CUDA sources, read from ``voxelrt_torch/csrc/*.cu``."""
    pat = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\s*"
                     r"\([^)]*\)\s*)?(?:void\s+)?([A-Za-z_]\w*)\s*[(<]")
    out = {}
    for path in sorted(glob.glob(os.path.join(root, "voxelrt_torch", "csrc",
                                              "*.cu"))):
        with open(path) as fh:
            names = set(pat.findall(fh.read()))
        out[os.path.splitext(os.path.basename(path))[0]] = names
    return out


def matches(name, kernel_names):
    """Whether a device event's name is one of ``kernel_names``'s kernels
    (a whole identifier in the demangled name)."""
    return any(re.search(r"(?<![\w])" + re.escape(k) + r"(?![\w])", name)
               for k in kernel_names)


class Spans:
    """Host spans around calls of wrapped module attributes."""

    def __init__(self):
        self.items = []  # (name, start_ns, end_ns)
        self._restore = []

    def wrap(self, module, attr, name, before=None):
        orig = getattr(module, attr)
        items = self.items

        def wrapper(*args, **kwargs):
            if before is not None:
                before(args, kwargs)
            t0 = time.time_ns()
            try:
                return orig(*args, **kwargs)
            finally:
                items.append((name, t0, time.time_ns()))

        setattr(module, attr, wrapper)
        self._restore.append((module, attr, orig))

    def span(self, name, t0, t1):
        self.items.append((name, t0, t1))

    def restore(self):
        for module, attr, orig in reversed(self._restore):
            setattr(module, attr, orig)
        self._restore = []


def dispatch_record(args, kw):
    """What one call of B1's entry (``raytrace(tables, origin, direction,
    tmin, tmax, ...)``) was handed, for its byte count; the alive mask is
    kept as it is and summed after the traced session."""
    tables, origin, tmax = args[0], args[1], args[4]
    n = origin.x.shape[0]
    return dict(n=n, alive=kw.get("alive"), nee=kw.get("nee") is not None,
                any_hit=bool(kw.get("any_hit")),
                tmax_per_ray=bool(hasattr(tmax, "numel")
                                  and tmax.numel() == n),
                table_bytes=sum(t.numel() * t.element_size()
                                for t in tables[:-1]))


def settle_dispatch(d):
    """A dispatch record with its mask summed: ``n_alive`` and
    ``mask_bytes`` (a ray) in place of the mask."""
    alive = d.pop("alive")
    d["n_alive"] = d["n"] if alive is None else int((alive != 0).sum())
    d["mask_bytes"] = 0 if alive is None else alive.element_size()
    return d


def device_events(prof):
    """(name, start_ns, end_ns) of every event the card ran."""
    import torch

    out = []
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() == torch.autograd.DeviceType.CUDA
                and not e.is_user_annotation()):
            s = e.start_ns()
            out.append((e.name(), s, s + e.duration_ns()))
    return out


def runtime_calls(prof):
    """(name, start_ns, end_ns) of every call into the CUDA runtime or
    driver that the host made in the session (``cudaLaunchKernel``,
    ``cudaStreamSynchronize``, ...)."""
    import torch

    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if (e.device_type() == torch.autograd.DeviceType.CPU
                and name.startswith("cu")):
            s = e.start_ns()
            out.append((name, s, s + e.duration_ns()))
    return out


def traced_chunk(run, root):
    """Profile one chunk of ``run`` (a traffic runner with ``run_chunk`` and
    ``sync``); returns the trace record for the metric readers."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from voxelrt_torch.ops import _cuda
    from voxelrt_torch.render import pathtracer, pipeline

    kernels = port_kernels(root)
    b1_names = kernels.get(B1_SOURCE, set())
    for _ in range(ATTEMPTS):
        dispatches = []

        def note(args, kw):
            dispatches.append(dispatch_record(args, kw))

        spans = Spans()
        spans.wrap(pipeline, "accumulate", "pipeline.accumulate")
        spans.wrap(pipeline, "trace_frame", "pipeline.trace_frame")
        spans.wrap(pipeline, "resolve_frame", "pipeline.resolve_frame")
        spans.wrap(pathtracer, "raytrace", "kernels.b1_dispatch", note)
        _cuda.reset_launch_counts()
        run.sync()
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.time_ns()
                run.run_chunk()
                ts = time.time_ns()
                run.sync()
                t1 = time.time_ns()
        finally:
            spans.restore()
        spans.span("harness.synchronize", ts, t1)
        events = device_events(prof)
        counted = sum(_cuda.LAUNCHES[k] for k in B1_COUNTERS)
        seen = sum(1 for name, _, _ in events if matches(name, b1_names))
        if seen == counted and counted > 0:
            break
    else:
        raise ProfilerDropped(
            f"the profiler saw {seen} of B1's kernels where the program "
            f"counted {counted}, in {ATTEMPTS} sessions")
    dispatches = [settle_dispatch(d) for d in dispatches]
    return dict(spp=run.chunk_spp, launches=run.chunk_spp // run.k,
                window_ns=(t0, t1), enqueue_ns=(t0, ts),
                runtime=runtime_calls(prof), events=events,
                spans=spans.items, dispatches=dispatches, kernels=kernels,
                b1_source=B1_SOURCE, b1_seen=seen, b1_counted=counted)


def union_ns(intervals):
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def busy_ns(traced):
    """The device's busy ns inside the traced chunk's window: the union of
    its events' intervals, clipped to the window."""
    t0, t1 = traced["window_ns"]
    return union_ns([(max(s, t0), min(e, t1)) for _, s, e in traced["events"]
                     if e > t0 and s < t1])


def idle_gaps(events, spans, window):
    """The device's idle gaps inside ``window`` = (start, end) ns, each put
    down to the innermost host span open when it began; returns {label:
    seconds}."""
    t0, t1 = window
    busy = sorted((max(s, t0), min(e, t1)) for _, s, e in events
                  if e > t0 and s < t1)
    gaps, cursor = [], t0
    for s, e in busy:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if t1 > cursor:
        gaps.append((cursor, t1))
    out = {}
    for gs, ge in gaps:
        open_ = [(s, name) for name, s, e in spans if s <= gs < e]
        label = (max(open_)[1] if open_ else "harness (between calls)")
        out[label] = out.get(label, 0.0) + (ge - gs) / 1e9
    return out


def breakdown(rec, top=10):
    """The ``breakdown`` of a result line: the device operations that took
    most time and the idle gaps by what the host was doing."""
    by_name = {}
    for name, s, e in rec["events"]:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(rec["events"], rec["spans"],
                            rec["window_ns"]).items(),
                  key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:200], t] for n, t in ops],
            "idle_gaps": [[n, t] for n, t in gaps]}
