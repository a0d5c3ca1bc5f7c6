"""One run of a cell: the traffic's runner renders, the metric readers read
the record it leaves, and the runner's judge decides ``correct``.

The traffic's ``kind`` names a module of this package,
``benchmark/harness/<kind>.py``, that exposes the runner class ``Run`` and
``judge``; a new kind of traffic is a new module, found by that name.
``Run(cell, seed, device)`` has ``setup()`` (its parts in seconds),
``window(seconds)``, ``traced(root)`` (the trace record of a profiled
part), ``close()`` (what ``judge`` reads), ``device`` and ``cuda``;
``judge(cell, seed, captured, device)`` returns (correct, attempted,
failed, checks).

``run`` is what ``benchmark/run.py`` calls on the card. It takes the device
as an argument so that the tests drive the same code on the CPU at a tiny
size, with the kernels' plain twins underneath; there no profiler session
is opened and the device numbers stay out of the result.
"""

from __future__ import annotations

import importlib
import time

from benchmark.harness import spec, trace


def kind_module(kind):
    """The module ``benchmark/harness/<kind>.py`` of a traffic kind."""
    return importlib.import_module("benchmark.harness." + kind)


def metrics_of(entries, rec):
    """{name: {value, unit}} of the metric entries whose reader finds a
    value in ``rec``; a reader that finds nothing leaves its metric out."""
    out = {}
    for m in entries:
        v = spec.metric_reader(m["name"])(rec)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def run(cell, seed, seconds, traced, device, t_start, card=None):
    """Returns (result dict, the closing lines for standard error).
    ``t_start``: the process's start on ``time.perf_counter``'s clock;
    ``card``: a function that names the card and its power limit, called
    once the window has closed."""
    import torch

    kind = kind_module(cell["traffic"]["kind"])
    job = kind.Run(cell, seed, device)
    t_setup = time.perf_counter()
    setup = job.setup()
    setup["imports_s"] = t_setup - t_start
    setup["setup_s"] = time.perf_counter() - t_start
    rec = dict(setup=setup, peaks=None)
    rec["window"] = job.window(seconds)
    cuda = job.cuda
    dev_kind = torch.cuda.get_device_name(job.device) if cuda else "cpu"
    if traced and cuda:
        rec["peaks"] = spec.peaks(dev_kind)
        rec["traced"] = job.traced(spec.ROOT)
    peak = rec["window"]["peak_bytes"]
    if cuda:
        peak = max(peak, setup.get("setup_peak_bytes", 0))
    captured = job.close()
    card = card() if card else None
    t_ref = time.perf_counter()
    correct, attempted, failed, checks = kind.judge(cell, seed, captured,
                                                    job.device)
    ref_s = time.perf_counter() - t_ref
    entries = cell["per_layer"] if traced else cell["end_to_end"]
    dev = {"platform": "gpu" if cuda else "cpu", "kind": dev_kind,
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics_of(entries, rec), "device": dev}
    if "traced" in rec:
        t0, t1 = rec["traced"]["window_ns"]
        dev["busy_s"] = trace.busy_ns(rec["traced"]) / 1e9
        dev["window_s"] = (t1 - t0) / 1e9
        result["breakdown"] = trace.breakdown(rec["traced"])
    result["checks"] = checks
    w = rec["window"]
    lines = [f"card: {card or dev_kind}",
             "setup: " + ", ".join(f"{k} {v:.4f}" for k, v in setup.items()
                                    if k.endswith("_s")),
             f"window: {w['spp']} spp in {w['seconds']:.4f} s, chunk ends "
             + " ".join(f"{t:.3f}" for t in w["chunk_ends_s"]),
             f"compared: {attempted} answers, {failed} failed, reference "
             f"{ref_s:.3f} s"]
    lines += [f"check {n}: {c['value']!r} (limit {c['limit']!r})"
              for n, c in checks.items()]
    return result, lines
