"""What a run is made of, found by name: the cell in ``BENCHMARK.json``,
its configuration (``configs/<config>.json``), its traffic
(``traffic/<traffic>.json``), its comparison (``checks/<cell>.json``) and
the readers of its per-layer metrics (``metrics/<metric>.py``). A later
cell or metric is added as files and entries; none of this code changes."""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _load(path):
    with open(path) as fh:
        return json.load(fh)


def benchmark():
    return _load(os.path.join(ROOT, "BENCHMARK.json"))


def cell(name, bench=None):
    """The cell ``name`` with everything it names: a dict of ``workload``
    (its BENCHMARK.json entry), ``config``, ``traffic``, ``check``,
    ``end_to_end`` and ``per_layer`` (the metric entries; a reader that
    finds nothing to read in a cell leaves its metric out there)."""
    bench = bench or benchmark()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = found[0]
    return dict(
        workload=w,
        config=_load(os.path.join(BENCH_DIR, "configs", w["config"] + ".json")),
        traffic=_load(os.path.join(BENCH_DIR, "traffic",
                                   w["traffic"] + ".json")),
        check=_load(os.path.join(BENCH_DIR, "checks", name + ".json")),
        end_to_end=bench["end_to_end"], per_layer=bench["per_layer"])


def metric_reader(name):
    """The ``read(record)`` function of ``metrics/<name>.py``."""
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def peaks(kind):
    """The published peaks of the device ``kind`` (``peaks.json``), or
    None for a device the table does not hold."""
    return _load(os.path.join(BENCH_DIR, "peaks.json")).get(kind)
