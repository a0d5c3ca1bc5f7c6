"""PyTorch port: the program's own spans and counters
(``voxelrt_torch.utils.profiling``) on the CPU, on example6 at 64×32 with
one 16-sample launch.

* Outside a profiler session nothing is recorded: ``span`` returns the
  shared null context.
* Inside one, a launch is one ``pipeline.accumulate`` holding
  ``launch_keys``, ``trace_frame`` and ``resolve_frame``; ``trace_sample``'s
  stages are spans, each depth's ``draws``, ``hit`` and ``shade`` with its
  ``depth``, and each ``sample.hit`` holds one ``kernels.b1``.
* ``b1.alive`` is the sum of the ``tracing`` mask handed to B1 at each
  depth, and recording leaves the rendered state bit-equal."""

import dataclasses
import json
import os
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from voxelrt_torch.app.examples import build_example
from voxelrt_torch.ops import prng
from voxelrt_torch.render import pathtracer, pipeline
from voxelrt_torch.utils import profiling

torch.set_num_threads(1)

RES = (64, 32)
K = 16
STAGES = ("sample.draws", "sample.hit", "sample.shade")


@pytest.fixture(scope="module")
def launch():
    """One launch with recording off, then the same launch inside a CPU
    profiler session with the masks handed to ``next_hit`` summed on the
    side; returns (renderer, state off, state on, record, masks, window)."""
    r = build_example("example6", "cpu", RES, samples_per_launch=K).renderer
    r.prepare_data()
    params = r._params(1e9)
    t0 = time.time_ns()
    off = pipeline.accumulate(r.cfg, r.scene_data, params, r.state,
                              prng.key(5))
    t1 = time.time_ns()
    idle = profiling.recorded(t0, t1)
    masks = []
    orig = pathtracer.next_hit

    def next_hit(cfg, scene, params, pos, d, mask, *args, **kw):
        if not kw.get("shadow_ray"):
            masks.append(int(mask.sum()))
        return orig(cfg, scene, params, pos, d, mask, *args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pathtracer, "next_hit", next_hit)
        w0 = time.time_ns()
        with profile(activities=[ProfilerActivity.CPU]):
            on = pipeline.accumulate(r.cfg, r.scene_data, params, r.state,
                                     prng.key(5))
        w1 = time.time_ns()
    return r, off, on, profiling.recorded(w0, w1), masks, (w0, w1), idle


def _named(rec, name):
    return [s for s in rec["spans"] if s["name"] == name]


def test_nothing_is_recorded_outside_a_session(launch):
    idle = launch[6]
    assert profiling.span("sample.hit", depth=0) is profiling.span("x")
    assert isinstance(profiling.span("x"), type(profiling._NULL))
    assert not profiling.recording()
    assert idle["spans"] == [] and idle["counts"] == []
    assert idle["counters"] == {}


def test_a_launch_is_one_accumulate_with_its_passes(launch):
    rec = launch[3]
    (acc,) = _named(rec, "pipeline.accumulate")
    assert acc["parent"] is None
    for name in ("pipeline.launch_keys", "pipeline.trace_frame",
                 "pipeline.resolve_frame"):
        (s,) = _named(rec, name)
        assert s["parent"] == acc["id"], name
    (frame,) = _named(rec, "pipeline.trace_frame")
    (resolve,) = _named(rec, "pipeline.resolve_frame")
    for name in ("sample.raygen", "sample.sky", "sample.epilogue",
                 "pipeline.embed"):
        (s,) = _named(rec, name)
        assert s["parent"] == frame["id"], name
    for name in ("temporal.prepass", "temporal.filter",
                 "temporal.filter_specular"):
        (s,) = _named(rec, name)
        assert s["parent"] == resolve["id"], name
    assert not _named(rec, "restir.gris")
    assert not [s for s in rec["spans"] if s["name"].startswith("cu")]


def test_each_depth_has_its_stages_and_one_b1(launch):
    r, rec = launch[0], launch[3]
    depth = r.cfg.max_ray_depth
    assert depth == 4
    for name in STAGES:
        spans = _named(rec, name)
        assert [s["attrs"]["depth"] for s in spans] == list(range(depth))
    for hit in _named(rec, "sample.hit"):
        kids = [s for s in rec["spans"] if s["parent"] == hit["id"]]
        assert [s["name"] for s in kids] == ["kernels.b1"]
        assert kids[0]["attrs"] == {"depth": hit["attrs"]["depth"]}
    # in-kernel NEE: no shadow dispatch of its own
    assert len(_named(rec, "kernels.b1")) == depth


def test_host_self_times_lie_within_the_parents(launch):
    rec = launch[3]
    by_id = {s["id"]: s for s in rec["spans"]}
    for s in rec["spans"]:
        assert 0.0 <= s["host_self_ms"] <= s["host_ms"], s["name"]
        assert s["stream_ms"] is None and s["stream_self_ms"] is None
        if s["parent"] is not None:
            assert s["host_ms"] <= by_id[s["parent"]]["host_ms"]
            assert s["host_self_ms"] <= by_id[s["parent"]]["host_ms"]


def test_the_window_leaves_out_what_lies_outside_it(launch):
    rec, (w0, w1) = launch[3], launch[5]
    (raygen,) = _named(rec, "sample.raygen")
    part = profiling.recorded(w0, raygen["t1_ns"])
    assert sorted(s["name"] for s in part["spans"]) == [
        "pipeline.launch_keys", "sample.raygen"]
    assert part["counts"] == []
    later = profiling.recorded(w1 + 1, w1 + 10 ** 12)
    assert later["spans"] == [] and later["counts"] == []


def test_b1_alive_is_the_tracing_mask(launch):
    r, rec, masks = launch[0], launch[3], launch[4]
    n = RES[0] * RES[1] * K
    depth = r.cfg.max_ray_depth
    assert len(masks) == depth

    def at(name, d):
        (row,) = [c for c in rec["counts"] if c["name"] == name
                  and c["attrs"]["depth"] == d]
        return row

    for d in range(depth):
        assert at("b1.alive", d)["value"] == masks[d]
        assert at("b1.alive", d)["attrs"] == {"depth": d, "any_hit": False}
        assert at("b1.rays", d)["value"] == n
        assert at("sample.lanes", d)["value"] == n
        assert 0 <= at("b1.nee_listed", d)["value"] <= masks[d]
    assert masks[0] == n and masks == sorted(masks, reverse=True)
    assert rec["counters"]["b1.alive"] == sum(masks)
    assert rec["counters"]["sample.lanes"] == depth * n


def test_recording_leaves_the_state_bit_equal(launch):
    off, on = launch[1], launch[2]
    for f in dataclasses.fields(off):
        a, b = getattr(off, f.name), getattr(on, f.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f.name
        else:
            assert a == b, f.name


def test_a_counter_is_summed_when_read():
    x = torch.tensor([1, 2, 3], dtype=torch.int32)
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count("test.kept", x, depth=7)
        profiling.count("test.kept", 5)
    t1 = time.time_ns()
    x += 10  # kept by reference: read as it is when read
    rec = profiling.recorded(t0, t1)
    assert rec["counters"] == {"test.kept": 41}
    assert [c["attrs"] for c in rec["counts"]] == [{"depth": 7}, {}]


def test_the_store_drops_its_oldest_records():
    rec = profiling.Recorder(size=3)
    t0 = time.time_ns()
    for i in range(5):
        rec.keep(profiling._Count("test.c", i, {}, None))
    got = rec.recorded(t0, time.time_ns())
    assert rec.dropped == 2 and got["dropped"] == 2
    assert [c["value"] for c in got["counts"]] == [2, 3, 4]


def test_trace_writes_the_spans_as_ranges(tmp_path):
    with profiling.trace("spans", log_dir=str(tmp_path)):
        with profiling.span("pipeline.embed"):
            torch.ones(4).sum()
    with open(os.path.join(tmp_path, "spans.json")) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert "pipeline.embed" in names
