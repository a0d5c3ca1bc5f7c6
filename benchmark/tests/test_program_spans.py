"""The readers of the program's own spans and counters
(``benchmark/metrics/program_spans.py`` and the metrics that use it): their
values on a hand-built record with a stubbed program record, nothing where
the program has no recorder or no stream times, and on the card the
acceptance cross-checks of a traced chunk."""

import pytest

from benchmark.harness import runner, spec, trace
from benchmark.tests.test_harness import _record

MS = 1_000_000
SOURCES = ("program_span", "program_counter")
NEW = [m["name"] for m in spec.benchmark()["per_layer"]
       if m["source"] in SOURCES]
# the spans whose stream ms tile the card's stream: the eight stage
# metrics, B1, and the self time of what holds them
STAGES = ("sample.raygen_ms_per_spp", "sample.draws_ms_per_spp",
          "sample.hit_ms_per_spp", "sample.shade_ms_per_spp",
          "sample.sky_ms_per_spp", "sample.epilogue_ms_per_spp",
          "pipeline.embed_ms_per_spp", "pipeline.resolve_ms_per_spp")
HOLDERS = ("pipeline.accumulate", "pipeline.launch_keys",
           "pipeline.trace_frame")
# the metrics of PR 19's spans and counters, whose values are tested here
TEN = STAGES + ("pipeline.trace_frame_idle_ms_per_spp",
                "sample.alive_lane_pct")


def _span(name, stream_self, stream=None, t=(0, 1), **attrs):
    t0 = 10 ** 18
    return dict(name=name, id=id(attrs), parent=None, attrs=attrs,
                t0_ns=t0 + t[0] * MS, t1_ns=t0 + t[1] * MS, host_ms=1.0,
                host_self_ms=1.0, stream_self_ms=stream_self,
                stream_ms=stream_self if stream is None else stream)


def _count(name, value, **attrs):
    return dict(name=name, attrs=attrs, value=value, t_ns=0, span=None)


def _program():
    """The program's record of ``_record()``'s chunk (16 samples): two
    ``trace_frame`` spans, one open as the device's 1-ms gap at 4 ms
    begins; 160 of 200 lanes alive in the loop's closest-hit dispatches."""
    spans = [_span("sample.raygen", 1.6),
             _span("pipeline.embed", 0.8),
             _span("sample.sky", 0.48),
             _span("sample.epilogue", 0.32),
             _span("pipeline.resolve_frame", 0.16, 3.2),
             _span("pipeline.trace_frame", 0.1, 9.0, t=(3, 6)),
             _span("pipeline.trace_frame", 0.1, 9.0, t=(8, 9))]
    for d in range(4):
        spans += [_span("sample.draws", 0.8, depth=d),
                  _span("sample.hit", 0.4, 2.0, depth=d),
                  _span("kernels.b1", 1.6, depth=d),
                  _span("sample.shade", 1.2, depth=d)]
    counts = [_count("sample.lanes", 100, depth=0),
              _count("sample.lanes", 100, depth=1),
              _count("b1.alive", 100, depth=0, any_hit=False),
              _count("b1.alive", 60, depth=1, any_hit=False),
              _count("b1.alive", 50, depth=1, any_hit=True),
              _count("b1.alive", 30, any_hit=False)]
    return dict(spans=spans, counts=counts, counters={}, dropped=0)


@pytest.fixture
def program(monkeypatch):
    from voxelrt_torch.utils import profiling

    got = {}

    def recorded(t0, t1):
        got["window"] = (t0, t1)
        return _program()

    monkeypatch.setattr(profiling, "recorded", recorded)
    return got


def test_the_new_metrics_are_these_ten():
    """The ten metrics of the spans and counters are among ``NEW``; a later
    metric of a span or a counter joins them as an entry and a reader, and
    the tests below hold it too."""
    assert set(TEN) <= set(NEW), sorted(set(TEN) - set(NEW))


@pytest.mark.parametrize("name,value", [
    ("sample.raygen_ms_per_spp", 1.6 / 16),
    ("sample.draws_ms_per_spp", 4 * 0.8 / 16),
    ("sample.hit_ms_per_spp", 4 * 0.4 / 16),
    ("sample.shade_ms_per_spp", 4 * 1.2 / 16),
    ("sample.sky_ms_per_spp", 0.48 / 16),
    ("sample.epilogue_ms_per_spp", 0.32 / 16),
    ("pipeline.embed_ms_per_spp", 0.8 / 16),
    ("pipeline.resolve_ms_per_spp", 3.2 / 16),
    ("pipeline.trace_frame_idle_ms_per_spp", 1.0 / 16),
    ("sample.alive_lane_pct", 100.0 * 160 / 200),
])
def test_program_readers(program, name, value):
    rec = _record()
    assert spec.metric_reader(name)(rec) == pytest.approx(value)
    assert program["window"] == rec["traced"]["window_ns"]


def test_a_program_without_the_recorder_gives_nothing(monkeypatch):
    from voxelrt_torch.utils import profiling

    monkeypatch.delattr(profiling, "recorded")
    for name in NEW:
        assert spec.metric_reader(name)(_record()) is None, name


def test_spans_without_stream_times_give_nothing(monkeypatch):
    from voxelrt_torch.utils import profiling

    def recorded(t0, t1):
        r = _program()
        for s in r["spans"]:
            s["stream_ms"] = s["stream_self_ms"] = None
        r["counts"] = []
        return r

    monkeypatch.setattr(profiling, "recorded", recorded)
    for name in TEN:
        if name != "pipeline.trace_frame_idle_ms_per_spp":
            assert spec.metric_reader(name)(_record()) is None, name


@pytest.mark.cuda
def test_the_program_record_on_the_card(cuda_device):
    """One traced chunk of the smaller cell: every new metric that lists
    the cell is read, the stage spans tile the card's busy time, B1's
    stream time is its profiled time, and no span's range is among the
    device's events."""
    import torch

    from voxelrt_torch.utils import profiling

    cell = spec.cell("example6-still-720p")
    job = runner.kind_module(cell["traffic"]["kind"]).Run(
        cell, 2 ** 31 + 7, "cuda")
    job.setup()
    job.window(0.0)
    rec = dict(setup={}, window=None, traced=job.traced(spec.ROOT),
               peaks=spec.peaks(torch.cuda.get_device_name(job.device)))
    t = rec["traced"]
    got = {m["name"]: spec.metric_reader(m["name"])(rec)
           for m in cell["per_layer"] if m["name"] in NEW
           and cell["workload"]["name"] in m["workloads"]}
    assert None not in got.values(), got
    assert 0.0 < got["sample.alive_lane_pct"] <= 100.0
    r = profiling.recorded(*t["window_ns"])
    spp = t["spp"]

    def stream(name, key):
        return sum(s[key] for s in r["spans"] if s["name"] == name)

    cover = (sum(got[n] for n in STAGES) * spp
             + stream("kernels.b1", "stream_ms")
             + sum(stream(n, "stream_self_ms") for n in HOLDERS))
    busy_ms = trace.busy_ns(t) / 1e6
    window_ms = (t["window_ns"][1] - t["window_ns"][0]) / 1e6
    assert 0.99 * busy_ms <= cover <= window_ms, (cover, busy_ms, window_ms)
    b1 = spec.metric_reader("kernels.b1_ms_per_spp")(rec) * spp
    assert abs(stream("kernels.b1", "stream_ms") - b1) <= 0.1 * b1
    names = {s["name"] for s in r["spans"]}
    assert not [e for e in t["events"] if e[0] in names]
    job.close()
