"""The harness on the CPU: every file it finds by name parses and keeps to
the benchmark's contract, the metric readers read what they should from a
record, B1's byte count agrees with a count by hand, a run's result line
has the contract's keys, and a run loads neither JAX nor the JAX package."""

import glob
import json
import os
import re
import subprocess
import sys
import time

import pytest

from benchmark.harness import runner, spec, trace
from benchmark.metrics.b1_bytes import dispatch_bytes
from benchmark.tests.cells import ROOT, tiny_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.benchmark()


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert os.path.isdir(os.path.join(ROOT, p))
    assert len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        f = json.load(open(os.path.join(ROOT, c["file"])))
        assert f["name"] == c["name"] and f["source"] == c["source"]
        assert f["reduced"] == c["reduced"]
        assert c["source"].startswith("https://")
    assert len({c["source"] for c in BENCH["configs"]}) == len(
        BENCH["configs"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200


def test_every_per_layer_metric_lists_its_cells():
    """Every per-layer metric names the cells it is read in, each a
    workload of the file, so that a later cell joins only the lists it
    names."""
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["per_layer"]:
        assert m.get("workloads"), m["name"]
        assert len(m["workloads"]) == len(set(m["workloads"])), m["name"]
        assert set(m["workloads"]) <= cells, m["name"]


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files(name):
    cell = spec.cell(name)
    reported = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in reported and len(reported) >= 2
    assert cell["per_layer"]
    kind = runner.kind_module(cell["traffic"]["kind"])
    assert callable(kind.Run) and callable(kind.judge)
    assert set(cell["check"]["limits"]) == {"hdr_mean_rel_gap",
                                            "ldr_mean_abs_gap", "off_share"}
    for m in cell["end_to_end"] + cell["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))


def test_every_file_under_the_benchmark_parses():
    for path in glob.glob(os.path.join(ROOT, "benchmark", "**", "*.json"),
                          recursive=True):
        json.load(open(path))
    for path in glob.glob(os.path.join(ROOT, "benchmark", "metrics",
                                       "*.py")):
        stem = os.path.basename(path)[:-3]
        assert NAME.match(stem), stem
    metrics = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    readers = {os.path.basename(p)[:-3] for p in glob.glob(
        os.path.join(ROOT, "benchmark", "metrics", "*.py"))}
    assert metrics <= readers


@pytest.mark.parametrize("nee,any_hit,expect", [
    (True, False, 10 * 1 + 6 * (24 + 4 + 12) + 10 * 44 + 4 + 48 + 100),
    (False, False, 10 * 1 + 6 * (24 + 4) + 10 * 40 + 4 + 100),
    (False, True, 10 * 1 + 6 * (24 + 4) + 10 * 4 + 4 + 100),
])
def test_b1_bytes_by_hand(nee, any_hit, expect):
    # 10 rays, 6 alive, a 1-byte mask, tmax per ray, 100 bytes of tables
    assert dispatch_bytes(10, 6, 1, True, nee, any_hit, 100) == expect


def test_b1_dispatch_record_of_a_real_dispatch(monkeypatch):
    """The record of what a still launch hands B1 on the CPU: four
    closest-hit dispatches with NEE, the alive counts falling with depth."""
    from voxelrt_torch.app.examples import build_example
    from voxelrt_torch.ops import prng
    from voxelrt_torch.render import pathtracer, pipeline

    got = []
    orig = pathtracer.raytrace

    def rec(*args, **kw):
        got.append(trace.dispatch_record(args, kw))
        return orig(*args, **kw)

    monkeypatch.setattr(pathtracer, "raytrace", rec)
    r = build_example("example9", "cpu", (16, 8), samples_per_launch=1
                      ).renderer
    r.prepare_data()
    pipeline.accumulate(r.cfg, r.scene_data, r._params(1e9), r.state,
                        prng.key(3))
    got = [trace.settle_dispatch(d) for d in got]
    assert len(got) == 4
    assert all(d["nee"] and not d["any_hit"] and d["tmax_per_ray"]
               and d["n"] == 128 and d["mask_bytes"] == 1 for d in got)
    alive = [d["n_alive"] for d in got]
    assert alive[0] == 128 and alive == sorted(alive, reverse=True)
    nbytes = sum(t.numel() * 4 for t in r.scene_data.tables[:-1])
    assert got[0]["table_bytes"] == nbytes


def test_port_kernels_are_read_from_the_sources():
    k = trace.port_kernels(ROOT)
    assert k["dda"] == {"compact_kernel", "closest_kernel", "anyhit_kernel",
                        "nee_shadow_kernel"}
    assert {"point_kernel", "dirs_kernel", "dirs2_kernel"} <= k["texfetch"]
    assert "taps_kernel" in k["resample"]
    assert trace.matches("void closest_kernel<true>(Tables, Rays)",
                         k["dda"])
    assert not trace.matches("void dirs2_kernel(int4 const*)", {"dirs_kernel"})
    assert not trace.matches("void at::native::vectorized_elementwise_kernel"
                             "<4, at::native::AbsFunctor<float>>", k["dda"])


def _record():
    """A traced chunk of 16 samples in 2 launches by hand: B1 1.0 ms, glue
    6.5 ms in three kernels and a copy, the device busy 6.5 of 10 ms; the
    enqueue 9 ms, in which 64 launch calls take 5 us into an empty queue,
    100 take 30 us at a full one and a synchronise 0.5 ms."""
    ms, us = 1_000_000, 1_000
    t0 = 10 ** 18
    runtime = [("cudaLaunchKernel", t0 + i * 10 * us, t0 + i * 10 * us
                + (5 if i < 64 else 30) * us) for i in range(164)]
    runtime += [("cudaStreamSynchronize", t0 + 2 * ms, t0 + 2 * ms + ms // 2),
                ("cudaDeviceSynchronize", t0 + 9 * ms, t0 + 10 * ms)]
    events = [("void compact_kernel<false>(bool const*)", t0, t0 + ms // 2),
              ("void closest_kernel<true>(Tables)", t0 + ms // 2, t0 + ms),
              ("void at::native::elementwise_kernel<128, 4>", t0 + ms,
               t0 + 3 * ms),
              ("void at::native::reduce_kernel<512, 1>", t0 + 2 * ms,
               t0 + 4 * ms),
              ("Memcpy HtoD (Pinned -> Device)", t0 + 5 * ms, t0 + 6 * ms),
              ("void at::native::index_elementwise_kernel", t0 + 6 * ms,
               t0 + 7 * ms + ms // 2)]
    return dict(setup=dict(prepare_s=1.5, warmup_s=4.0, setup_s=9.0),
                window=dict(spp=640, seconds=16.0, peak_bytes=2 ** 33),
                peaks={"hbm_bytes_per_s": 1e12},
                traced=dict(spp=16, launches=2, window_ns=(t0, t0 + 10 * ms),
                            enqueue_ns=(t0, t0 + 9 * ms), runtime=runtime,
                            events=events, spans=[],
                            kernels={"dda": {"compact_kernel",
                                             "closest_kernel"}},
                            b1_source="dda",
                            dispatches=[dict(n=10, n_alive=6, mask_bytes=1,
                                             tmax_per_ray=True, nee=True,
                                             any_hit=False,
                                             table_bytes=100)]))


@pytest.mark.parametrize("name,value", [
    ("setup_s", 9.0), ("spp_per_s", 40.0), ("peak_mem_gib", 8.0),
    ("setup.prepare_s", 1.5), ("setup.warmup_s", 4.0),
    ("pipeline.host_ms_per_launch", (9.0 - 100 * 0.025 - 0.5) / 2),
    ("pipeline.kernels_per_spp", 5 / 16),
    ("sample.glue_ms_per_spp", 6.5 / 16),
    ("kernels.b1_ms_per_spp", 1.0 / 16),
    ("kernels.b1_roofline", 100.0 * (842 / 1e12) / 1e-3),
    ("device.idle_pct", 100.0 * (1 - 6.5 / 10)),
])
def test_metric_readers(name, value):
    assert spec.metric_reader(name)(_record()) == pytest.approx(value)


def test_readers_find_nothing_to_read():
    rec = dict(setup={}, window=None, peaks=None)
    for m in BENCH["per_layer"]:
        assert spec.metric_reader(m["name"])(rec) is None, m["name"]


def test_idle_gaps_by_host_span():
    rec = _record()["traced"]
    ms = 1_000_000
    t0 = rec["window_ns"][0]
    rec["spans"] = [("pipeline.accumulate", t0, t0 + 9 * ms),
                    ("pipeline.resolve_frame", t0 + 4 * ms, t0 + 5 * ms)]
    gaps = trace.idle_gaps(rec["events"], rec["spans"], rec["window_ns"])
    assert gaps == pytest.approx({"pipeline.resolve_frame": 0.001,
                                  "pipeline.accumulate": 0.0025})
    b = trace.breakdown(rec)
    assert b["device_ops"][0][1] == pytest.approx(0.002)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def test_result_line_has_the_contracts_keys():
    cell = tiny_cell("example9-still-1080p")
    result, lines = runner.run(cell, 12345, 0.0, True, "cpu",
                               time.perf_counter())
    keys = list(result)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks" and set(keys) <= {
        "correct", "attempted", "failed", "metrics", "device", "breakdown",
        "checks"}
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert lines[-3:] == [f"check {n}: {c['value']!r} (limit "
                          f"{c['limit']!r})"
                          for n, c in result["checks"].items()]
    json.dumps(result)


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    sys.path.insert(0, os.path.join(ROOT, "benchmark"))
    try:
        import run
    finally:
        sys.path.pop(0)
    for m in list(sys.modules):
        if m.split(".")[0] in run.FORBIDDEN:
            monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, "voxelrt_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "voxelrt.ops", object())
    assert run.forbidden_modules() == ["voxelrt.ops"]


def test_a_run_loads_no_jax():
    """A whole run on the CPU in a fresh interpreter, with the example's
    scene built through the port: no module of JAX or of the JAX package
    is loaded (``examples/_common.py`` imports ``voxelrt`` inside
    ``make_scene``, which the port's ``build_example`` replaces)."""
    code = (
        "import sys, time; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "from benchmark.harness import runner\n"
        "from benchmark.tests.cells import tiny_cell\n"
        "import run\n"
        "res, _ = runner.run(tiny_cell('example6-still-720p'), 1, 0.0, "
        "False, 'cpu', time.perf_counter())\n"
        "assert res['correct']\n"
        "print(run.forbidden_modules())\n"
        % (ROOT, os.path.join(ROOT, "benchmark")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card():
    """Here there is no CUDA card: the command exits with another code
    than 0 and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "example6-still-720p", "--seed", "3000000000", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_is_correct_on_the_card(cuda_device):
    """A short window of the smaller cell on the card, checked against the
    reference."""
    cell = spec.cell("example6-still-720p")
    cell["check"] = dict(cell["check"], pixels=256)
    result, lines = runner.run(cell, 2 ** 31 + 3, 1.0, False, "cuda",
                               time.perf_counter())
    assert result["correct"], lines
