"""PyTorch port, kernel D (``ops/draws_kernel.py`` + ``csrc/draws.cu``):
the wavefront sample's PCG3D draws with the lane's key fold, one launch for
a range of slots.

On the CPU its plain twin ``draws_twin`` (wrapping int32 arithmetic, as the
kernel's uint32) is held bit for bit to ``fold_in`` then ``Pcg3dDraws``
(int64 arithmetic) on a launch's own lanes and keys, for every slot the
sample reads; ``trace_sample`` taking its draws through the kernel's route,
the twin standing in for the launch, gives the CPU route's outputs bit for
bit; and the benchmark's reader of ``kernels.draws_roofline`` counts the
kernel's bytes as its argument layout says. On the card the kernel is held
to the twin and to ``Pcg3dDraws`` by bits."""

import time

import pytest
import torch

from benchmark.metrics.draws_bytes import launch_bytes
from voxelrt_torch.app.testing import (make_params, make_scene_data,
                                       production_test_config, tiny_config)
from voxelrt_torch.ops import draws_kernel, prng
from voxelrt_torch.render import pathtracer, pipeline

# One thread per test process: the suite runs several processes side by
# side.
torch.set_num_threads(1)

K = 4  # samples a launch: 4 sample keys over the 64x32 image's lanes
N_SLOTS = 33  # 8 a depth for 4 depths, and ReSTIR's WRS slot


def _lanes(seed, k=K, device="cpu"):
    """The pixels and sample keys of a launch's k x 64 x 32 lanes, as
    ``trace_frame`` hands them to ``trace_sample``."""
    cfg = production_test_config(samples_per_launch=k)
    u, v, s_of_ray = pipeline.wavefront_constants(cfg, 1.0, device)
    keys, _ = pipeline.launch_keys(prng.fold_in(prng.key(seed), 1), k)
    keys = keys.to(device)
    return cfg, u, v, (keys[0][s_of_ray], keys[1][s_of_ray])


def _pcg3d_rows(u, v, sample_keys, height, slots):
    """``trace_sample``'s CPU route: ``fold_in`` then ``Pcg3dDraws``."""
    pid = u.to(torch.int64) * height + v.to(torch.int64)
    kd = prng.fold_in(sample_keys, pid)
    d = pathtracer.Pcg3dDraws(kd[0], kd[1])
    return torch.stack([d[s] for s in slots])


def _bits(x):
    """A tensor's bits, floats as integers of their width (NaNs compare)."""
    if not x.is_floating_point():
        return x
    return x.view({2: torch.int16, 4: torch.int32,
                   8: torch.int64}[x.element_size()])


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11, 5 * 2 ** 32 + 7])
def test_twin_equals_fold_in_then_pcg3d(seed):
    cfg, u, v, keys = _lanes(seed)
    h = cfg.image_res[1]
    assert u.shape[0] == K * 64 * 32
    assert len(set(keys[0].tolist())) == K
    want = _pcg3d_rows(u, v, keys, h, range(N_SLOTS))
    got = draws_kernel.draws_twin(u, v, keys, h, 0, N_SLOTS)
    assert got.shape == (N_SLOTS, u.shape[0]) and got.dtype == torch.float32
    assert torch.equal(_bits(got), _bits(want))
    # uniforms in [0, 1) of 24 bits, and not one value for every lane
    assert float(got.min()) >= 0.0 and float(got.max()) < 1.0
    assert torch.equal(got * 2 ** 24, torch.floor(got * 2 ** 24))
    assert all(len(set(r.tolist())) > u.shape[0] // 2 for r in got)


@pytest.mark.parametrize("lo,k", [(0, 8), (8, 8), (16, 8), (24, 8), (32, 1),
                                  (5, 7), (2, 1)])
def test_twin_slot_ranges_are_rows_of_the_whole(lo, k):
    """The route's launches (8 slots a depth, ReSTIR's slot 32) and ranges
    that start inside a triple are rows of the whole range."""
    cfg, u, v, keys = _lanes(9)
    h = cfg.image_res[1]
    whole = draws_kernel.draws_twin(u, v, keys, h, 0, N_SLOTS)
    got = draws_kernel.draws_twin(u, v, keys, h, lo, k)
    assert torch.equal(_bits(got), _bits(whole[lo:lo + k]))


def test_twin_takes_one_key_for_every_lane():
    """Python-int sample keys (one key shared by the lanes) draw what the
    same key given a lane draws."""
    cfg, u, v, _ = _lanes(4)
    h = cfg.image_res[1]
    key = prng.fold_in(prng.key(2 ** 33 + 5), 7001)
    n = u.shape[0]
    lane = tuple(torch.full((n,), w, dtype=torch.int64) for w in key)
    got = draws_kernel.draws_twin(u, v, key, h, 0, N_SLOTS)
    assert torch.equal(_bits(got),
                       _bits(draws_kernel.draws_twin(u, v, lane, h, 0,
                                                     N_SLOTS)))
    assert torch.equal(_bits(got),
                       _bits(_pcg3d_rows(u, v, key, h, range(N_SLOTS))))


@pytest.mark.parametrize("device,over,applies", [
    ("cuda", {}, True),
    ("cpu", {}, False),
    ("cuda", dict(rng_draws="table"), False),
    ("cuda", dict(use_restir_pt=True), True),
    ("cuda", dict(sort_rays=True), True),
    ("cuda", dict(nee_in_kernel=False), True),
])
def test_which_routes_take_the_kernel(device, over, applies):
    cfg = tiny_config(**over)
    assert draws_kernel.draws_kernel_applies(cfg, device) is applies
    assert draws_kernel.draws_kernel_applies(
        cfg, torch.device(device)) is applies


def _trace(cfg, scene, params, k, seed):
    u, v, s_of_ray = pipeline.wavefront_constants(cfg, 1.0, "cpu")
    keys, jit = pipeline.launch_keys(prng.fold_in(prng.key(seed), 2), k)
    return pathtracer.trace_sample(
        cfg, scene, params, u, v, (keys[0][s_of_ray], keys[1][s_of_ray]),
        (jit[s_of_ray, 0], jit[s_of_ray, 1]))


def _flat(out, prefix=""):
    """(name, tensor) of every tensor in a ``trace_sample`` output."""
    for name, x in out.items():
        if isinstance(x, dict):
            yield from _flat(x, f"{prefix}{name}.")
        elif isinstance(x, torch.Tensor):
            yield prefix + name, x
        else:
            for i, c in enumerate(x):
                yield f"{prefix}{name}[{i}]", c


@pytest.mark.parametrize("over,k", [
    ({}, 2),
    (dict(use_restir_pt=True), 1),
    (dict(sort_rays=True), 2),
], ids=["still", "restir", "sorted"])
def test_trace_sample_through_the_kernel_route(monkeypatch, over, k):
    """``trace_sample`` on the kernel's route, with the twin standing in
    for each launch, gives the CPU route's outputs bit for bit: one launch
    of 8 slots a depth and, under ReSTIR with a sun, one of slot 32."""
    cfg = tiny_config(samples_per_launch=k, **over)
    scene, params = make_scene_data(cfg, "cpu"), make_params(cfg, "cpu")
    want = dict(_flat(_trace(cfg, scene, params, k, 21)))

    calls = []

    def launch(u, v, sample_keys, height, lo, n_slots):
        calls.append((lo, n_slots))
        assert height == cfg.image_res[1]
        return draws_kernel.draws_twin(u, v, sample_keys, height, lo,
                                       n_slots)

    monkeypatch.setattr(draws_kernel, "draws_kernel_applies",
                        lambda c, d: True)
    monkeypatch.setattr(draws_kernel, "pcg3d_draws", launch)
    got = dict(_flat(_trace(cfg, scene, params, k, 21)))
    depths = [(8 * d, 8) for d in range(cfg.max_ray_depth)]
    wrs = [(8 * cfg.max_ray_depth, 1)] if cfg.use_restir_pt else []
    assert calls == depths + wrs
    assert want.keys() == got.keys()
    for name, x in want.items():
        assert torch.equal(_bits(x), _bits(got[name])), name


# --- the benchmark's byte count and roofline reader --------------------------

MS = 1_000_000


def _roofline_record(counts, kernel_events, kernels=True):
    t0 = 10 ** 18
    events = [("void (anonymous namespace)::pcg3d_draws_kernel"
               "((anonymous namespace)::Args)", t0 + i * MS, t0 + i * MS + d)
              for i, d in enumerate(kernel_events)]
    events.append(("void at::native::elementwise_kernel<128, 4>", t0,
                   t0 + 5 * MS))
    names = {"draws": {"pcg3d_draws_kernel"}} if kernels else {}
    traced = dict(spp=16, window_ns=(t0, t0 + 10 * MS), events=events,
                  kernels=dict(names, dda={"closest_kernel"}))
    return dict(traced=traced, peaks={"hbm_bytes_per_s": 1e12}), counts


def _reader():
    from benchmark.harness import spec

    return spec.metric_reader("kernels.draws_roofline")


def _count(n, slots, lane_keys=True):
    return dict(name="draws.lanes", attrs=dict(slots=slots,
                                               lane_keys=lane_keys),
                value=n, t_ns=0, span=None)


def _stub(monkeypatch, counts):
    from voxelrt_torch.utils import profiling

    monkeypatch.setattr(profiling, "recorded", lambda t0, t1: dict(
        spans=[], counts=counts, counters={}, dropped=0))


@pytest.mark.parametrize("lanes,slots,lane_keys,expect", [
    (1000, 8, True, 1000 * (8 + 16 + 32)),
    (1000, 1, True, 1000 * (8 + 16 + 4)),
    (1000, 8, False, 1000 * (8 + 32)),
    (14_745_600, 8, True, 825_753_600),
])
def test_draws_bytes_by_hand(lanes, slots, lane_keys, expect):
    assert launch_bytes(lanes, slots, lane_keys) == expect


def test_roofline_reads_bytes_over_kernel_time(monkeypatch):
    # two launches of 1e6 lanes and 8 slots: 56e6 B each, 56 us each at
    # 1e12 B/s, run in 100 us and 300 us
    counts = [_count(10 ** 6, 8), _count(10 ** 6, 8),
              dict(name="sample.lanes", attrs=dict(depth=0), value=10 ** 6,
                   t_ns=0, span=None)]
    rec, counts = _roofline_record(counts, [100_000, 300_000])
    _stub(monkeypatch, counts)
    assert _reader()(rec) == pytest.approx(100.0 * 112e-6 / 400e-6)


def test_roofline_counts_the_launches_the_profiler_saw(monkeypatch):
    """Where the profiler dropped a launch's events, the bytes are the
    launches' mean times the launches it saw."""
    rec, counts = _roofline_record([_count(10 ** 6, 8), _count(10 ** 6, 8)],
                                   [112_000])
    _stub(monkeypatch, counts)
    assert _reader()(rec) == pytest.approx(50.0)


@pytest.mark.parametrize("case", ["no_trace", "no_kernel", "no_recorder",
                                  "no_counter", "no_events"])
def test_roofline_gives_nothing_without_what_it_reads(monkeypatch, case):
    """Nothing where the run was not traced, the program has no kernel D
    (an older program), no recorder, no ``draws.lanes`` counter, or the
    profiler saw none of the kernel's events."""
    from voxelrt_torch.utils import profiling

    rec, counts = _roofline_record(
        [] if case == "no_counter" else [_count(10 ** 6, 8)],
        [] if case == "no_events" else [100_000],
        kernels=case != "no_kernel")
    if case == "no_trace":
        rec = dict(rec, traced=None)
    if case == "no_recorder":
        monkeypatch.delattr(profiling, "recorded")
    else:
        _stub(monkeypatch, counts)
    assert _reader()(rec) is None


# --- on the card --------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11])
def test_kernel_equals_twin_and_pcg3d_on_card(seed):
    """Kernel D at 16 x 64 x 32 lanes, for the route's launches and the
    whole range, equals the twin and ``fold_in`` then ``Pcg3dDraws`` on the
    card by bits; the launches are counted, and so are its lanes inside a
    profiler session."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel D is a CUDA kernel")
    from torch.profiler import ProfilerActivity, profile

    from voxelrt_torch.ops import _cuda
    from voxelrt_torch.utils import profiling

    cfg, u, v, keys = _lanes(seed, k=16, device="cuda")
    h = cfg.image_res[1]
    want = _pcg3d_rows(u, v, keys, h, range(N_SLOTS))
    twin = draws_kernel.draws_twin(u, v, keys, h, 0, N_SLOTS)
    assert torch.equal(_bits(twin), _bits(want))
    before = _cuda.LAUNCHES["draws"]
    ranges = [(0, N_SLOTS), (0, 8), (8, 8), (16, 8), (24, 8), (32, 1),
              (5, 7)]
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        got = [draws_kernel.pcg3d_draws(u, v, keys, h, lo, k)
               for lo, k in ranges]
    torch.cuda.synchronize()
    rec = profiling.recorded(t0, time.time_ns())
    for (lo, k), g in zip(ranges, got):
        assert torch.equal(_bits(g), _bits(want[lo:lo + k])), (lo, k)
    assert _cuda.LAUNCHES["draws"] == before + len(ranges)
    lanes = [(c["value"], c["attrs"]["slots"], c["attrs"]["lane_keys"])
             for c in rec["counts"] if c["name"] == "draws.lanes"]
    assert lanes == [(u.shape[0], k, True) for _, k in ranges]
    # one key for every lane
    key = tuple(int(w[0]) for w in keys)
    one = draws_kernel.pcg3d_draws(u, v, key, h, 0, N_SLOTS)
    assert torch.equal(_bits(one), _bits(_pcg3d_rows(u, v, key, h,
                                                     range(N_SLOTS))))


@pytest.mark.cuda
@pytest.mark.parametrize("over,k", [({}, 2), (dict(use_restir_pt=True), 1)],
                         ids=["still", "restir"])
def test_trace_sample_on_card_takes_the_kernel(monkeypatch, over, k):
    """A launch on the card launches kernel D once a depth (and once for
    ReSTIR's WRS slot) and gives the outputs, bit for bit, of the same
    launch with the draws hashed eagerly by ``Pcg3dDraws``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel D is a CUDA kernel")
    from voxelrt_torch.ops import _cuda

    cfg = tiny_config(samples_per_launch=k, **over)
    scene, params = make_scene_data(cfg, "cuda"), make_params(cfg, "cuda")
    u, v, s_of_ray = pipeline.wavefront_constants(cfg, 1.0, "cuda")
    keys, jit = pipeline.launch_keys(prng.key(8), k)
    keys, jit = keys.cuda(), jit.cuda()
    args = (cfg, scene, params, u, v, (keys[0][s_of_ray], keys[1][s_of_ray]),
            (jit[s_of_ray, 0], jit[s_of_ray, 1]))
    before = _cuda.LAUNCHES["draws"]
    got = dict(_flat(pathtracer.trace_sample(*args)))
    launches = cfg.max_ray_depth + (1 if cfg.use_restir_pt else 0)
    assert _cuda.LAUNCHES["draws"] == before + launches
    monkeypatch.setattr(draws_kernel, "draws_kernel_applies",
                        lambda c, d: False)
    want = dict(_flat(pathtracer.trace_sample(*args)))
    assert _cuda.LAUNCHES["draws"] == before + launches
    assert want.keys() == got.keys()
    for name, x in want.items():
        assert torch.equal(_bits(x), _bits(got[name])), name
