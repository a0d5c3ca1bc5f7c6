"""PyTorch port, kernel H (``ops/hit_kernel.py`` + ``csrc/hit.cu``): the
glue of a closest-hit ``next_hit`` on the card, B1's inputs formed before
the dispatch and the ``Hit`` after it.

On the CPU: which calls take the kernel; ``trace_sample`` on the kernel's
route, the plain twins ``hit_prepare_eager`` and ``hit_merge_eager``
standing in for the launches, gives the eager route's outputs bit for bit
(one launch of each stage a closest-hit dispatch, none for an any-hit
one); the eager route gives what ``next_hit`` as one eager pass gave; and
the benchmark's reader of ``kernels.hit_roofline`` counts the kernel's
bytes as its argument layout says. On the card the kernel is held to the
twins by bits, on crafted lanes (dead lanes, floor hits from below,
``dy == 0``, misses, voxels nearer and farther than the floor, cell edges
and corners, emissive voxels and floors) and on the states of a launch at
each depth, with and without in-kernel NEE."""

import pytest
import torch

from benchmark.metrics.hit_bytes import launch_bytes
from voxelrt_torch.app.testing import make_params, make_scene_data, tiny_config
from voxelrt_torch.ops import dda_kernel, hit_kernel, prng, v3
from voxelrt_torch.ops.sampling import EPS, INF, length, make_orthonormal_basis
from voxelrt_torch.ops.v3 import V3, vclip, vwhere
from voxelrt_torch.render import pathtracer, pipeline

# One thread per test process: the suite runs several processes side by
# side.
torch.set_num_threads(1)

ROUTES = [({}, 2), (dict(use_restir_pt=True), 1), (dict(sort_rays=True), 2),
          (dict(nee_in_kernel=False), 2)]
ROUTE_IDS = ["still", "restir", "sorted", "path_a"]


def _bits(x):
    """A tensor's bits, floats as integers of their width (NaNs compare)."""
    if not x.is_floating_point():
        return x
    return x.view({2: torch.int16, 4: torch.int32,
                   8: torch.int64}[x.element_size()])


def _flat(out, prefix=""):
    """(name, tensor) of every tensor in a nest of dicts, tuples and V3s."""
    items = out.items() if isinstance(out, dict) else enumerate(out)
    for name, x in items:
        if isinstance(x, torch.Tensor):
            yield f"{prefix}{name}", x
        elif x is not None:
            yield from _flat(x, f"{prefix}{name}.")


def _same(want, got):
    want, got = dict(_flat(want)), dict(_flat(got))
    assert want.keys() == got.keys()
    for name, x in want.items():
        assert torch.equal(_bits(x), _bits(got[name])), name


def _launch(cfg, device, seed):
    """``trace_sample``'s arguments for one launch of ``cfg`` on
    ``device``."""
    scene, params = make_scene_data(cfg, device), make_params(cfg, device)
    u, v, s_of_ray = pipeline.wavefront_constants(cfg, 1.0, device)
    keys, jit = pipeline.launch_keys(prng.fold_in(prng.key(seed), 2),
                                     cfg.samples_per_launch)
    keys, jit = keys.to(device), jit.to(device)
    return (cfg, scene, params, u, v, (keys[0][s_of_ray], keys[1][s_of_ray]),
            (jit[s_of_ray, 0], jit[s_of_ray, 1]))


# --- which calls take the kernel ---------------------------------------------

@pytest.mark.parametrize("device,over,applies", [
    ("cuda", {}, True),
    ("cpu", {}, False),
    ("cuda", dict(use_restir_pt=True), True),
    ("cuda", dict(sort_rays=True), True),
    ("cuda", dict(nee_in_kernel=False), True),
    ("cuda", dict(use_directional_light=False), True),
    ("cpu", dict(use_restir_pt=True), False),
])
def test_which_routes_take_the_kernel(device, over, applies):
    cfg = tiny_config(**over)
    assert hit_kernel.hit_kernel_applies(cfg, device) is applies
    assert hit_kernel.hit_kernel_applies(cfg,
                                         torch.device(device)) is applies


@pytest.mark.parametrize("over,k", ROUTES, ids=ROUTE_IDS)
def test_trace_sample_through_the_kernel_route(monkeypatch, over, k):
    """``trace_sample`` on the kernel's route, the twins standing in for
    the launches, gives the eager route's outputs bit for bit: one launch
    of each stage a depth's closest-hit dispatch, with NEE where B1 takes
    it in-kernel, and none for the any-hit dispatches of ReSTIR and path
    A'."""
    cfg = tiny_config(samples_per_launch=k, **over)
    args = _launch(cfg, "cpu", 21)
    want = pathtracer.trace_sample(*args)

    calls = []

    def prepare(cfg_, params, pos, d, mask, nee):
        calls.append(("prepare", nee))
        return pathtracer.hit_prepare_eager(cfg_, params, pos, d, mask, nee)

    def merge(cfg_, params, pos, d, mask, tr):
        calls.append(("merge", tr.nee_visible is not None))
        return pathtracer.hit_merge_eager(cfg_, params, pos, d, mask, tr)

    monkeypatch.setattr(hit_kernel, "hit_kernel_applies", lambda c, d: True)
    monkeypatch.setattr(hit_kernel, "hit_prepare", prepare)
    monkeypatch.setattr(hit_kernel, "hit_merge", merge)
    got = pathtracer.trace_sample(*args)
    nee = (cfg.nee_in_kernel and not cfg.use_restir_pt
           and not cfg.sort_rays)
    assert calls == [("prepare", nee), ("merge", nee)] * cfg.max_ray_depth
    _same(want, got)


def _one_pass_next_hit(cfg, scene, params, pos, d, mask, shadow_ray=False,
                       sun_shadow=False, nee_u=None, coherent=False, **_):
    """``next_hit`` as one eager pass, the floor's temporaries kept through
    B1's dispatch and the NEE launch scalars made at every call, as it was
    before it took the two stages of kernel H."""
    n = pos.x.shape[0]
    dev = pos.x.device
    closest = torch.full((n,), INF, dtype=torch.float32, device=dev)
    normal = v3.zeros(n, dev)
    albedo = v3.ones(n, dev)
    hit_light = torch.zeros((n,), dtype=torch.bool, device=dev)
    mat_id = torch.zeros((n,), dtype=torch.int32, device=dev)
    dy = d.y
    floor_dist = (params.floor_height - pos.y) / torch.where(
        dy == 0.0, 1e-20, dy)
    hit_pos = pos + d * floor_dist
    extent = length(hit_pos - hit_pos.y)
    floor_ok = mask & (floor_dist > EPS) & (floor_dist < closest) & (
        extent < 10.0)
    closest = torch.where(floor_ok, floor_dist, closest)
    normal = vwhere(floor_ok, V3(0.0, 1.0, 0.0), normal)
    flip = floor_ok & (dy > 0.0)
    normal = vwhere(flip, -normal, normal)
    albedo = vwhere(floor_ok, v3.splat(params.floor_color), albedo)
    hit_light = torch.where(floor_ok, params.floor_material == 2, hit_light)
    mat_id = torch.where(floor_ok, params.floor_material.to(torch.int32),
                         mat_id)
    inv_size = 1.0 / cfg.voxel_dx
    eye_scaled = pos * inv_size - cfg.grid_offset
    tmax = torch.where(mask, INF, 0.0)
    nee = None
    if nee_u is not None:
        floor_valid = mask & (floor_dist > EPS) & (extent < 10.0)
        alt_t = torch.where(floor_valid, floor_dist * inv_size, INF)
        ldir = v3.splat(params.light_direction)
        tang_l, bitang_l = make_orthonormal_basis(ldir)
        nee = dda_kernel.nee_params(nee_u, alt_t, ldir, tang_l, bitang_l,
                                    params.light_cone_cos_theta_max,
                                    EPS * inv_size, EPS, dev)
    if cfg.sort_rays and not coherent:
        tr = pathtracer._trace_voxels_sorted(cfg, scene.tables, eye_scaled,
                                             d, mask, shadow_ray, sun_shadow)
    else:
        tr = dda_kernel.raytrace(
            scene.tables, eye_scaled, d, EPS, tmax, cfg.max_dda_advances,
            nee=nee, alive=mask, any_hit=shadow_ray,
            fetch_colors=not shadow_ray, use_sun_open=sun_shadow,
            sun_mode=cfg.dda_sun_mode,
            nee_src_open=cfg.dda_nee_src_open == "on")
    vox_dist = tr.distance * cfg.voxel_dx
    vox_ok = mask & (vox_dist < closest)
    closest = torch.where(vox_ok, vox_dist, closest)
    if shadow_ray:
        return pathtracer.Hit(closest, normal, albedo, hit_light, mat_id,
                              tr.iters)
    uv = vclip(eye_scaled + d * tr.distance
               - V3(*(c.to(torch.float32) for c in tr.ipos)), 0.0, 1.0)
    color, v_is_light, v_mat = pathtracer.fetch_voxel_surface(
        cfg, tr.ipos, uv, tr.color_word, params.voxel_edges)
    normal = vwhere(vox_ok, tr.normal, normal)
    albedo = vwhere(vox_ok, color, albedo)
    hit_light = torch.where(vox_ok, v_is_light, hit_light)
    mat_id = torch.where(vox_ok, v_mat, mat_id)
    hit_out = pathtracer.Hit(closest, normal, albedo, hit_light, mat_id,
                             tr.iters)
    if nee_u is not None:
        return hit_out, tr.nee_visible
    return hit_out


@pytest.mark.parametrize("over,k", ROUTES, ids=ROUTE_IDS)
def test_eager_route_is_unchanged(monkeypatch, over, k):
    """``trace_sample`` on the CPU gives, bit for bit, what it gave with
    ``next_hit`` as one eager pass."""
    cfg = tiny_config(samples_per_launch=k, **over)
    args = _launch(cfg, "cpu", 22)
    got = pathtracer.trace_sample(*args)
    monkeypatch.setattr(pathtracer, "next_hit", _one_pass_next_hit)
    _same(pathtracer.trace_sample(*args), got)


# --- the benchmark's byte count and roofline reader --------------------------

MS = 1_000_000


@pytest.mark.parametrize("lanes,alive,stage,nee,expect", [
    (1000, 0, "prepare", True, 1000),
    (1000, 400, "prepare", True, 1000 + 400 * 44),
    (1000, 400, "prepare", False, 1000 + 400 * 40),
    (1000, 0, "merge", True, 1000 * 34),
    (1000, 400, "merge", True, 1000 * 34 + 400 * 56),
    (1000, 400, "merge", False, 1000 * 34 + 400 * 56),
    # a depth of the 720p cell at its mean alive share: 135 B an alive
    # lane and 35 B a dead one over both launches
    (14_745_600, 7_372_800, "prepare", True, 14_745_600 + 7_372_800 * 44),
])
def test_hit_bytes_by_hand(lanes, alive, stage, nee, expect):
    assert launch_bytes(lanes, alive, stage, nee) == expect


def test_a_dispatch_is_135_bytes_alive_and_35_dead():
    both = (launch_bytes(1, 1, "prepare", True)
            + launch_bytes(1, 1, "merge", True))
    assert both == 135
    assert (launch_bytes(1, 0, "prepare", True)
            + launch_bytes(1, 0, "merge", True)) == 35


def _roofline_record(kernel_events, kernels=True):
    t0 = 10 ** 18
    events = [("void (anonymous namespace)::hit_merge_kernel"
               "((anonymous namespace)::Args)", t0 + i * MS, t0 + i * MS + d)
              for i, d in enumerate(kernel_events)]
    events.append(("void at::native::elementwise_kernel<128, 4>", t0,
                   t0 + 5 * MS))
    names = ({"hit": {"hit_prepare_kernel", "hit_merge_kernel"}}
             if kernels else {})
    traced = dict(spp=16, window_ns=(t0, t0 + 10 * MS), events=events,
                  kernels=dict(names, dda={"closest_kernel"}))
    return dict(traced=traced, peaks={"hbm_bytes_per_s": 1e12})


def _program(depths=1, alive=4 * 10 ** 5, lanes=10 ** 6, drop_alive=False):
    """The program's record of ``depths`` closest-hit dispatches, each in
    its own ``sample.hit`` span: kernel H's two launches, B1's alive count
    inside its ``kernels.b1`` span, and an any-hit dispatch's count beside
    it that the reader must not take."""
    spans, counts = [], []
    for dep in range(depths):
        hit_id, b1_id, sh_id = 3 * dep + 1, 3 * dep + 2, 3 * dep + 3
        spans += [dict(name="sample.hit", id=hit_id, parent=None,
                       attrs=dict(depth=dep)),
                  dict(name="kernels.b1", id=b1_id, parent=hit_id,
                       attrs=dict(depth=dep)),
                  dict(name="kernels.b1", id=sh_id, parent=hit_id,
                       attrs=dict(depth=dep))]
        for stage in ("prepare", "merge"):
            counts.append(dict(name="hit.lanes", value=lanes, t_ns=0,
                               span=hit_id, attrs=dict(depth=dep, nee=True,
                                                       stage=stage)))
        if not drop_alive:
            counts.append(dict(name="b1.alive", value=alive, t_ns=0,
                               span=b1_id,
                               attrs=dict(depth=dep, any_hit=False)))
        counts.append(dict(name="b1.alive", value=lanes, t_ns=0, span=sh_id,
                           attrs=dict(depth=dep, any_hit=True)))
        counts.append(dict(name="sample.lanes", value=lanes, t_ns=0,
                           span=None, attrs=dict(depth=dep)))
    return dict(spans=spans, counts=counts, counters={}, dropped=0)


def _reader():
    from benchmark.harness import spec

    return spec.metric_reader("kernels.hit_roofline")


def _stub(monkeypatch, program):
    from voxelrt_torch.utils import profiling

    monkeypatch.setattr(profiling, "recorded", lambda t0, t1: program)


def test_roofline_reads_bytes_over_kernel_time(monkeypatch):
    # two depths of 1e6 lanes, 4e5 alive: (1e6 + 4e5 * 44) + (34e6 + 4e5 *
    # 56) = 75e6 B a depth, 150 us at 1e12 B/s, run in four launches of 100
    # us each
    _stub(monkeypatch, _program(depths=2))
    rec = _roofline_record([100_000] * 4)
    assert _reader()(rec) == pytest.approx(100.0 * 150e-6 / 400e-6)


def test_roofline_counts_the_launches_the_profiler_saw(monkeypatch):
    """Where the profiler dropped launches' events, the bytes are the
    launches' mean times the launches it saw."""
    _stub(monkeypatch, _program(depths=2))
    rec = _roofline_record([75_000])
    assert _reader()(rec) == pytest.approx(100.0 * (150e-6 / 4) / 75e-6)


def test_roofline_counts_no_alive_lane_it_cannot_pair(monkeypatch):
    """A launch whose dispatch's alive count is not in the record is
    counted with no lane tracing: the bound stays a lower bound."""
    _stub(monkeypatch, _program(drop_alive=True))
    rec = _roofline_record([35_000, 35_000])
    assert _reader()(rec) == pytest.approx(100.0 * 35e-6 / 70e-6)


@pytest.mark.parametrize("case", ["no_trace", "no_kernel", "no_recorder",
                                  "no_counter", "no_events"])
def test_roofline_gives_nothing_without_what_it_reads(monkeypatch, case):
    """Nothing where the run was not traced, the program has no kernel H
    (an older program), no recorder, no ``hit.lanes`` counter, or the
    profiler saw none of the kernel's events."""
    from voxelrt_torch.utils import profiling

    program = _program()
    if case == "no_counter":
        program["counts"] = [c for c in program["counts"]
                             if c["name"] != "hit.lanes"]
    rec = _roofline_record([] if case == "no_events" else [100_000],
                           kernels=case != "no_kernel")
    if case == "no_trace":
        rec = dict(rec, traced=None)
    if case == "no_recorder":
        monkeypatch.delattr(profiling, "recorded")
    else:
        _stub(monkeypatch, program)
    assert _reader()(rec) is None


# --- on the card --------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel H is a CUDA kernel")


class _Trace:
    """B1's closest-hit outputs as ``hit_merge`` reads them."""

    def __init__(self, distance, ipos, normal, color_word, nee_visible=None):
        self.distance, self.ipos, self.normal = distance, ipos, normal
        self.color_word, self.nee_visible = color_word, nee_visible


def _crafted(cfg, n, seed):
    """Rays and B1 outputs over ``n`` lanes on the card that reach every
    branch of the glue: dead lanes, rays from below the floor (the normal
    flips), ``dy`` of 0 and -0, crossings outside the extent, misses (inf
    distance, with zero direction components), voxels nearer and farther
    than the floor, hits on cell faces, edges and corners (cells one off
    the hit's, so the place clamps to 0 or 1), and emissive colour
    words."""
    g = torch.Generator().manual_seed(seed)
    dev = "cuda"
    pos = torch.rand((3, n), generator=g) * 2.0 - 1.0
    pos[1] = pos[1] * 0.5 + 0.3
    below = torch.rand(n, generator=g) < 0.2
    pos[1] = torch.where(below, -0.4 - pos[1].abs(), pos[1])
    d = torch.nn.functional.normalize(torch.randn((3, n), generator=g),
                                      dim=0)
    d[1] = torch.where(below, d[1].abs(), d[1])
    flat = torch.rand(n, generator=g)
    d[1] = torch.where(flat < 0.03, 0.0, torch.where(flat < 0.06, -0.0,
                                                     d[1]))
    far = torch.rand(n, generator=g) < 0.05
    pos[0] = torch.where(far, pos[0] * 40.0, pos[0])
    mask = torch.rand(n, generator=g) < 0.7
    # B1's distance (grid units): a miss, or a voxel nearer or farther
    # than the floor
    floor_dist = (-0.1 - pos[1]) / torch.where(d[1] == 0.0, 1e-20, d[1])
    kind = torch.rand(n, generator=g)
    t_world = torch.where(kind < 0.5, floor_dist * (0.2 + kind),
                          floor_dist * (1.0 + kind))
    t_world = torch.where((kind > 0.85) | ~torch.isfinite(t_world)
                          | (t_world <= 0), torch.rand(n, generator=g),
                          t_world)
    t = t_world / cfg.voxel_dx
    miss = torch.rand(n, generator=g) < 0.1
    t = torch.where(miss, INF, t)
    d[2] = torch.where(miss & (torch.rand(n, generator=g) < 0.5), 0.0, d[2])
    origin = pos / cfg.voxel_dx - cfg.grid_offset
    place = origin + d * t
    cell = torch.floor(torch.nan_to_num(place, nan=0.0, posinf=0.0,
                                        neginf=0.0))
    shift = torch.randint(-1, 2, (3, n), generator=g)
    shift = torch.where(torch.rand((3, n), generator=g) < 0.6, 0, shift)
    ipos = (cell + shift).to(torch.int32)
    axis = torch.randint(0, 3, (n,), generator=g)
    sign = torch.where(torch.rand(n, generator=g) < 0.5, -1.0, 1.0)
    normal = torch.zeros((3, n))
    normal[axis, torch.arange(n)] = sign
    rgb = torch.randint(0, 256, (3, n), generator=g)
    mat = torch.randint(0, 4, (n,), generator=g)
    word = (rgb[0] | (rgb[1] << 8) | (rgb[2] << 16) | (mat << 24))
    word = word.to(torch.int32)

    def lanes(x):
        return V3(*(c.contiguous().to(dev) for c in x))

    tr = _Trace(t.to(dev), lanes(ipos), lanes(normal), word.to(dev))
    return lanes(pos), lanes(d), mask.to(dev), tr


@pytest.mark.cuda
@pytest.mark.parametrize("floor_material", [1, 2])
@pytest.mark.parametrize("seed", [5, 2 ** 31 + 3])
def test_kernel_equals_twins_on_crafted_lanes(floor_material, seed):
    """Both launches, with and without NEE, give the twins' bits on every
    lane of the crafted set; the launches and their lanes are counted."""
    _need_card()
    import time

    from torch.profiler import ProfilerActivity, profile

    from voxelrt_torch.ops import _cuda
    from voxelrt_torch.utils import profiling

    cfg = tiny_config()
    params = make_params(cfg, "cuda")._replace(floor_material=torch.tensor(
        floor_material, dtype=torch.int32, device="cuda"))
    n = 1 << 16
    pos, d, mask, tr = _crafted(cfg, n, seed)
    before = dict(_cuda.LAUNCHES)
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        for nee in (True, False):
            got = hit_kernel.hit_prepare(cfg, params, pos, d, mask, nee)
            _same(pathtracer.hit_prepare_eager(cfg, params, pos, d, mask,
                                               nee), got)
        got = hit_kernel.hit_merge(cfg, params, pos, d, mask, tr)
    torch.cuda.synchronize()
    rec = profiling.recorded(t0, time.time_ns())
    want = pathtracer.hit_merge_eager(cfg, params, pos, d, mask, tr)
    _same(want, got)
    closest, normal, albedo, hit_light, mat_id = want
    # the set reaches the branches it is made for
    floor = mask & (closest == pathtracer.floor_plane(params, pos, d,
                                                      mask)[0])
    assert bool((floor & (normal.y == -1.0)).any())
    assert bool((floor & (normal.y == 1.0)).any())
    # voxels darkened near their cells' edges, and voxels not darkened
    vox = mask & torch.isfinite(tr.distance) & (
        closest == tr.distance * cfg.voxel_dx)
    red = (tr.color_word & 0xFF).to(torch.float32) / 255.0
    assert bool((vox & (red > 0) & (albedo.x < red)).any())
    assert bool((vox & (red > 0) & (albedo.x == red)).any())
    assert bool((mask & hit_light).any())
    assert bool((~mask & (d.y == 0.0)).any() and (mask & (d.y == 0.0)).any())
    assert _cuda.LAUNCHES["hit_prepare"] == before["hit_prepare"] + 2
    assert _cuda.LAUNCHES["hit_merge"] == before["hit_merge"] + 1
    lanes = [(c["value"], c["attrs"]["stage"], c["attrs"]["nee"])
             for c in rec["counts"] if c["name"] == "hit.lanes"]
    assert lanes == [(n, "prepare", True), (n, "prepare", False),
                     (n, "merge", False)]


def _captured_calls(cfg, seed):
    """The closest-hit ``next_hit`` calls of one launch of ``cfg`` on the
    card, each with its arguments copied as it was made."""
    calls = []
    orig = pathtracer.next_hit

    def record(cfg_, scene, params, pos, d, mask, *a, **kw):
        if not kw.get("shadow_ray"):
            calls.append((cfg_, scene, params,
                          V3(*(c.clone() for c in pos)),
                          V3(*(c.clone() for c in d)), mask.clone(), kw))
        return orig(cfg_, scene, params, pos, d, mask, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pathtracer, "next_hit", record)
        pathtracer.trace_sample(*_launch(cfg, "cuda", seed))
    return calls


@pytest.mark.cuda
@pytest.mark.parametrize("over", [{}, dict(nee_in_kernel=False)],
                         ids=["nee", "no_nee"])
def test_next_hit_on_card_equals_eager_at_every_depth(monkeypatch, over):
    """Each closest-hit ``next_hit`` of a launch (depth 0's primaries and
    depths 1-3's bounces), with kernel H and on the eager route, gives the
    same Hit and NEE verdicts, and B1 the same inputs, bit for bit."""
    _need_card()
    cfg = tiny_config(samples_per_launch=4, **over)
    calls = _captured_calls(cfg, 7)
    assert len(calls) == cfg.max_ray_depth
    for depth, (c, scene, params, pos, d, mask, kw) in enumerate(calls):
        assert kw.get("coherent") is (depth == 0)
        with_nee = kw.get("nee_u") is not None
        assert with_nee is cfg.nee_in_kernel
        _same(pathtracer.hit_prepare_eager(c, params, pos, d, mask,
                                           with_nee),
              hit_kernel.hit_prepare(c, params, pos, d, mask, with_nee))
        got = pathtracer.next_hit(c, scene, params, pos, d, mask, **kw)
        with monkeypatch.context() as mp:
            mp.setattr(hit_kernel, "hit_kernel_applies", lambda a, b: False)
            want = pathtracer.next_hit(c, scene, params, pos, d, mask, **kw)
        _same(want, got)


@pytest.mark.cuda
@pytest.mark.parametrize("over,k", ROUTES, ids=ROUTE_IDS)
def test_trace_sample_on_card_takes_the_kernel(monkeypatch, over, k):
    """A launch on the card launches each stage of kernel H once a depth
    and gives the outputs, bit for bit, of the same launch with the glue
    run eagerly."""
    _need_card()
    from voxelrt_torch.ops import _cuda

    cfg = tiny_config(samples_per_launch=k, **over)
    args = _launch(cfg, "cuda", 8)
    before = dict(_cuda.LAUNCHES)
    got = pathtracer.trace_sample(*args)
    for stage in ("hit_prepare", "hit_merge"):
        assert _cuda.LAUNCHES[stage] == before[stage] + cfg.max_ray_depth
    monkeypatch.setattr(hit_kernel, "hit_kernel_applies", lambda c, d: False)
    want = pathtracer.trace_sample(*args)
    assert _cuda.LAUNCHES["hit_merge"] == before["hit_merge"] + \
        cfg.max_ray_depth
    _same(want, got)
