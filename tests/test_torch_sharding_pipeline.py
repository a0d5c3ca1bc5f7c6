"""PyTorch port: a still frame partitioned over 'dp'
(``voxelrt_torch.parallel.sharding.sharded_accumulate_n``) on grids of CPU
devices.

* The partitioned state keeps block i, W/dp rows, on ``devices[i][0]``, and
  every field of the gathered state (colours, histories, G-buffer, ReSTIR's
  reservoirs, ``spp``, ``frame``) is ``torch.equal`` to
  ``pipeline.accumulate_n`` on one device: for dp 2 and 4, still frames,
  ReSTIR with a radius (20) wider than a dp=4 block (16 rows), so the GRIS
  taps read halo rows from several blocks, the sorted route, the table
  draws, a half-scale still frame (a dp=4 block then lies wholly outside
  the active region), and a still→moving→still sequence.
* A block's wavefront is one contiguous range of each sample's pixel ids,
  with the image's pixel coordinates; a block that does not fall on the
  tile columns raises.
* ``prng.uniform`` with a counter offset is the slice of the whole draw,
  and of ``jax.random.uniform``'s.
* A partitioned render checkpointed at 2 of 4 launches and resumed,
  partitioned again, equals the uninterrupted one.
* Against the JAX package's ``sharded_accumulate_n`` on a dp=2 mesh of the
  host devices tests/conftest.py forces: elementwise within rtol = atol =
  1e-4 (``tests/test_torch_sharding.py::test_parallel_render_matches_jax``'s
  bar); all pixels for still frames; for ReSTIR at least 99% of pixels and
  reservoir lanes, the share ``tests/test_torch_restir.py`` holds ReSTIR to
  (the port's partitioned frame equals its one-device frame bit for bit,
  so any gap is the one-device gap between the packages). The JAX side
  takes its own CPU route, the portable traversal."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from voxelrt.app import testing as jtesting
from voxelrt.parallel import sharding as jsh
from voxelrt.render import pipeline as jpl

from voxelrt_torch.app import testing
from voxelrt_torch.ops import prng
from voxelrt_torch.parallel import sharding
from voxelrt_torch.render import pipeline as tpl
from voxelrt_torch.utils import checkpoint

torch.set_num_threads(1)

KW = dict(image_res=(64, 32))
RESTIR = dict(use_restir_pt=True, restir_taps=4, restir_radius=20.0)
MODES = {"still": {}, "restir": RESTIR, "sort_rays": dict(sort_rays=True),
         "table": dict(rng_draws="table")}
_ONE = {}


@pytest.fixture(scope="module")
def port():
    cfg = testing.tiny_config(**KW)
    return cfg, testing.make_scene_data(cfg, "cpu"), testing.make_params(
        cfg, "cpu")


def one_device(port, mode, scale=1.0):
    """``pipeline.accumulate_n`` of 2 samples on one device, once a mode."""
    if (mode, scale) not in _ONE:
        cfg, sd, p = port
        cfg = dataclasses.replace(cfg, **MODES[mode])
        _ONE[mode, scale] = tpl.accumulate_n(
            cfg, sd, p, tpl.init_state(cfg, "cpu"), prng.key(5), False, scale,
            2)
    return _ONE[mode, scale]


def assert_state_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "reservoirs":
            assert (x is None) == (y is None)
            for sx, sy in zip(x or (), y or ()):
                assert sx.keys() == sy.keys()
                for k in sx:
                    assert torch.equal(sx[k], sy[k]), (f.name, k)
        elif isinstance(x, torch.Tensor):
            assert torch.equal(x, y), f.name
        else:
            assert x == y, f.name


def assert_blocks(parts, mesh, rows):
    assert isinstance(parts, tuple) and len(parts) == mesh.shape["dp"]
    for i, block in enumerate(parts):
        dev = mesh.devices[i][0]
        tensors = [block.color, block.history, block.gbuff_mat_id]
        if block.reservoirs is not None:
            tensors += [x for slot in block.reservoirs for x in slot.values()]
        for x in tensors:
            assert x.device == dev and x.shape[0] == rows


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("mode", list(MODES))
def test_partitioned_still_bitwise(port, mode, dp):
    cfg, sd, p = port
    cfg = dataclasses.replace(cfg, **MODES[mode])
    mesh = sharding.make_mesh(["cpu"] * dp, dp=dp)
    parts = sharding.sharded_accumulate_n(
        cfg, sd, p, tpl.init_state(cfg, "cpu"), prng.key(5), False, 1.0, 2,
        mesh)
    assert_blocks(parts, mesh, 64 // dp)
    want = one_device(port, mode)
    assert want.color.std() > 0.01
    assert_state_equal(want, sharding.gather_state(parts))


@pytest.mark.parametrize("dp", [2, 4])
def test_partitioned_half_scale_still(port, dp):
    """Render scale 0.5: only the top-left 32×16 pixels are traced and
    filtered; at dp=4 blocks 2 and 3 hold no active row."""
    cfg, sd, p = port
    parts = sharding.sharded_accumulate_n(
        cfg, sd, p, tpl.init_state(cfg, "cpu"), prng.key(5), False, 0.5, 2,
        sharding.make_mesh(["cpu"] * dp, dp=dp))
    assert_state_equal(one_device(port, "still", 0.5),
                       sharding.gather_state(parts))


def test_still_moving_still(port):
    """Still frames, then (after a reset) two moving frames at half scale,
    then (after a reset) still frames again, as the app shell's motion
    policy runs them: the moving frames run on the scene's device and the
    state is split again for the last still frames."""
    cfg, sd, p = port
    mesh = sharding.make_mesh(["cpu"] * 2, dp=2)
    steps = [(False, 1.0, 2), (True, 0.5, 1), (True, 0.5, 1), (False, 1.0, 2)]

    def run(step):
        st = tpl.init_state(cfg, "cpu")
        kinds = []
        for i, (moving, scale, n) in enumerate(steps):
            if i in (1, 3):
                st = tpl.reset_framebuffer(st)
            st = step(st, prng.key(20 + i), moving, scale, n)
            kinds.append(isinstance(st, tuple))
        return st, kinds

    a, _ = run(lambda st, k, m, s, n: tpl.accumulate_n(
        cfg, sd, p, st, k, m, s, n))
    b, kinds = run(lambda st, k, m, s, n: sharding.sharded_accumulate_n(
        cfg, sd, p, st, k, m, s, n, mesh))
    assert kinds == [True, False, False, True]
    assert_blocks(b, mesh, 32)
    assert_state_equal(a, sharding.gather_state(b))
    # the tonemapped image reads global coordinates (the vignette)
    assert torch.equal(tpl.fetch_image(cfg, b, 10.0),
                       tpl.fetch_image(cfg, a, 10.0))


def test_block_wavefront_is_a_contiguous_range():
    cfg = testing.tiny_config(image_res=(64, 32), samples_per_launch=2)
    u, v, s = tpl.wavefront_constants(cfg, 1.0, "cpu")
    n = 64 * 32
    for lo, hi in ((0, 16), (16, 48), (48, 64)):
        bu, bv, bs = tpl.wavefront_constants(cfg, 1.0, "cpu", rows=(lo, hi))
        m = (hi - lo) * 32
        for k in range(2):
            sl = slice(k * n + lo * 32, k * n + hi * 32)
            assert torch.equal(bu[k * m:(k + 1) * m], u[sl])
            assert torch.equal(bv[k * m:(k + 1) * m], v[sl])
            assert (bs[k * m:(k + 1) * m] == k).all()
        assert int(bu.min()) == lo and int(bu.max()) == hi - 1
        # the block's order is its own tile order: every pixel once
        pix = (bu[:m] - lo).long() * 32 + bv[:m].long()
        assert torch.equal(pix.sort().values, torch.arange(m))
    with pytest.raises(ValueError):
        tpl.wavefront_constants(cfg, 1.0, "cpu", rows=(8, 24))


@pytest.mark.parametrize("lo,n", [(0, 100), (37, 1000), (4090, 6)])
def test_uniform_offset_is_the_slice(lo, n):
    k = prng.fold_in(prng.key(3), 17)
    full = prng.uniform(k, (lo + n,), "cpu")
    part = prng.uniform(k, (n,), "cpu", offset=lo)
    assert torch.equal(part, full[lo:])
    jk = jax.random.fold_in(jax.random.PRNGKey(3), 17)
    want = np.asarray(jax.random.uniform(jk, (lo + n,)))[lo:]
    assert np.array_equal(part.numpy(), want)


def test_partitioned_checkpoint_resume(port, tmp_path):
    """4 launches of 2 samples on dp=2: 2 launches, a checkpoint of the
    partitioned state, then 2 more from the loaded state, against the same
    render uninterrupted."""
    cfg, sd, p = port
    cfg = dataclasses.replace(cfg, samples_per_launch=2)
    mesh = sharding.make_mesh(["cpu"] * 2, dp=2)

    def launches(st, key):
        return sharding.sharded_accumulate_n(cfg, sd, p, st, key, False, 1.0,
                                             4, mesh)

    ka, kb = prng.key(31), prng.key(32)
    half = launches(tpl.init_state(cfg, "cpu"), ka)
    whole = launches(half, kb)
    path = str(tmp_path / "ck.npz")
    checkpoint.save_render_state(path, half, kb, 2)
    st, key, frame, _ = checkpoint.load_render_state(
        path, tpl.init_state(cfg, "cpu"))
    assert key == kb and frame == 2 and st.spp == 4
    resumed = launches(st, key)
    assert_blocks(resumed, mesh, 32)
    assert resumed[0].spp == 8
    assert_state_equal(sharding.gather_state(whole),
                       sharding.gather_state(resumed))


@pytest.mark.parametrize("mode", ["still", "restir"])
def test_partitioned_matches_jax(port, mode):
    cfg, sd, p = port
    devs = jax.devices("cpu")[:2]
    if len(devs) < 2:
        pytest.skip("needs 2 host devices (tests/conftest.py sets the flag)")
    jcfg = jtesting.tiny_config(**KW, **MODES[mode])
    js = jsh.sharded_accumulate_n(
        jcfg, jtesting.make_scene_data(jcfg), jtesting.make_params(jcfg),
        jpl.init_state(jcfg), jax.random.PRNGKey(5), False, 1.0, 2,
        jsh.make_mesh(devs, dp=2))
    cfg = dataclasses.replace(cfg, **MODES[mode])
    got = sharding.gather_state(sharding.sharded_accumulate_n(
        cfg, sd, p, tpl.init_state(cfg, "cpu"), prng.key(5), False, 1.0, 2,
        sharding.make_mesh(["cpu"] * 2, dp=2)))
    need = 1.0 if mode == "still" else 0.99
    pairs = [(f, np.asarray(getattr(js, f)), getattr(got, f).numpy())
             for f in ("color", "color_spec", "history", "history_spec")]
    if mode == "restir":
        pairs += [(f"reservoirs.{i}.{k}", np.asarray(js.reservoirs[i][k]),
                   got.reservoirs[i][k].numpy())
                  for i in (0, 1) for k in js.reservoirs[i]]
    assert got.color.std() > 0.01
    for name, want, have in pairs:
        assert have.shape == want.shape, name
        ok = np.isclose(have, want.astype(have.dtype), rtol=1e-4, atol=1e-4)
        ok = ok.reshape(ok.shape[0] * ok.shape[1], -1).all(-1)
        print(f"{mode} {name}: {ok.mean():.5f} of {ok.size} pixels within "
              "1e-4")
        assert ok.mean() >= need, (name, ok.mean())
