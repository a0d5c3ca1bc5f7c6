"""PyTorch port: multi-device rendering (``voxelrt_torch.parallel.sharding``)
on a grid of CPU devices (a device may appear more than once in the grid).

* ``parallel_render`` on 8 row shards equals the one-device render bit for
  bit; on one device it matches the JAX package's ``parallel_render`` on a
  one-device mesh, and on a (2, 2) grid JAX's (2, 2) mesh of the host
  devices tests/conftest.py forces (the same keys): within 1e-4.
* ``sharded_accumulate_n`` on 4 shards equals ``pipeline.accumulate_n`` bit
  for bit once its partitioned state is gathered: still frames, still with
  ReSTIR, a moving frame, the sorted route and the table draws (the table
  is drawn per ray from its pixel's key, so it does not depend on where a
  lane lands). A still frame's wavefronts go through the sharded trace in
  four equal chunks, one a block; a moving frame, which runs unsharded,
  never reaches it and returns one RenderState.

The tiny config: the JAX package takes its own route on the CPU, the
portable traversal (``use_pallas_dda=False``), the port its B1 twin."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from voxelrt.app import testing as jtesting
from voxelrt.parallel import sharding as jsh

from voxelrt_torch.app import testing
from voxelrt_torch.ops import prng
from voxelrt_torch.parallel import sharding
from voxelrt_torch.render import pipeline as tpl

torch.set_num_threads(1)

KW = dict(image_res=(64, 32))


@pytest.fixture(scope="module")
def port():
    cfg = testing.tiny_config(**KW)
    return cfg, testing.make_scene_data(cfg, "cpu"), testing.make_params(
        cfg, "cpu")


@pytest.fixture(scope="module")
def one_device(port):
    cfg, sd, p = port
    mesh = sharding.make_mesh(["cpu"], dp=1)
    return sharding.parallel_render(cfg, sd, p, prng.key(7), 4, mesh)


def test_make_mesh():
    m = sharding.make_mesh(["cpu"] * 4, sp=2)
    assert m.shape == {"dp": 2, "sp": 2} and len(m.flat) == 4
    assert m.distinct() == [torch.device("cpu")]
    with pytest.raises(ValueError):
        sharding.make_mesh(["cpu"] * 3, dp=2)


def test_parallel_render_rows_bitwise(port, one_device):
    cfg, sd, p = port
    img = sharding.parallel_render(cfg, sd, p, prng.key(7), 4,
                                   sharding.make_mesh(["cpu"] * 8, dp=8))
    assert img.shape == (64, 32, 3) and torch.isfinite(img).all()
    assert torch.equal(img, one_device)


@pytest.mark.parametrize("dp,sp", [(1, 1), (2, 2)])
def test_parallel_render_matches_jax(port, one_device, dp, sp):
    cfg, sd, p = port
    jcfg = jtesting.tiny_config(**KW)
    devs = jax.devices("cpu")[:dp * sp]
    if len(devs) < dp * sp:
        pytest.skip("needs 4 host devices (tests/conftest.py sets the flag)")
    want = np.asarray(jsh.parallel_render(
        jcfg, jtesting.make_scene_data(jcfg), jtesting.make_params(jcfg),
        jax.random.PRNGKey(7), 4, jsh.make_mesh(devs, dp=dp, sp=sp)))
    got = one_device if dp * sp == 1 else sharding.parallel_render(
        cfg, sd, p, prng.key(7), 4,
        sharding.make_mesh(["cpu"] * (dp * sp), dp=dp, sp=sp))
    assert got.std() > 0.01
    ok = np.isclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert ok.all(), ok.mean()


@pytest.mark.parametrize("over,moving", [
    ({}, False),
    (dict(use_restir_pt=True, restir_taps=2, restir_radius=4.0), False),
    ({}, True),
    (dict(sort_rays=True), False),
    (dict(rng_draws="table"), False),
], ids=["still", "restir", "moving", "sort_rays", "table"])
def test_sharded_accumulate_n_bitwise(port, over, moving, monkeypatch):
    cfg, sd, p = port
    cfg = dataclasses.replace(cfg, **over)
    scale = 0.5 if moving else 1.0
    mesh = sharding.make_mesh(["cpu"] * 4, dp=4)
    a = tpl.accumulate_n(cfg, sd, p, tpl.init_state(cfg, "cpu"), prng.key(5),
                         moving, scale, 2)
    # the lanes each shard traces: a still frame splits every wavefront
    # into 4 equal chunks, a moving frame never reaches the sharded trace
    shard_lanes = []
    real = sharding.trace_sample

    def spy(cfg, scene, params, u, *rest):
        shard_lanes.append(u.shape[0])
        return real(cfg, scene, params, u, *rest)

    monkeypatch.setattr(sharding, "trace_sample", spy)
    b = sharding.sharded_accumulate_n(cfg, sd, p, tpl.init_state(cfg, "cpu"),
                                      prng.key(5), moving, scale, 2, mesh)
    if moving:
        assert shard_lanes == [] and isinstance(b, tpl.RenderState)
    else:
        assert shard_lanes and len(shard_lanes) % 4 == 0
        assert len(set(shard_lanes)) == 1
        assert isinstance(b, tuple) and len(b) == 4
        b = sharding.gather_state(b)
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "reservoirs":
            assert (x is None) == (y is None) == (not over.get(
                "use_restir_pt"))
            for sx, sy in zip(x or (), y or ()):
                assert all(torch.equal(sx[k], sy[k]) for k in sx)
        elif isinstance(x, torch.Tensor):
            assert torch.equal(x, y), f.name
        else:
            assert x == y, f.name
    assert a.color.std() > 0


def test_shard_state_splits_rows(port):
    cfg = dataclasses.replace(port[0], use_restir_pt=True)
    st = tpl.init_state(cfg, "cpu")
    st = dataclasses.replace(st, color=torch.rand(st.color.shape), spp=3)
    parts = sharding.shard_state(st, sharding.make_mesh(["cpu"] * 4, dp=4))
    assert len(parts) == 4 and all(s.color.shape == (16, 32, 3) and s.spp == 3
                                   for s in parts)
    assert torch.equal(torch.cat([s.color for s in parts]), st.color)
    assert parts[1].reservoirs[0]["M"].shape == (16, 32)
    back = sharding.gather_state(parts)
    assert torch.equal(back.color, st.color) and back.spp == 3
    assert all(torch.equal(back.reservoirs[i][k], st.reservoirs[i][k])
               for i in (0, 1) for k in st.reservoirs[i])
