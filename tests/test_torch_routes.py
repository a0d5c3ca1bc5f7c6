"""PyTorch port, the two routes of ``trace_sample`` that change how work is
dispatched and drawn, not what it computes: the sorted traversal route
(``sort_rays``) and the threefry draw table (``rng_draws='table'``).

Bars. The sorted route against B1 in ray order inside the port: every
per-ray output bitwise equal (distance, cell, normal, colour word, advance
count; shadow mode's distance), since the sort only permutes the rays and
the order among equal keys is not part of the result. The draw table
against the JAX package's ``jax.vmap(jax.random.uniform)`` table: bitwise
equal. ``trace_sample`` with either route against the JAX package: the bar
of tests/test_torch_modes.py (99% of pixels within 1e-4 relative, an RMSE
of 1e-4 of the largest value).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelrt.render import pipeline as jpl

from voxelrt_torch.config import RenderConfig as TCfg
from voxelrt_torch.ops import dda_kernel as dk
from voxelrt_torch.ops import prng
from voxelrt_torch.render import pathtracer as tpt
from voxelrt_torch.render import pipeline as tpl

from test_torch_dda import RES, _rays, _tv3, _world
from test_torch_modes import _held, _trace_both
from test_torch_render import build_both

# One thread per test process: the suite runs several processes side by
# side, and the tensors here are small.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def both():
    return build_both()


def _outputs(tr):
    out = [tr.distance]
    if tr.ipos is not None:
        out += [*tr.ipos, *tr.normal, tr.iters, tr.color_word, tr.active]
    return out


@pytest.mark.parametrize("shadow,sun_open", [(False, False), (True, False),
                                             (True, True)])
def test_sorted_route_equals_ray_order(shadow, sun_open):
    _, tt = _world(0.08, 3)
    rng, o, d = _rays(13, 4096)
    mask = torch.from_numpy(rng.random(o.shape[0]) < 0.7)
    cfg = TCfg(grid_res=RES)
    ov, dv = _tv3(o), _tv3(d)
    s = tpt._trace_voxels_sorted(cfg, tt, ov, dv, mask, shadow, sun_open)
    u = dk.raytrace(tt, ov, dv, tpt.EPS, torch.where(mask, tpt.INF, 0.0),
                    cfg.max_dda_advances, alive=mask, any_hit=shadow,
                    fetch_colors=not shadow, use_sun_open=sun_open)
    for a, b in zip(_outputs(s), _outputs(u)):
        assert torch.equal(a, b)
    assert torch.isfinite(u.distance).sum() > 100
    # the routing key sorts dead rays last and groups rays by cell
    key = tpt.routing_key(cfg, ov, dv, mask)
    assert (key[~mask] == tpt.SORT_DEAD).all()
    assert (key[mask] < tpt.SORT_DEAD).all()
    assert torch.unique(key[mask]).numel() > 50


def test_routing_key_morton():
    """The key's cell part is the JAX package's _morton3 of the origin's
    4^3 cell, shifted left 3, with the direction octant in the low bits."""
    from voxelrt.ops.dda_pallas import _morton3

    cfg = TCfg(grid_res=128)
    rng = np.random.default_rng(5)
    o = rng.uniform(-8, 136, (2048, 3)).astype(np.float32)
    d = rng.normal(size=(2048, 3)).astype(np.float32)
    key = tpt.routing_key(cfg, _tv3(o), _tv3(d), torch.ones(2048, dtype=bool))
    c = np.clip(o.astype(np.int32) >> 2, 0, 31)
    want = (np.asarray(_morton3(*(jnp.asarray(c[:, i]) for i in range(3))))
            << 3) | ((d[:, 0] > 0) + 2 * (d[:, 1] > 0) + 4 * (d[:, 2] > 0))
    np.testing.assert_array_equal(key.numpy(), want)


def test_sorted_trace_sample_matches_jax(both):
    jo, to = _trace_both(both, sort_rays=True)
    _held(jo, to)
    np.testing.assert_array_equal(
        to["gbuff_mat_id"].numpy(),
        np.asarray(jo["gbuff_mat_id"]).astype(np.int64))


def test_sorted_route_changes_no_output_in_port(both, monkeypatch):
    """sort_rays=True sends every dispatch but the primaries' through the
    sorted route, without in-kernel NEE, and renders what the explicit
    shadow dispatch renders in ray order."""
    tcfg = both[3]
    sorted_calls = []
    orig = tpt._trace_voxels_sorted

    def spy(*a, **k):
        sorted_calls.append(a[5])
        return orig(*a, **k)

    monkeypatch.setattr(tpt, "_trace_voxels_sorted", spy)
    from test_torch_modes import _trace_port

    a = _trace_port(both, dataclasses.replace(tcfg, sort_rays=True))
    depth = tcfg.max_ray_depth
    # depths 1-3 closest hit, and one sun-shadow dispatch a depth
    assert sorted(sorted_calls) == [False] * (depth - 1) + [True] * depth
    monkeypatch.setattr(tpt, "_trace_voxels_sorted", orig)
    b = _trace_port(both, dataclasses.replace(tcfg, nee_in_kernel=False))
    for name in ("diffuse", "specular"):
        for x, y in zip(a[name], b[name]):
            assert torch.equal(x, y), name


def test_draw_table_matches_jax(both):
    cfg, tcfg = both[0], both[3]
    n_draws = 8 * cfg.max_ray_depth + 1
    u, v = jpl._pixel_grid(*cfg.image_res)
    pid = u.astype(jnp.int32) * cfg.image_res[1] + v.astype(jnp.int32)
    key = jax.random.fold_in(jax.random.PRNGKey(3), 9)
    keys_px = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(key, pid)
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (n_draws,)),
                               out_axes=1)(keys_px))
    tpid = torch.from_numpy(np.asarray(pid).astype(np.int64))
    got = tpt.draw_table(tcfg, prng.fold_in(prng.fold_in(prng.key(3), 9),
                                            tpid))
    assert got.shape == want.shape == (n_draws, u.shape[0])
    np.testing.assert_array_equal(got.numpy(), want)


def test_table_draws_trace_sample_matches_jax(both):
    jo, to = _trace_both(both, rng_draws="table")
    _held(jo, to)
    # another draw stream than PCG3D's: another image
    tc = dataclasses.replace(both[3], samples_per_launch=1)
    tu, tv, _ = tpl.wavefront_constants(tc, 1.0, "cpu")
    skeys, jit = tpl.sample_keys_of(prng.key(3), 1)
    pcg = tpt.trace_sample(both[3], both[4], both[5], tu, tv, skeys[0],
                           (jit[0][0], jit[0][1]))
    assert not torch.equal(pcg["diffuse"].x, to["diffuse"].x)
