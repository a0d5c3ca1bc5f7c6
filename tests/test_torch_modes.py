"""PyTorch port, the off-default modes of the render path against the JAX
package: B1's shadow mode, the explicit sun-shadow dispatch
(``nee_in_kernel=False``), the jittered 4-corner sky fetch
(``sky_fetch='bilinear'``) and the per-direction NEE transmittance
(``nee_transmittance='per_ray'``), and that ReSTIR-PT, ``sort_rays`` and
``rng_draws='table'`` render through ``Scene.finish``.

Bars. The shadow twin against ``raytrace_pallas(any_hit=True,
fetch_colors=False, interpret=True)``: the hit/miss verdict may differ on at
most 1% of rays (tests/test_dda_pallas.py:52-66; verdicts flip where a
float32 ulp moves a ray across a voxel face). ``trace_sample`` per pixel: 99%
of pixels within 1e-4 relative and an RMSE of 1e-4 of the largest value, the
bars of tests/test_torch_render.py, for the same reasons (XLA's CPU
transcendentals and fusion against torch's, a rare flipped discrete choice).
Inside the port, in-kernel NEE against the explicit dispatch: the two shadow
rays start from the same surface point computed in grid units and in world
units, so a verdict may flip at a grazing ray; 99% of pixels within 1e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelrt.ops.dda_pallas import raytrace_pallas
from voxelrt.render import pathtracer as jpt
from voxelrt.render import pipeline as jpl

from voxelrt_torch.ops import dda_kernel as dk
from voxelrt_torch.ops import prng
from voxelrt_torch.ops.v3 import V3
from voxelrt_torch.render import pathtracer as tpt
from voxelrt_torch.render import pipeline as tpl

from test_torch_dda import RES, _rays, _tv3, _world
from test_torch_render import _pack, build_both

# One thread per test process: the suite runs several processes side by
# side, and the tensors here are small.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def both():
    return build_both()


@pytest.mark.parametrize("fill,seed,sun_open", [(0.03, 0, False),
                                                (0.15, 1, False),
                                                (0.10, 7, True)])
def test_b1_shadow_twin_matches_pallas(fill, seed, sun_open):
    """Hit/miss only: in shadow mode the distance says whether something
    blocks the ray; cell, normal and colour are not meaningful."""
    jt, tt = _world(fill, seed)
    rng, o, d = _rays(seed + 20, 1024)
    n = o.shape[0]
    alive = rng.random(n) < 0.8
    tmax = np.where(alive, np.inf, 0.0).astype(np.float32)
    j = raytrace_pallas(jt, jnp.asarray(o), jnp.asarray(d), 1e-6,
                        jnp.asarray(tmax), RES, fetch_colors=False,
                        any_hit=True, use_sun_open=sun_open, interpret=True)
    t = dk.raytrace(tt, _tv3(o), _tv3(d), 1e-6, torch.from_numpy(tmax),
                    alive=torch.from_numpy(alive), any_hit=True,
                    fetch_colors=False, use_sun_open=sun_open)
    assert t.ipos is None and t.normal is None and t.color_word is None
    jh, th = np.isfinite(np.asarray(j.distance)), np.isfinite(
        t.distance.numpy())
    assert (jh != th).sum() <= n * 0.01, (jh != th).sum()
    assert jh.sum() > 30 and not th[~alive].any()
    # the verdicts are those of the closest-hit mode
    c = dk.raytrace(tt, _tv3(o), _tv3(d), 1e-6, torch.from_numpy(tmax),
                    alive=torch.from_numpy(alive))
    assert torch.equal(c.distance, t.distance)


def test_b1_modes_are_checked():
    _, tt = _world(0.03, 0)
    _, o, d = _rays(1, 8)
    with pytest.raises(ValueError):
        dk.raytrace(tt, _tv3(o), _tv3(d), 1e-6, float("inf"), any_hit=True)
    with pytest.raises(ValueError):
        dk.raytrace(tt, _tv3(o), _tv3(d), 1e-6, float("inf"),
                    fetch_colors=False)


def _trace_both(both, **over):
    cfg, sd, p, tcfg, tsd, tp = both
    jc = dataclasses.replace(cfg, **over)
    tc = dataclasses.replace(tcfg, **over)
    u, v = jpl._pixel_grid(*cfg.image_res)
    jo = jax.jit(jpt.trace_sample, static_argnums=(0, 6, 7))(
        jc, sd, p, jax.random.PRNGKey(3), u, v, False, 1.0)
    return jo, _trace_port(both, tc)


def _trace_port(both, tc):
    tsd, tp = both[4], both[5]
    tu, tv, _ = tpl.wavefront_constants(
        dataclasses.replace(tc, samples_per_launch=1), 1.0, "cpu")
    skeys, jit = tpl.sample_keys_of(prng.key(3), 1)
    return tpt.trace_sample(tc, tsd, tp, tu, tv, skeys[0],
                            (jit[0][0], jit[0][1]))


def _held(jo, to):
    for name in ("diffuse", "specular"):
        a = _pack(jo[name]) if not isinstance(jo[name], V3) else \
            torch.stack(list(jo[name]), -1).numpy()
        b = torch.stack(list(to[name]), -1).numpy()
        ok = np.isclose(b, a, rtol=1e-4, atol=1e-6).all(-1)
        assert ok.mean() >= 0.99, (name, ok.mean())
        assert np.sqrt(np.mean((a - b) ** 2)) < 1e-4 * max(1.0,
                                                            np.abs(a).max())
        assert np.abs(a).max() > 0.1


@pytest.mark.parametrize("over", [
    dict(nee_in_kernel=False),
    dict(sky_fetch="bilinear"),
    dict(nee_transmittance="per_ray"),
], ids=["explicit_nee", "bilinear_sky", "per_ray_trans"])
def test_trace_sample_modes_match_jax(both, over):
    jo, to = _trace_both(both, **over)
    _held(jo, to)
    np.testing.assert_array_equal(
        to["gbuff_mat_id"].numpy(),
        np.asarray(jo["gbuff_mat_id"]).astype(np.int64))


def test_in_kernel_nee_matches_explicit_dispatch_in_port(both):
    tcfg = both[3]
    a = _trace_port(both, tcfg)
    b = _trace_port(both, dataclasses.replace(tcfg, nee_in_kernel=False))
    _held(a, b)


def test_per_ray_transmittance_goes_through_b3(both, monkeypatch):
    """'per_ray' fetches the transmittance per light direction at every
    depth: B3's direction entries are called with a full wavefront of
    lanes, and its texel-coordinate entry not at all."""
    from voxelrt_torch.ops import texfetch
    from voxelrt_torch.sky import atmos

    lanes = []

    def spy_on(name, d_at):
        orig = getattr(atmos, name)

        def spy(*args, **kw):
            lanes.append(args[d_at].x.shape[0])
            return orig(*args, **kw)

        monkeypatch.setattr(atmos, name, spy)

    spy_on("bilinear_fetch_dirs", 1)
    spy_on("bilinear_fetch_dirs2", 3)
    monkeypatch.setattr(texfetch, "bilinear_fetch_packed", None)
    tcfg = both[3]
    n = tcfg.image_res[0] * tcfg.image_res[1]
    _trace_port(both, tcfg)
    assert lanes and max(lanes) == 1
    lanes.clear()
    _trace_port(both, dataclasses.replace(tcfg, nee_transmittance="per_ray"))
    assert lanes.count(n) == tcfg.max_ray_depth and 1 not in lanes
    lanes.clear()
    _trace_port(both, dataclasses.replace(tcfg, sky_fetch="bilinear"))
    assert lanes.count(n) == 1 and lanes.count(1) == tcfg.max_ray_depth + 1


@pytest.mark.parametrize("over", [dict(use_restir_pt=True),
                                  dict(sort_rays=True),
                                  dict(rng_draws="table")],
                         ids=["restir", "sort_rays", "table_draws"])
def test_off_default_modes_render_through_scene(over):
    """ReSTIR-PT, the sorted route and the table draws render through the
    public entry point on the CPU: a finite, non-constant image."""
    from voxelrt_torch.app.examples import build_example

    scene = build_example("example2", "cpu", (64, 36), **over)
    img = scene.finish(spp=2, save=False)
    assert img.shape == (64, 36, 3) and np.isfinite(img).all()
    assert img.std() > 1e-3
    cfg = scene.renderer.cfg
    assert all(getattr(cfg, k) == v for k, v in over.items())


@pytest.mark.cuda
@pytest.mark.parametrize("use_sun_open", [False, True])
@pytest.mark.parametrize("share", [0.07, 0.6, 1.0])
def test_b1_shadow_kernel_matches_twin_on_card(share, use_sun_open):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: B1 is a CUDA kernel")
    dev = torch.device("cuda")
    _, tt = _world(0.10, 11)
    tt = dk.DeviceTables(*(x.to(dev) for x in tt[:-1]), tt.grid_res)
    rng, o, d = _rays(5, 50_000)
    ov, dv = (V3(*(c.to(dev) for c in _tv3(a))) for a in (o, d))
    alive = torch.from_numpy(rng.random(o.shape[0]) < share).to(dev)
    kw = dict(alive=alive, any_hit=True, fetch_colors=False,
              use_sun_open=use_sun_open)
    a = dk.raytrace(tt, ov, dv, 1e-6, float("inf"), **kw)
    b = dk.raytrace_plain(tt, ov, dv, 1e-6, float("inf"), **kw)
    assert torch.equal(a.distance, b.distance)
    assert torch.equal(a.counts, b.counts)
