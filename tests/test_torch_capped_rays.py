"""PyTorch port, kernel B1 on the ReSTIR revalidation rays that ran to its
advance cap on the card.

``tests/golden/torch_fullres/example6_restir_capped_rays.npz`` holds every
ray of example6's GRIS revalidation dispatch (1280×720, ReSTIR-PT at the
JAX defaults, the last of 8 launches: shadow mode without the sun-open
early-out, one ray a pixel towards the chosen sample) whose advances
reached B1's cap of 512 on an H100, kept by ``chip_smoke.py`` phase 18
with B1 as it was before the repair below: grid-space origin, direction,
``tmin``, ``tmax`` and the ``alive`` byte as the dispatch was given them
(float32 bits), the kernel's distance, the twin's final state, and whether
the sample is an escape (``rc_normal`` zero).

What they are: every one has a zero direction. The chosen sample of such a
pixel is empty (``rc_pos`` and ``rc_normal`` zero), so it counts as an
escape and its ray goes "towards" ``rc_pos`` = (0, 0, 0). A zero direction
makes every exit time BIG, so the ray's ``t`` jumps to BIG at its first
step and its far clip is BIG too: ``t > far`` never fires, and the ray
spun in its cell, 57 advances of 9 in-cell steps, until 513 >= 512 ended
it as exhausted with the distance of a miss. The image never saw it: an
escape sample's ``actual`` distance is inf, so ``occluded`` cannot fire
whatever the distance. The JAX kernel (``raytrace_pallas``) spins the same
way, to 513 advances; both portable traversals (``ops/dda.py`` of either
package) retire the ray at its first advance as a miss.

The repair (``csrc/dda.cu`` and ``ops/dda_kernel.py`` together): a ray
whose ``t`` reached BIG is a miss. No other ray's ``t`` can reach BIG, so
every other output is unchanged. These tests hold the repaired twin to the
portable oracle on the captured rays: no ray reaches the cap, and the
hits and distances agree; and the same on zero-direction rays from every
kind of voxel of example6's world, where a ray that starts in an occupied
voxel hits it at ``tmin``."""

import os

import numpy as np
import pytest
import torch

import test_torch_golden as tg

import chip_smoke
from voxelrt_torch.app.examples import build_example
from voxelrt_torch.ops import accel as taccel
from voxelrt_torch.ops import dda as tdda
from voxelrt_torch.ops import dda_kernel as dk
from voxelrt_torch.ops.v3 import V3

torch.set_num_threads(1)

CAPPED = os.path.join(tg.GOLDEN_DIR, "torch_fullres", chip_smoke.CAPPED_RAYS)
CAP = 512
JAX_RAYS = 128  # of the captured rays through the interpret-mode JAX kernel


@pytest.fixture(scope="module")
def world():
    """example6's 128³ world (the same at any image size) as each
    traversal takes it: the port's B1 tables and occupancy pyramid, and
    the JAX package's, built by the JAX package from its own example6."""
    import jax.numpy as jnp

    from voxelrt.ops import dda as jdda
    from voxelrt.ops.accel import build_pallas_tables as j_tables

    w = build_example("example6", "cpu", (16, 9)).world
    arrays = w.device_arrays()
    res = w.grid_res
    with tg.example_jax("example6") as jscene:
        jw = jscene.world
        jarrays = jw.device_arrays()
    np.testing.assert_array_equal(jw.material, w.material)
    np.testing.assert_array_equal(jarrays["voxels_np"], arrays["voxels"])
    return dict(
        res=res, material=w.material,
        tables=dk.upload_tables(taccel.build_pallas_tables(
            w.material, arrays["voxels"], res), "cpu"),
        pyramid=tdda.OccupancyPyramid(torch.from_numpy(
            arrays["occ_words"].view(np.int32)), res, w.n_lods),
        jtables=j_tables(jw.material, jarrays["voxels_np"], res),
        jpyramid=jdda.OccupancyPyramid(jnp.asarray(jarrays["occ_words"]),
                                       res, jw.n_lods))


@pytest.fixture(scope="module")
def rays():
    with np.load(CAPPED) as z:
        return {k: z[k] for k in z.files}


def _v3(a):
    return V3(*(torch.from_numpy(np.ascontiguousarray(a[:, i]))
                for i in range(3)))


def _twin(world, o, d, tmin, tmax, alive=None, shadow=True):
    """B1's twin in shadow or closest-hit mode, with each ray's advances."""
    with chip_smoke.AdvanceTally() as adv:
        out = dk.raytrace_plain(
            world["tables"], _v3(o), _v3(d), tmin, torch.from_numpy(tmax),
            CAP, alive=alive, any_hit=shadow, fetch_colors=not shadow)
    return out, adv.states[0]["adv"].numpy()


def _portable(world, o, d, tmin, tmax):
    return tdda.raytrace(world["pyramid"], torch.from_numpy(o),
                         torch.from_numpy(d), tmin, torch.from_numpy(tmax),
                         CAP)


def test_capped_rays_are_empty_escape_samples(rays):
    """What the card's capture holds: rays that ran to the cap (513 > 512
    advances) and came back as misses, each a live pixel's, each with a
    zero direction and an escape sample, whose ``occluded`` test (restir.py
    ``spatial_gris``) cannot fire whatever B1 returns."""
    n = rays["index"].size
    assert n > 0 and np.unique(rays["index"]).size == n
    assert (rays["twin_advances"] >= CAP).all()
    assert rays["twin_exhausted"].all() and not rays["twin_hit"].any()
    assert np.isinf(rays["kernel_distance"]).all()
    assert rays["alive"].all() and np.isinf(rays["tmax"]).all()
    assert (rays["direction"] == 0).all()
    assert rays["escape"].all()
    closest = torch.tensor([1.0, 50.0, float("inf")])
    actual = torch.full_like(closest, float("inf"))
    occluded = torch.isfinite(closest) & (
        torch.abs(closest - actual) > 0.1 * actual)
    assert not occluded.any()


@pytest.mark.parametrize("shadow", [True, False])
def test_repaired_twin_retires_them_as_the_portable_oracle(world, rays,
                                                           shadow):
    """The repaired twin, in the dispatch's shadow mode and in closest-hit
    mode, on every captured ray: none reaches the cap, every one is a miss
    as the portable traversal says, and the shadow distances are the ones
    the kernel returned before the repair."""
    o, d, tmax = rays["origin"], rays["direction"], rays["tmax"]
    tmin = float(rays["tmin"][0])
    assert (rays["tmin"] == np.float32(tmin)).all()
    alive = torch.from_numpy(rays["alive"] != 0)
    out, adv = _twin(world, o, d, tmin, tmax, alive, shadow)
    ref = _portable(world, o, d, tmin, tmax)
    print(f"{o.shape[0]} rays: the twin's most advances {adv.max()}, the "
          f"portable traversal's {int(ref.iters.max())}")
    assert adv.max() < CAP
    np.testing.assert_array_equal(out.distance.numpy(),
                                  ref.distance.numpy())
    if shadow:
        np.testing.assert_array_equal(out.distance.numpy(),
                                      rays["kernel_distance"])
    else:
        assert not out.active.any()
        assert (out.iters.numpy() == adv).all()


def test_jax_traversals_on_the_captured_rays(world, rays):
    """The JAX package on the same rays: its portable ``ops/dda.py``
    retires each at its first advance as a miss, as the port's does; its
    kernel ``raytrace_pallas`` (interpret mode, on the first ``JAX_RAYS``)
    spins each to the cap (513 advances, exhausted) and returns a miss.
    That kernel is not changed; the port's repaired rays are held to the
    portable oracle instead."""
    import jax.numpy as jnp

    from voxelrt.ops import dda as jdda
    from voxelrt.ops.dda_pallas import raytrace_pallas

    o, d, tmax = rays["origin"], rays["direction"], rays["tmax"]
    tmin = float(rays["tmin"][0])
    j = jdda.raytrace(world["jpyramid"], jnp.asarray(o), jnp.asarray(d),
                      tmin, jnp.asarray(tmax))
    p = _portable(world, o, d, tmin, tmax)
    np.testing.assert_array_equal(np.asarray(j.distance), p.distance.numpy())
    np.testing.assert_array_equal(np.asarray(j.iters), p.iters.numpy())
    assert np.isinf(p.distance.numpy()).all() and (p.iters.numpy() == 1).all()
    m = min(JAX_RAYS, o.shape[0])
    k = raytrace_pallas(world["jtables"], jnp.asarray(o[:m]),
                        jnp.asarray(d[:m]), tmin, jnp.asarray(tmax[:m]),
                        world["res"], interpret=True)
    print(f"the JAX kernel on {m} rays: advances "
          f"{np.unique(np.asarray(k.iters)).tolist()}")
    assert np.isinf(np.asarray(k.distance)).all()
    assert (np.asarray(k.iters) == rays["twin_advances"][:m]).all()
    assert (np.asarray(k.iters) > CAP).all() and np.asarray(k.active).all()


def test_zero_direction_rays_stop_where_they_start(world):
    """Zero-direction rays from the centre of voxels of example6's world,
    occupied and empty, in and out of occupied 4³ cells and outside the
    grid: the repaired twin (closest hit and shadow mode) agrees with the
    portable traversal on every hit, cell and distance (a ray that starts
    in an occupied voxel hits it at ``tmin``), and no ray takes more than
    the first cell's steps."""
    res = world["res"]
    occ = world["material"] != 0
    rng = np.random.default_rng(16)
    solid = np.argwhere(occ)
    cells = np.argwhere(occ.reshape(res // 4, 4, res // 4, 4, res // 4, 4)
                        .any((1, 3, 5)))
    in_cell = (cells[rng.integers(0, len(cells), 96)] * 4
               + rng.integers(0, 4, (96, 3)))
    pts = np.concatenate([
        solid[rng.integers(0, len(solid), 96)], in_cell,
        rng.integers(0, res, (96, 3)),
        np.array([[-3, 5, 5], [res + 2, 5, 5], [5, -1, res]])]) + 0.5
    o = pts.astype(np.float32)
    d = np.zeros_like(o)
    tmax = np.full(len(o), np.inf, np.float32)
    inside = ((pts >= 0) & (pts < res)).all(1)
    ix = np.clip(pts.astype(int), 0, res - 1)
    starts_solid = inside & occ[ix[:, 0], ix[:, 1], ix[:, 2]]
    assert starts_solid.sum() >= 96 and (~starts_solid & inside).sum() >= 96
    ref = _portable(world, o, d, 1e-6, tmax)
    hit = np.isfinite(ref.distance.numpy())
    np.testing.assert_array_equal(hit, starts_solid)
    for shadow in (True, False):
        out, adv = _twin(world, o, d, 1e-6, tmax, shadow=shadow)
        assert adv.max() <= 10
        np.testing.assert_array_equal(out.distance.numpy(),
                                      ref.distance.numpy())
        if not shadow:
            got = torch.stack(list(out.ipos), -1).numpy()
            np.testing.assert_array_equal(got[hit], ref.ipos.numpy()[hit])
