"""PyTorch port: the portable traversal ``voxelrt_torch.ops.dda`` (plain
PyTorch, B1's second oracle) against the JAX package's ``voxelrt.ops.dda``
on tests/test_dda.py's random scenes (hit flags and cells equal, distances
and normals within 1e-5), against that file's brute-force oracle (copied
here: ``tests/`` is not a package), on empty and full grids, against B1's
twin under the 1% bar of tests/test_dda_pallas.py:52-66, and on the ray at
which the JAX kernel stalls (ROADMAP.md §3), where both portable
traversals report a miss."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelrt.ops import dda as jdda
from voxelrt.world import build_occupancy_pyramid

from voxelrt_torch.ops import accel as taccel
from voxelrt_torch.ops import dda as tdda
from voxelrt_torch.ops import dda_kernel as dk
from voxelrt_torch.ops.v3 import V3, stack
from voxelrt_torch.world import VoxelWorld

torch.set_num_threads(1)


def oracle_trace(occ_xyz, o, d, tmax=1e30):
    """Amanatides-Woo single-level DDA in float64, numpy scalar reference
    (tests/test_dda.py:13-46)."""
    res = occ_xyz.shape[0]
    t0, t1 = -np.inf, np.inf
    for i in range(3):
        if abs(d[i]) < 1e-12:
            if o[i] < 0 or o[i] > res:
                return np.inf, None
        else:
            a = (0 - o[i]) / d[i]
            b = (res - o[i]) / d[i]
            t0 = max(t0, min(a, b))
            t1 = min(t1, max(a, b))
    if t0 > t1 or t1 < 0:
        return np.inf, None
    t = max(t0, 1e-6)
    p = o + d * (t + 1e-6)
    ip = np.clip(np.floor(p), 0, res - 1).astype(int)
    step = np.sign(d).astype(int)
    inv = 1.0 / np.where(np.abs(d) < 1e-12, 1e-12, np.abs(d))
    for _ in range(4 * res):
        if occ_xyz[ip[0], ip[1], ip[2]]:
            return t, ip.copy()
        frac = (o + d * t) - ip
        dist = np.where(d > 0, 1.0 - frac, frac)
        taxes = dist * inv
        ax = int(np.argmin(taxes))
        t = t + max(taxes[ax], 0.0)
        ip[ax] += step[ax]
        if t > t1 + 1e-6 or ip[ax] < 0 or ip[ax] >= res:
            return np.inf, None
    return np.inf, None


def _pyramids(occ):
    res = occ.shape[0]
    n_lods = int(np.log2(res))
    words = build_occupancy_pyramid(occ, n_lods)
    return (jdda.OccupancyPyramid(jnp.asarray(words), res, n_lods),
            tdda.OccupancyPyramid(torch.from_numpy(words.view(np.int32)),
                                  res, n_lods))


def _rays(res, seed, n):
    rng = np.random.default_rng(seed)
    o = np.where(rng.random((n, 1)) < 0.5, rng.uniform(-res, 2 * res, (n, 3)),
                 rng.uniform(0, res, (n, 3)))
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


@pytest.mark.parametrize("res,fill,seed", [(16, 0.02, 0), (16, 0.2, 1),
                                           (32, 0.05, 2)])
def test_matches_jax_and_the_oracle(res, fill, seed):
    occ = np.random.default_rng(seed).random((res,) * 3) < fill
    jp, tp = _pyramids(occ)
    o, d = _rays(res, seed + 100, 256)
    o32, d32 = o.astype(np.float32), d.astype(np.float32)
    j = jdda.raytrace(jp, jnp.asarray(o32), jnp.asarray(d32), 1e-6, np.inf)
    t = tdda.raytrace(tp, torch.from_numpy(o32), torch.from_numpy(d32), 1e-6,
                      float("inf"))
    jd = np.asarray(j.distance)
    td = t.distance.numpy()
    hit = np.isfinite(jd)
    assert np.array_equal(hit, np.isfinite(td))
    np.testing.assert_allclose(td[hit], jd[hit], rtol=1e-5, atol=1e-5)
    assert np.array_equal(t.ipos.numpy(), np.asarray(j.ipos))
    np.testing.assert_allclose(t.normal.numpy(), np.asarray(j.normal),
                               atol=1e-5)
    assert np.array_equal(t.iters.numpy(), np.asarray(j.iters))

    mismatches = 0
    for i in range(len(o)):
        od, oip = oracle_trace(occ, o[i], d[i])
        if np.isinf(od):
            mismatches += int(not np.isinf(td[i]))
        elif np.isinf(td[i]):
            mismatches += 1
        elif not np.array_equal(t.ipos[i].numpy(), oip) and abs(
                td[i] - od) > 1e-2:
            mismatches += 1
    assert mismatches <= len(o) * 0.01, f"{mismatches}/{len(o)}"


def test_query_occupancy_matches_jax():
    occ = np.random.default_rng(7).random((16,) * 3) < 0.3
    jp, tp = _pyramids(occ)
    rng = np.random.default_rng(3)
    for lod in range(4):
        pts = rng.integers(0, 16 >> lod, (200, 3)).astype(np.int32)
        lods = np.full(200, lod, np.int32)
        want = np.asarray(jdda.query_occupancy(jp, jnp.asarray(pts),
                                               jnp.asarray(lods)))
        got = tdda.query_occupancy(tp, torch.from_numpy(pts),
                                   torch.from_numpy(lods))
        assert np.array_equal(got.numpy(), want)


def test_empty_and_full_grids():
    res = 16
    o = torch.tensor([[-5.0, 8.0, 8.0]])
    d = torch.tensor([[1.0, 0.0, 0.0]])
    _, empty = _pyramids(np.zeros((res,) * 3, bool))
    assert torch.isinf(tdda.raytrace(empty, o, d, 1e-6, float("inf"))
                       .distance[0])
    _, full = _pyramids(np.ones((res,) * 3, bool))
    r = tdda.raytrace(full, o, d, 1e-6, float("inf"))
    assert abs(float(r.distance[0]) - 5.0) < 1e-3
    assert r.ipos[0].tolist() == [0, 8, 8]
    assert r.normal[0].tolist() == [-1.0, 0.0, 0.0]  # faces the ray


@pytest.mark.parametrize("seed,fill", [(0, 0.03), (1, 0.15)])
def test_b1_twin_within_the_bar(seed, fill):
    """B1 (its plain twin here; chip_smoke.py phase 24 holds the kernel on
    the card) against the portable traversal, tests/test_dda_pallas.py's
    scenes and rule: at most 1% of rays disagree, and on agreed hits the
    colour words are the voxel grid's."""
    res = 32
    rng = np.random.default_rng(seed)
    w = VoxelWorld(1.0 / res, res, 0.0)
    w.material = (rng.random((res,) * 3) < fill).astype(np.int8)
    w.color = rng.integers(0, 255, (res, res, res, 3), dtype=np.uint8)
    arrays = w.device_arrays()
    tables = dk.upload_tables(taccel.build_pallas_tables(
        w.material, arrays["voxels"], res), "cpu")
    pyr = tdda.OccupancyPyramid(
        torch.from_numpy(arrays["occ_words"].view(np.int32)), res,
        int(np.log2(res)))
    o, d = _rays(res, seed + 10, 1024)
    o, d = torch.from_numpy(o.astype(np.float32)), torch.from_numpy(
        d.astype(np.float32))
    ref = tdda.raytrace(pyr, o, d, 1e-6, float("inf"))
    got = dk.raytrace_plain(tables, V3(*o.unbind(-1)), V3(*d.unbind(-1)),
                            1e-6, float("inf"))
    bad = tdda.disagreements(ref, got.distance, stack(got.ipos),
                             stack(got.normal))
    assert int(bad.sum()) <= 0.01 * len(o), int(bad.sum())
    agreed = torch.isfinite(ref.distance) & ~bad & (
        ref.ipos == stack(got.ipos)).all(-1)
    assert int(agreed.sum()) > 10
    x, y, z = ref.ipos[agreed].long().unbind(-1)
    want = arrays["voxels"][((z * res + y) * res + x).numpy()]
    assert np.array_equal(got.color_word[agreed].numpy().view(np.uint32), want)


# A camera ray of the NEE oracle's scene (tests/test_oracle_nee.py: the 3^3
# cube in the grid's corner, the camera at z = 1.0 on the 32^3 grid's far
# z face) at which the JAX kernel stalls for its 512 advances; copied from
# tests/test_torch_dda.py, in grid units.
STALL_EYE = ("0x1.8ccccc0000000p+4", "0x1.6b851e0000000p+4",
             "0x1.0000000000000p+5")
STALL_DIR = ("-0x1.0f4e800000000p-4", "-0x1.78d2f40000000p-4",
             "-0x1.fcb3140000000p-1")


def test_stall_ray_is_a_miss_as_in_jax():
    res = 32
    w = VoxelWorld(1.0 / 16.0, res, 0.0)
    ijk = np.stack(np.meshgrid(*[np.arange(3)] * 3, indexing="ij"),
                   -1).reshape(-1, 3)
    w.set_voxels(ijk, 50, np.array((0.95, 0.75, 0.35)))
    jp, tp = _pyramids(w.material != 0)
    o = np.array([[float.fromhex(h) for h in STALL_EYE]], np.float32)
    d = np.array([[float.fromhex(h) for h in STALL_DIR]], np.float32)
    j = jdda.raytrace(jp, jnp.asarray(o), jnp.asarray(d), 1e-6, np.inf)
    t = tdda.raytrace(tp, torch.from_numpy(o), torch.from_numpy(d), 1e-6,
                      float("inf"))
    assert np.isinf(np.asarray(j.distance)[0])
    assert torch.isinf(t.distance[0])
    assert int(t.iters[0]) == int(np.asarray(j.iters)[0]) < 512
