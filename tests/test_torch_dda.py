"""PyTorch port, kernel B1: the traversal twin against the JAX Pallas kernel
(``raytrace_pallas``, interpret mode) in plain closest-hit mode, in-kernel
NEE mode and with an ``alive`` mask, held to the bar of
tests/test_dda_pallas.py:52-66: at most 1% of rays may mismatch in hit,
cell, distance (to 1e-2) or normal; on agreed hits the colour words must be
exact, and the NEE verdicts must agree on at least 99% of rays.

(Distances differ from the JAX kernel by float32 ulps where XLA's CPU
backend contracts a multiply-add; cells, normals and colours agree.)"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelrt.ops.accel import add_sun_open_table as j_sun
from voxelrt.ops.accel import build_pallas_tables as j_tables
from voxelrt.ops.dda_pallas import raytrace_pallas
from voxelrt.ops.sampling import make_orthonormal_basis
from voxelrt.world import VoxelWorld

from voxelrt_torch.ops import accel as taccel
from voxelrt_torch.ops import dda_kernel as dk
from voxelrt_torch.ops.v3 import V3

# One thread per test process: the suite runs several processes side by
# side, and the tensors here are small.
torch.set_num_threads(1)

RES = 32
L = np.array([1.0, 1.0, -1.0]) / math.sqrt(3.0)
CONE_COS = math.cos(0.025 * 0.5)


def _world(fill, seed, n_colors=None):
    rng = np.random.default_rng(seed)
    w = VoxelWorld(1.0 / RES, RES, 0.0)
    w.material = (rng.random((RES,) * 3) < fill).astype(np.int8)
    if n_colors is None:  # direct mode: > 1024 distinct words
        w.color = rng.integers(0, 255, (RES,) * 3 + (3,), dtype=np.uint8)
    else:
        w.color = (rng.integers(0, n_colors, (RES,) * 3 + (1,),
                                dtype=np.uint8) * 31).repeat(3, axis=-1)
    voxels = w.device_arrays()["voxels_np"]
    jt = j_sun(j_tables(w.material, voxels, RES), w.material, L, CONE_COS)
    tt = taccel.add_sun_open_table(
        taccel.build_pallas_tables(w.material, voxels, RES), w.material, L,
        CONE_COS)
    return jt, dk.upload_tables(tt, "cpu")


def _rays(seed, n):
    rng = np.random.default_rng(seed)
    o = np.where(rng.random((n, 1)) < 0.5, rng.uniform(-RES, 2 * RES, (n, 3)),
                 rng.uniform(0, RES, (n, 3))).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return rng, o, d


def _tv3(a):
    return V3(*(torch.from_numpy(np.ascontiguousarray(a[:, i]))
                for i in range(3)))


def _bar(j, t):
    """The test_dda_pallas.py:52-66 comparison; returns the mismatch count
    and the number of agreed hits whose colour words were checked."""
    jd, td = np.asarray(j.distance), t.distance.numpy()
    ji, ti = np.asarray(j.ipos), torch.stack(list(t.ipos), -1).numpy()
    jn, tn = np.asarray(j.normal), torch.stack(list(t.normal), -1).numpy()
    jh, th = np.isfinite(jd), np.isfinite(td)
    same_cell = (ji == ti).all(1)
    both = jh & th
    far = np.zeros_like(both)
    far[both] = np.abs(jd[both] - td[both]) > 1e-2
    mism = (jh != th) | (both & far) | (both & same_cell
                                        & ~(jn == tn).all(1))
    agreed = both & same_cell
    jc = np.asarray(j.color_word).astype(np.uint32)
    tc = t.color_word.numpy().view(np.uint32)
    np.testing.assert_array_equal(tc[agreed], jc[agreed])
    return int(mism.sum()), int(agreed.sum())


@pytest.mark.parametrize("fill,seed,n_colors", [(0.03, 0, None),
                                                (0.15, 1, None),
                                                (0.10, 7, 8)])
def test_b1_twin_matches_pallas_closest_hit(fill, seed, n_colors):
    jt, tt = _world(fill, seed, n_colors)
    assert (tt.palette_words.shape[0] > 0) == (n_colors is not None)
    _, o, d = _rays(seed + 10, 1024)
    j = raytrace_pallas(jt, jnp.asarray(o), jnp.asarray(d), 1e-6, np.inf, RES,
                        interpret=True)
    t = dk.raytrace(tt, _tv3(o), _tv3(d), 1e-6, float("inf"))
    mism, checked = _bar(j, t)
    assert mism <= 1024 * 0.01, mism
    assert checked > 10
    np.testing.assert_array_equal(t.iters.numpy()[np.isfinite(
        np.asarray(j.distance))], np.asarray(j.iters)[np.isfinite(
            np.asarray(j.distance))])


def test_b1_twin_matches_pallas_nee_and_alive():
    """In-kernel NEE (primaries converting into sun-cone shadow rays, some
    from the floor crossing alt_t) with a wavefront ``alive`` mask."""
    jt, tt = _world(0.10, 11)
    rng, o, d = _rays(77, 2048)
    n = o.shape[0]
    u = rng.random((n, 2)).astype(np.float32)
    alt = np.where(rng.random(n) < 0.3, rng.uniform(0, 40, n),
                   np.inf).astype(np.float32)
    alive = rng.random(n) < 0.8
    tmax = np.where(alive, np.inf, 0.0).astype(np.float32)
    lj = jnp.asarray(L, jnp.float32)
    x, y = make_orthonormal_basis(lj)
    j = raytrace_pallas(
        jt, jnp.asarray(o), jnp.asarray(d), 1e-6, jnp.asarray(tmax), RES,
        interpret=True, queue_depth=2,
        nee=dict(u=jnp.asarray(u), alt_t=jnp.asarray(alt), light_dir=lj,
                 tangent=x, bitangent=y, cone_cos=CONE_COS,
                 eps_grid=16e-4, shadow_tmin=1e-4),
        alive=jnp.asarray(alive))
    nee = dk.nee_params(
        (torch.from_numpy(u[:, 0].copy()), torch.from_numpy(u[:, 1].copy())),
        torch.from_numpy(alt), np.asarray(lj), np.asarray(x), np.asarray(y),
        CONE_COS, 16e-4, 1e-4, "cpu")
    t = dk.raytrace(tt, _tv3(o), _tv3(d), 1e-6, torch.from_numpy(tmax),
                    nee=nee, alive=torch.from_numpy(alive))
    mism, checked = _bar(j, t)
    assert mism <= n * 0.01, mism
    assert checked > 50
    jv, tv = np.asarray(j.nee_visible), t.nee_visible.numpy()
    assert (jv == tv).mean() >= 0.99
    assert jv[alive].sum() > 50
    dead = ~alive
    assert np.isinf(t.distance.numpy()[dead]).all()
    assert (torch.stack(list(t.ipos), -1).numpy()[dead] == -1).all()
    assert (tv[dead] == 0).all() and (t.iters.numpy()[dead] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("sun_mode,src_open", [("half", True), ("off", False),
                                               ("all", False)])
@pytest.mark.parametrize("share", [0.07, 0.6, 1.0])
def test_b1_kernel_matches_twin_on_card(share, sun_mode, src_open):
    """Every output and the pass counts bit-equal, at sparse and full alive
    masks, with and without the sun-open early-outs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: B1 is a CUDA kernel")
    dev = torch.device("cuda")
    jt, tt = _world(0.10, 11)
    tt = dk.DeviceTables(*(x.to(dev) for x in tt[:-1]), tt.grid_res)
    rng, o, d = _rays(5, 50_000)
    n = o.shape[0]
    ov, dv = (V3(*(c.to(dev) for c in _tv3(a))) for a in (o, d))
    u = torch.from_numpy(rng.random((n, 2)).astype(np.float32)).to(dev)
    alt = torch.full((n,), float("inf"), device=dev)
    alive = torch.from_numpy(rng.random(n) < share).to(dev)
    nee = dk.nee_params((u[:, 0].contiguous(), u[:, 1].contiguous()), alt, L,
                        [0.0, 0.0, 1.0], [0.0, 1.0, 0.0], CONE_COS, 16e-4,
                        1e-4, dev)
    for kw in ({}, dict(alive=alive),
               dict(nee=nee, alive=alive, sun_mode=sun_mode,
                    nee_src_open=src_open)):
        a = dk.raytrace(tt, ov, dv, 1e-6, float("inf"), **kw)
        b = dk.raytrace_plain(tt, ov, dv, 1e-6, float("inf"), **kw)
        for f in ("distance", "iters", "color_word", "active", "nee_visible",
                  "counts"):
            x, y = getattr(a, f), getattr(b, f)
            if x is not None:
                assert torch.equal(x, y), f
        for x, y in zip((*a.ipos, *a.normal), (*b.ipos, *b.normal)):
            assert torch.equal(x, y)


# A camera ray of the port's render of tests/test_oracle_nee.py's scene (the
# 3^3 cube in the grid's corner; launch 10, pixel (61, 47), sample 8), in
# grid units: it starts on the grid's far z face, and its position rounds
# past a cell face that its cell index has not crossed. The JAX kernel
# steps no axis there (its exit test is ==) and stalls the ray for its 512
# advances, returning a hit with a zero normal; B1 steps on (<=) and the
# ray, which passes about 19 cells wide of the cube, misses.
STALL_EYE = ("0x1.8ccccc0000000p+4", "0x1.6b851e0000000p+4",
             "0x1.0000000000000p+5")
STALL_DIR = ("-0x1.0f4e800000000p-4", "-0x1.78d2f40000000p-4",
             "-0x1.fcb3140000000p-1")


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_b1_steps_past_a_rounded_face(device):
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: B1 is a CUDA kernel")
    w = VoxelWorld(1.0 / 16.0, RES, 0.0)
    ijk = np.stack(np.meshgrid(*[np.arange(3)] * 3, indexing="ij"),
                   -1).reshape(-1, 3)
    w.set_voxels(ijk, 50, np.array((0.95, 0.75, 0.35)))
    tt = dk.upload_tables(taccel.build_pallas_tables(
        w.material, w.device_arrays()["voxels_np"], RES), device)

    def v3(hexes):
        return V3(*(torch.tensor([float.fromhex(h)], dtype=torch.float32,
                                 device=device) for h in hexes))

    eye, d = v3(STALL_EYE), v3(STALL_DIR)
    b = dk.raytrace_plain(tt, eye, d, 1e-6, float("inf"))
    assert b.iters.item() < 512
    assert b.distance.item() == float("inf")
    if device == "cuda":
        a = dk.raytrace(tt, eye, d, 1e-6, float("inf"))
        for f in ("distance", "iters", "color_word", "active"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        for x, y in zip((*a.ipos, *a.normal), (*b.ipos, *b.normal)):
            assert torch.equal(x, y)
