"""PyTorch port, kernel B1: the sun-open early-outs and the layout of the
alive-ray list.

The twin's early-outs against the JAX Pallas kernel (``raytrace_pallas``,
interpret mode) on the worlds of tests/test_dda_pallas.py: the ground slab
with occluders of ``test_nee_src_open_matches_plain`` for in-kernel NEE
under every ``sun_mode`` and ``nee_src_open``, and the terrain of
``test_sun_open_kernel_matches_plain_shadow`` for the shadow dispatch with
``use_sun_open``. Bar: tests/test_dda_pallas.py:52-66 for the primaries (at
most 1% of rays mismatch in hit, cell, distance to 1e-2 or normal; colour
words exact on agreed hits); the NEE verdicts and the shadow verdicts
exact.

The list layout: the kernel traces only the alive rays, listed in blocks
whose order the card decides, and scatters each ray's outputs to its
original index; here the same decomposition with a plain compaction and a
shuffled block order equals the twin on all lanes."""

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

from test_dda_pallas import _cone_dirs, make_terrain_setup
from test_torch_dda import _bar, _tv3

# One thread per test process: the suite runs several processes side by
# side, and the tensors here are small.
torch.set_num_threads(1)

RES = 32
SLAB_L = np.array([0.4, 1.0, 0.2]) / np.linalg.norm([0.4, 1.0, 0.2])
SLAB_CONE = math.cos(0.025 * 0.5)
COMPACT_BLOCK = 256  # rays per block of B1's alive-list pass (csrc/dda.cu)


def _both_tables(mat, voxels, light, cone_cos):
    jt = j_sun(j_tables(mat, voxels, RES), mat, light, cone_cos)
    tt = taccel.add_sun_open_table(
        taccel.build_pallas_tables(mat, voxels, RES), mat, light, cone_cos)
    return jt, dk.upload_tables(tt, "cpu")


@pytest.fixture(scope="module")
def slab():
    """tests/test_dda_pallas.py:test_nee_src_open_matches_plain's world and
    rays: a ground slab, occluders in the lower third, the open upper half
    certified sun-open; 80% of the rays alive, 30% with a floor crossing."""
    rng = np.random.default_rng(33)
    mat = (rng.random((RES,) * 3) < 0.04).astype(np.int8)
    mat[:, 10:, :] = 0
    mat[:, 0:2, :] = 1
    w = VoxelWorld(1.0 / RES, RES, 0.0)
    w.material = mat
    w.color = rng.integers(0, 255, (RES, RES, RES, 3), dtype=np.uint8)
    jt, tt = _both_tables(mat, w.device_arrays()["voxels_np"], SLAB_L,
                          SLAB_CONE)
    assert int(tt.sun_open_words.ne(0).sum()) > 0
    n = 2048
    o = rng.uniform(0, RES, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    alive = rng.random(n) < 0.8
    u = rng.random((n, 2)).astype(np.float32)
    alt = np.where(rng.random(n) < 0.3, rng.uniform(1.0, 40.0, n),
                   np.inf).astype(np.float32)
    return dict(jt=jt, tt=tt, o=o, d=d, alive=alive, u=u, alt=alt)


def _jax_nee(s):
    lj = jnp.asarray(SLAB_L, jnp.float32)
    x, y = make_orthonormal_basis(lj)
    return dict(u=jnp.asarray(s["u"]), alt_t=jnp.asarray(s["alt"]),
                light_dir=lj, tangent=x, bitangent=y, cone_cos=SLAB_CONE,
                eps_grid=16e-4, shadow_tmin=1e-4), (x, y)


def _port_nee(s, x, y):
    u = torch.from_numpy(s["u"])
    return dk.nee_params((u[:, 0].contiguous(), u[:, 1].contiguous()),
                         torch.from_numpy(s["alt"]), SLAB_L.astype(np.float32),
                         np.asarray(x), np.asarray(y), SLAB_CONE, 16e-4, 1e-4,
                         "cpu")


def _tmax(alive):
    return np.where(alive, np.inf, 0.0).astype(np.float32)


@pytest.mark.parametrize("nee_src_open", [False, True], ids=["src_off",
                                                             "src_on"])
@pytest.mark.parametrize("sun_mode", ["all", "half", "off"])
def test_nee_early_outs_match_pallas(slab, sun_mode, nee_src_open):
    """In-kernel NEE with the per-advance (``sun_mode``) and the
    conversion-time (``nee_src_open``) early-outs. The JAX kernel runs
    queued with a 2-advance march unroll, so that its 'half' cadence checks
    the unrolled segments; the port checks every advance under 'all' and
    'half'."""
    jnee, (x, y) = _jax_nee(slab)
    o, d, alive = slab["o"], slab["d"], slab["alive"]
    j = raytrace_pallas(
        slab["jt"], jnp.asarray(o), jnp.asarray(d), 1e-6,
        jnp.asarray(_tmax(alive)), RES, interpret=True, queue_depth=2,
        refill_every=2, march_unroll=2, nee=jnee, alive=jnp.asarray(alive),
        sun_mode=sun_mode, nee_src_open=nee_src_open)
    t = dk.raytrace(slab["tt"], _tv3(o), _tv3(d), 1e-6,
                    torch.from_numpy(_tmax(alive)), nee=_port_nee(slab, x, y),
                    alive=torch.from_numpy(alive), sun_mode=sun_mode,
                    nee_src_open=nee_src_open)
    n = o.shape[0]
    mism, checked = _bar(j, t)
    assert mism <= n * 0.01, mism
    assert checked > 50
    jv = np.asarray(j.nee_visible)
    np.testing.assert_array_equal(t.nee_visible.numpy(), jv)
    assert jv.sum() > 50 and (jv[alive] == 0).sum() > 50
    n_alive, marched, settled = t.counts.tolist()
    assert n_alive == int(alive.sum())
    assert (settled > 0) == nee_src_open and marched > 0


def test_nee_src_open_settles_without_a_march(slab):
    """``nee_src_open`` moves shadow rays from the march to the conversion
    and leaves every output as it was."""
    _, (x, y) = _jax_nee(slab)
    args = (slab["tt"], _tv3(slab["o"]), _tv3(slab["d"]), 1e-6,
            torch.from_numpy(_tmax(slab["alive"])))
    kw = dict(nee=_port_nee(slab, x, y), alive=torch.from_numpy(slab["alive"]))
    a = dk.raytrace(*args, **kw)
    b = dk.raytrace(*args, nee_src_open=True, **kw)
    for f in ("distance", "iters", "color_word", "active", "nee_visible"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    a_marched, b_marched = a.counts[1].item(), b.counts[1].item()
    assert b_marched + b.counts[2].item() == a_marched
    assert b_marched < 0.9 * a_marched


@pytest.fixture(scope="module")
def terrain():
    """tests/test_dda_pallas.py:test_sun_open_kernel_matches_plain_shadow's
    terrain and sun-cone rays."""
    seed, noise = 4, 0.2
    world, _, _ = make_terrain_setup(RES, seed)
    rng = np.random.default_rng(seed + 5)
    light = np.array([0.6, 1.0, -0.3])
    cone_cos = np.cos(noise * 0.5)
    jt, tt = _both_tables(world.material, world.device_arrays()["voxels_np"],
                          light, cone_cos)
    n = 2048
    o = rng.uniform(0, RES, (n, 3)).astype(np.float32)
    d = _cone_dirs(rng, light, cone_cos, n)
    return dict(jt=jt, tt=tt, o=o, d=d)


@pytest.mark.parametrize("use_sun_open", [False, True])
def test_shadow_sun_open_matches_pallas(terrain, use_sun_open):
    """The explicit sun-shadow dispatch: the twin's verdicts equal the JAX
    kernel's, with the certificate and without it."""
    o, d = terrain["o"], terrain["d"]
    j = raytrace_pallas(terrain["jt"], jnp.asarray(o), jnp.asarray(d), 1e-6,
                        np.inf, RES, any_hit=True, fetch_colors=False,
                        use_sun_open=use_sun_open, interpret=True)
    t = dk.raytrace(terrain["tt"], _tv3(o), _tv3(d), 1e-6, float("inf"),
                    any_hit=True, fetch_colors=False,
                    use_sun_open=use_sun_open)
    jh = np.isfinite(np.asarray(j.distance))
    np.testing.assert_array_equal(np.isfinite(t.distance.numpy()), jh)
    assert 100 < jh.sum() < len(jh) - 100


def test_sun_open_saves_advances_on_escaping_shadow_rays(terrain):
    """tests/test_dda_pallas.py:478-481 for the twin: the certificate
    retires escaping rays in fewer advances (shadow mode returns no advance
    count, so the twin's march state is read directly)."""
    o, d = _tv3(terrain["o"]), _tv3(terrain["d"])
    adv = {}
    for flag in (False, True):
        _, _, st = dk._trace_primaries(terrain["tt"], o, d, 1e-6,
                                       float("inf"), 512, None, True, flag)
        adv[flag] = st
    esc = adv[False]["t"] >= dk.BIG
    assert torch.equal(esc, adv[True]["t"] >= dk.BIG)
    assert esc.sum() > 100
    assert adv[True]["adv"][esc].sum() < adv[False]["adv"][esc].sum()


def _compact_plain(alive, rng):
    """The alive-list pass in plain form: the alive lanes' indices, block of
    COMPACT_BLOCK lanes by block, the blocks in a shuffled order (the card
    appends each block where its atomicAdd lands)."""
    n = alive.shape[0]
    blocks = [torch.nonzero(alive[lo:lo + COMPACT_BLOCK]).squeeze(1) + lo
              for lo in range(0, n, COMPACT_BLOCK)]
    order = rng.permutation(len(blocks))
    return torch.cat([blocks[k] for k in order])


def _scatter(sub, idx, n):
    """Each listed ray's outputs to its original index; every other lane
    gets the canonical miss (distance inf, ipos -1, normal 0, iters 0,
    colour 0, active 0, nee_visible 0)."""
    def put(fill, v):
        out = torch.full((n,), fill, dtype=v.dtype)
        out[idx] = v
        return out

    return dict(
        distance=put(float("inf"), sub.distance),
        ipos=[put(-1, c) for c in sub.ipos],
        normal=[put(0.0, c) for c in sub.normal],
        iters=put(0, sub.iters), color_word=put(0, sub.color_word),
        active=put(0, sub.active), nee_visible=put(0, sub.nee_visible))


@pytest.mark.parametrize("share", [0.0, 0.07, 0.6, 1.0])
def test_alive_list_layout_equals_all_lanes(slab, share):
    """Compact, trace the alive subset (NEE, both early-outs on), scatter:
    every output equals the twin's on all lanes with the alive mask."""
    rng = np.random.default_rng(int(share * 100) + 1)
    n = slab["o"].shape[0]
    alive = torch.from_numpy(rng.random(n) < share)
    _, (x, y) = _jax_nee(slab)
    nee = _port_nee(slab, x, y)
    o, d = _tv3(slab["o"]), _tv3(slab["d"])
    kw = dict(sun_mode="all", nee_src_open=True)
    ref = dk.raytrace(slab["tt"], o, d, 1e-6, float("inf"), nee=nee,
                      alive=alive, **kw)
    idx = _compact_plain(alive, rng)
    assert idx.numel() == int(alive.sum()) == ref.counts[0].item()
    sub = dk.raytrace(
        slab["tt"], V3(*(c[idx] for c in o)), V3(*(c[idx] for c in d)), 1e-6,
        float("inf"),
        nee={k: (v[idx] if k != "scalars" else v) for k, v in nee.items()},
        **kw)
    assert torch.equal(sub.counts, ref.counts)
    got = _scatter(sub, idx, n)
    for f in ("distance", "iters", "color_word", "active", "nee_visible"):
        assert torch.equal(got[f], getattr(ref, f)), f
    for a, b in zip((*got["ipos"], *got["normal"]), (*ref.ipos, *ref.normal)):
        assert torch.equal(a, b)
