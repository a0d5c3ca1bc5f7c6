"""PyTorch port, the sky precompute (voxelrt_torch/sky/atmos.py) against the
JAX package's (voxelrt/sky/atmos.py) and against the float64 oracle of
tests/test_oracle_sky.py, on the CPU, with temporary cache directories.

Tolerances, and why.

* The tensor ``uniform`` must equal ``jax.random.uniform`` draw for draw.
* Each function on random inputs: rtol 2e-4 / atol 1e-7 on every element
  (float32 rounding: XLA's CPU transcendentals against torch's), except the
  functions with a discontinuity (the cloud density's 0.7 threshold and
  texel quantisation, the ``live`` gate of the cloud march), where a last-bit
  difference in a position flips a texel: there a share of lanes is held.
* ``prepare_sky`` as a whole: the share of texels whose three channels of
  both maps lie within rtol 2e-4 / atol 1e-7 of the JAX package's. The
  clear-sky part (the scattering map with ``use_clouds=False``) must reach
  99% (the rest are texels at the horizon, where ``planet_near > 0`` flips).
  With clouds the share is lower, and not because a formula differs: each
  cloud texel is the mean of a few dozen density lookups quantised to 113 m
  cells of a 256x256 texture and thresholded at 0.7, and a position that
  differs in its last bit lands one of them in the neighbouring cell. At
  these test knobs (2 passes of 4 or 8 steps) one flipped lookup moves a
  texel by percents. XLA compiles the JAX package's chunk functions with
  fused multiply-adds and a correctly rounded square root; the port forms
  the positions that feed the lookups the same way (in float64, rounded
  once), which leaves the texel directions (XLA's own sine, cosine and
  reciprocal square root) as the cause of what still differs. The share is
  printed and recorded in ROADMAP.md section 3; it measures 0.9589 to
  0.9624 over the four cases and is asserted at 0.95, and the maps' RMSE
  relative to their mean (measured: scattering up to 4.0e-2, transmittance
  up to 6.1e-3) at 6e-2 and 1.5e-2: each share bar lies just under what was
  measured, so that a fault which moves a few percent of the texels fails. The float64 oracle's end-to-end
  check below holds the port's maps independently.
* The oracle's bars are those of tests/test_oracle_sky.py."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelrt.app import testing
from voxelrt.config import RenderConfig as JCfg
from voxelrt.sky import atmos as ja

from voxelrt_torch.config import RenderConfig as TCfg
from voxelrt_torch.ops import prng
from voxelrt_torch.ops.v3 import V3
from voxelrt_torch.sky import atmos as ta

import test_oracle_sky as osky
from test_examples_golden import TINY_SKY

# One thread per test process: the suite runs several processes side by
# side, and the tensors here are small.
torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 1e-7
SUN = np.array([0.3, 0.5, 0.8], np.float32) / np.float32(
    np.linalg.norm([0.3, 0.5, 0.8]))
COL = np.array([3.0, 2.8, 2.5], np.float32)
COS_MAX = 0.9995


def _tv(a):
    a = np.asarray(a, np.float32)
    return V3(*(torch.from_numpy(np.ascontiguousarray(a[..., i]))
                for i in range(3)))


def _pk(v):
    return torch.stack(list(v), -1).numpy()


def _close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol,
                               atol=atol)


def _share_close(t, j):
    return float(np.isclose(np.asarray(t), np.asarray(j), rtol=RTOL,
                            atol=ATOL).mean())


def _cfgs(**kw):
    kw = dict(use_physical_sky=True, use_clouds=True, **kw)
    return JCfg(**kw), TCfg(**kw)


def _dirs(n, seed, up=False):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    if up:
        d[:, 1] = np.abs(d[:, 1]) + 0.05
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return d.astype(np.float32)


def _jkey(seed):
    k = jax.random.PRNGKey(seed)
    return k, tuple(int(x) for x in np.asarray(k))


# --- the draws ----------------------------------------------------------------


@pytest.mark.parametrize("shape", [(7,), (2, 5, 2), (3, 700, 2)])
def test_uniform_tensor_matches_jax(shape):
    for seed in (0, 1234):
        k, kk = _jkey(seed)
        k = jax.random.fold_in(k, 1003)
        kk = prng.fold_in(kk, 1003)
        got = prng.uniform(kk, shape, "cpu")
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jax.random.uniform(k, shape)))


def test_uniform_batch_of_keys_matches_jax():
    """Several chunk keys drawn in one call: each key draws what it would
    draw alone (fold_in of a tensor gives the per-chunk keys)."""
    k, kk = _jkey(1234)
    ci = torch.arange(5)
    kb = prng.fold_in(kk, 1000 + ci)
    kb2 = prng.fold_in(prng.fold_in(kb, 2), 31)
    got = prng.uniform(kb2, (4, 3, 2), "cpu").numpy()
    assert got.shape == (5, 4, 3, 2)
    for i in range(5):
        ki = jax.random.fold_in(jax.random.fold_in(
            jax.random.fold_in(k, 1000 + i), 2), 31)
        np.testing.assert_array_equal(
            got[i], np.asarray(jax.random.uniform(ki, (4, 3, 2))))


# --- function by function -------------------------------------------------------


def test_geometry_phases_density_match_jax():
    rng = np.random.default_rng(0)
    n = 4000
    d = _dirs(n, 1)
    pos = (np.array([0, ja.PLANET_R, 0]) + rng.uniform(-1, 1, (n, 3))
           * [5e4, 0, 5e4] + [0, 1, 0] * rng.uniform(0, 1e5, (n, 1))).astype(
               np.float32)
    # rsi cancels catastrophically in float32 (b*b and |p|^2 near 4e13, an
    # ulp of 4e6 m^2). The port forms b*b - |p|^2 with one rounding, which is
    # what XLA's fused multiply-add computes: from a point on the axis, where
    # the dot products have one term (the camera of every texel ray), the two
    # agree to an ulp of the root; elsewhere XLA also fuses inside the dot products
    # and the roots differ by metres.
    cam = np.broadcast_to(ja.CAM_POS, pos.shape).copy()
    for r in (ja.PLANET_R, ja.PLANET_R + ja.CLOUD_HEIGHT,
              ja.PLANET_R + ja.ATMOS_HEIGHT):
        jrsi = jax.jit(lambda p, dd: ja.rsi(p, dd, r))
        _, tf = ta.rsi(_tv(cam), _tv(d), r)
        _, jf = jrsi(jnp.asarray(cam), jnp.asarray(d))
        assert (tf.numpy() == np.asarray(jf)).mean() > 0.99
        assert np.abs(tf.numpy() - np.asarray(jf)).max() <= 2.0
        for a, b in zip(ta.rsi(_tv(pos), _tv(d), r),
                        jrsi(jnp.asarray(pos), jnp.asarray(d))):
            hit = (a.numpy() != -1.0) & (np.asarray(b) != -1.0)
            err = np.abs(a.numpy() - np.asarray(b))[hit]
            assert np.median(err) < 1.0 and err.max() < 256.0, err.max()
    mu = rng.uniform(-1, 1, n).astype(np.float32)
    _close(ta.rayleigh_phase(torch.from_numpy(mu)),
           ja.rayleigh_phase(jnp.asarray(mu)))
    for g in (0.75, -0.55 * 0.25):
        _close(ta.mie_phase(torch.from_numpy(mu), g),
               ja.mie_phase(jnp.asarray(mu), g))
    _close(ta.cloud_phase(torch.from_numpy(mu), 0.5),
           ja.cloud_phase(jnp.asarray(mu), 0.5))
    _close(ta.get_elevation(_tv(pos)), ja.get_elevation(jnp.asarray(pos)),
           atol=1.0)  # |p| is 6.4e6: an ulp is 0.5 m
    h = rng.uniform(-100, 1.2e5, n).astype(np.float32)
    _close(torch.stack(ta.get_density(torch.from_numpy(h)), -1),
           ja.get_density(jnp.asarray(h)))
    _close(_pk(ta.sun_transmittance(_tv(pos), _tv(d))),
           ja.sun_transmittance(jnp.asarray(pos), jnp.asarray(d)), atol=2e-6)
    _close(_pk(ta.get_ray_transmittance(_tv(pos), _tv(d))),
           ja.get_ray_transmittance(jnp.asarray(pos), jnp.asarray(d)),
           atol=2e-6)
    np.testing.assert_array_equal(ta._ms_dirs(8), ja._ms_dirs(8))
    np.testing.assert_array_equal(ta.EXTINC_MAT, ja.EXTINC_MAT)
    np.testing.assert_array_equal(ta.CAM_POS, ja.CAM_POS)


def test_lut_and_skybox_parameterization_match_jax():
    jl = np.asarray(ja.generate_transmittance_lut())
    tl = ta.generate_transmittance_lut("cpu")
    assert tuple(tl.shape) == (256, 128, 3)
    _close(tl, jl, atol=2e-6)
    rng = np.random.default_rng(3)
    ct = rng.uniform(-1, 1, 500).astype(np.float32)
    h = rng.uniform(0, 1.1e5, 500).astype(np.float32)
    _close(ta.read_trans_lut(torch.from_numpy(jl.copy()), torch.from_numpy(ct),
                             torch.from_numpy(h)),
           ja.read_trans_lut(jnp.asarray(jl), jnp.asarray(ct), jnp.asarray(h)),
           0, 0)
    uv = rng.random((1000, 2)).astype(np.float32)
    _close(_pk(ta.unproject_sky(torch.from_numpy(uv[:, 0].copy()),
                                torch.from_numpy(uv[:, 1].copy()), 64)),
           ja.unproject_sky(jnp.asarray(uv), 64), atol=1e-6)
    jc, tc = _cfgs(skybox_res=200)
    for ci in (0, 2):
        _close(_pk(ta._texel_dirs(tc, ci, 16384, "cpu")),
               ja._texel_dirs(jc, ci, 16384), atol=1e-6)
    both = _pk(ta._texel_dirs(tc, torch.tensor([0, 2]), 16384, "cpu"))
    np.testing.assert_array_equal(both[1], _pk(ta._texel_dirs(tc, 2, 16384, "cpu")))
    # test_sky.py's roundtrip, on the port
    d = _dirs(500, 0)
    u, v = ta.project_sky_soa(_tv(d), 256)
    d2 = _pk(ta.unproject_sky(u, v, 256))
    assert np.sum(d2 * d, axis=1).min() > 0.9995


def _ordered(a):
    """float32 bits as integers in the floats' order, so that the
    difference of two is their distance in ulps."""
    i = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    return np.where(i < 0, -(i & 0x7FFFFFFF), i)


def test_texel_dirs_ulp_distance():
    """The texel directions, the one input of the sky's chunks where the
    packages still differ, held by their distance in ulps: every texel of a
    ``skybox_res=64`` sky (one chunk of 4,096), each component of the port's
    direction against the JAX package's. Measured: at most 3 ulp, with 52%
    of directions bit-equal; the bound is 4 ulp.

    No port can be bit-equal here. XLA compiles the JAX package's
    ``normalize`` (``jax.lax.rsqrt``) to the CPU's approximate reciprocal
    square root (``vrsqrtps``) with a refinement step, whose table differs
    between CPU vendors, and its ``sin``/``cos`` to XLA's own vector forms;
    neither is correctly rounded, nor is torch's. The shares of 2,000,000
    random inputs that each package rounds correctly (against float64
    rounded once) are printed: sin and cos on [-pi, pi], rsqrt on
    [0.25, 4]."""
    res = 64
    j = np.asarray(ja._texel_dirs(JCfg(skybox_res=res), 0, res * res))
    t = _pk(ta._texel_dirs(TCfg(skybox_res=res), 0, res * res, "cpu"))
    ulps = np.abs(_ordered(j) - _ordered(t))
    print(f"texel directions at {res}^2: at most {ulps.max()} ulp a "
          f"component, {(ulps == 0).all(-1).mean():.4f} of directions "
          f"bit-equal")
    assert ulps.max() <= 4, ulps.max()

    rng = np.random.default_rng(0)
    x = rng.uniform(-np.pi, np.pi, 2_000_000).astype(np.float32)
    y = rng.uniform(0.25, 4.0, 2_000_000).astype(np.float32)
    for name, jf, tf, a, exact in (
            ("sin", jnp.sin, torch.sin, x, np.sin(x.astype(np.float64))),
            ("cos", jnp.cos, torch.cos, x, np.cos(x.astype(np.float64))),
            ("rsqrt", jax.lax.rsqrt, torch.rsqrt, y,
             1.0 / np.sqrt(y.astype(np.float64)))):
        exact = exact.astype(np.float32)
        jv = np.asarray(jax.jit(jf)(a))
        tv = tf(torch.from_numpy(a)).numpy()
        print(f"{name}: correctly rounded, JAX {(jv == exact).mean():.4f}, "
              f"torch {(tv == exact).mean():.4f}; equal {(jv == tv).mean():.4f}")


def test_cloud_field_and_table_match_procedural_function():
    """_hash01, _value_noise and the three fbm channels are bit-equal to the
    JAX package's on cx, cy in [-1, 257]; the 256x256 gather table equals the
    procedural function there (it is periodic in 256). The density lookup
    is bit-equal to the JAX package's at the same elevation, and the
    elevation to the JAX package's as XLA compiles it (a fused dot)."""
    c = np.arange(-1, 258)
    cx, cy = (a.ravel() for a in np.meshgrid(c, c, indexing="ij"))
    jx, jy = jnp.asarray(cx, jnp.int32), jnp.asarray(cy, jnp.int32)
    tx, ty = torch.from_numpy(cx), torch.from_numpy(cy)
    for ch in (0, 9, 17):
        np.testing.assert_array_equal(ta._hash01(tx, ty, ch).numpy(),
                                      np.asarray(ja._hash01(jx, jy, ch)))
    np.testing.assert_array_equal(
        ta._value_noise(tx.float(), ty.float(), 8.0, 3).numpy(),
        np.asarray(ja._value_noise(jx.astype(jnp.float32),
                                   jy.astype(jnp.float32), 8.0, 3)))
    jch = [np.asarray(a) for a in ja.cloud_texture_channels(jx, jy)]
    tch = [a.numpy() for a in ta.cloud_texture_channels(tx, ty)]
    for a, b in zip(tch, jch):
        np.testing.assert_array_equal(a, b)
    tab = ta.cloud_table(None, "cpu")
    assert tab.wrap and tuple(tab.words.shape) == (131072,)
    flat = (cx & 255) * 256 + (cy & 255)
    thr = [np.where(a < 0.7, 0.0, a).astype(np.float32) for a in jch]
    np.testing.assert_array_equal(
        tab.words.numpy()[flat], np.float32(ja.CLOUD_DENSITY) * thr[2] * thr[0])
    np.testing.assert_array_equal(
        tab.words.numpy()[65536 + flat],
        np.float32(ja.CLOUD_DENSITY) * thr[2] * thr[1])
    # test_sky.py's field checks, on the port
    rng = np.random.default_rng(2)
    n = 20000
    xz = rng.uniform(-30000, 30000, (n, 2)).astype(np.float32)
    h_in = ja.PLANET_R + ja.CLOUD_HEIGHT + ja.CLOUD_THICKNESS * 0.3
    for h, tex in ((h_in, None), (h_in, rng.random((256, 256, 3)).astype(
            np.float32)), (ja.PLANET_R + 100.0, None)):
        p = np.stack([xz[:, 0], np.full(n, h, np.float32), xz[:, 1]], -1)
        np.testing.assert_array_equal(
            ta.get_elevation(_tv(p)).numpy(),
            np.asarray(jax.jit(ja.get_elevation)(jnp.asarray(p))))
        rel = torch.tensor(np.asarray(ja.get_elevation(jnp.asarray(p))))
        got = ta.sample_cloud_density(_tv(p), tex, rel).numpy()
        want = np.asarray(ja.sample_cloud_density(
            jnp.asarray(p), None if tex is None else jnp.asarray(tex)))
        np.testing.assert_array_equal(got, want)
        if h != h_in:
            assert (got == 0).all()
        elif tex is None:
            assert 0.005 < (got > 0).mean() < 0.6
            assert got.max() <= ja.CLOUD_DENSITY + 1e-6
    solid = np.ones((256, 256, 3), np.float32)
    p = np.stack([xz[:, 0], np.full(n, h_in, np.float32), xz[:, 1]], -1)
    assert np.allclose(ta.sample_cloud_density(_tv(p), solid).numpy(),
                       ja.CLOUD_DENSITY)
    assert (ta.sample_cloud_density(_tv(p), solid * 0.69).numpy() == 0).all()


def test_marches_match_jax():
    jc, tc = _cfgs(**TINY_SKY)
    k, kk = _jkey(7)
    m = 512
    d = _dirs(m, 5, up=True)
    cam = np.broadcast_to(ja.CAM_POS, (m, 3)).copy()
    js, jt = jax.jit(lambda p, dd: ja.atmospheric_scattering(
        jc, p, dd, jnp.asarray(SUN), jnp.asarray(COL), COS_MAX, k))(
            jnp.asarray(cam), jnp.asarray(d))
    ts, tt = ta.atmospheric_scattering(tc, _tv(cam), _tv(d), SUN, COL,
                                       COS_MAX, kk)
    assert _share_close(_pk(ts), js) > 0.995
    assert _share_close(_pk(tt), jt) > 0.995
    # the cloud marches have the texel and threshold discontinuities
    rng = np.random.default_rng(9)
    dith = rng.random(m).astype(np.float32)
    amb = np.array([0.1, 0.12, 0.15], np.float32)
    p = (cam + d * 2200.0).astype(np.float32)
    jod = ja.clouds_shadow_od(jnp.asarray(p), jnp.asarray(d),
                              jnp.asarray(dith), steps=4)
    tod = ta.clouds_shadow_od(_tv(p), _tv(d), torch.from_numpy(dith), steps=4)
    assert _share_close(tod, jod) > 0.98
    jo = jax.jit(lambda p_, dd, dt: ja.clouds_scattering(
        jc, p_, dd, jnp.asarray(SUN), jnp.asarray(COL), COS_MAX, dt, k,
        jnp.asarray(amb)))(jnp.asarray(cam), jnp.asarray(d), jnp.asarray(dith))
    to = ta.clouds_scattering(tc, _tv(cam), _tv(d), SUN, COL, COS_MAX,
                              torch.from_numpy(dith), kk, amb)
    for a, b in ((_pk(to[0]), jo[0]), (to[1], jo[1]), (to[2], jo[2])):
        assert _share_close(a, b) > 0.95, _share_close(a, b)
    # a batch of two keys equals the two runs alone
    kb = (torch.tensor([kk[0], 11]), torch.tensor([kk[1], 22]))
    d2 = np.stack([d, d[::-1]])
    bs, bt = ta.atmospheric_scattering(tc, _tv(np.broadcast_to(cam, d2.shape)),
                                       _tv(d2), SUN, COL, COS_MAX, kb)
    np.testing.assert_array_equal(_pk(bs)[0], _pk(ts))
    np.testing.assert_array_equal(_pk(bt)[0], _pk(tt))


# --- the oracle's checks (tests/test_oracle_sky.py) on the port ----------------


def test_port_matches_float64_oracle(tmp_path):
    F = np.float64
    sun_dir, sun_col = osky.SUN_DIR, osky.SUN_COL
    # sun_transmittance against the 512-step float64 truth
    rng = np.random.default_rng(3)
    hs = np.array([1e3, 1e3, 5e3, 2.1e3, 30e3, 1e3, 1.5e3, 80e3])
    pos = np.zeros((hs.size, 3), F)
    pos[:, 1] = osky.PLANET_R + hs
    d = osky._test_dirs(hs.size)
    d[:, 1] = np.abs(d[:, 1]) * (0.15 + 0.85 * rng.random(hs.size))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    truth = osky.o_sun_transmittance(pos, d, steps=512)
    assert np.abs(_pk(ta.sun_transmittance(_tv(pos), _tv(d)))
                  - truth).max() < 0.015
    # atmospheric_scattering, sun cone collapsed
    jcfg = osky._cfg()
    cfg = TCfg(**{f.name: getattr(jcfg, f.name)
                  for f in dataclasses.fields(jcfg)})
    d = osky._test_dirs(8)
    pos = np.broadcast_to(osky.CAM_POS, d.shape).copy()
    osc, otr = osky.o_atmospheric_scattering(
        pos, d, sun_dir, sun_col, steps=cfg.sky_steps,
        n_ms=cfg.sky_ms_samples, ms_steps=cfg.sky_ms_steps)
    gsc, gtr = ta.atmospheric_scattering(cfg, _tv(pos), _tv(d), sun_dir,
                                         sun_col, 1.0, prng.key(0))
    assert np.abs(_pk(gsc) - osc).max() < 0.01 * np.abs(osc).max()
    assert np.abs(_pk(gtr) - otr).max() < 0.01
    # the cloud march, fixed dither, shared texture data
    tex = osky._bake_cloud_tex()
    d = osky._test_dirs(8, seed=11)
    d[:, 1] = np.abs(d[:, 1]) + 0.08
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    dither = np.full((8,), 0.37, F)
    ambient = np.array([0.02, 0.03, 0.05], F)
    osc, otr, odist = osky.o_clouds_scattering(
        pos, d, sun_dir, sun_col, dither, ambient, steps=cfg.cloud_steps,
        shadow_steps=cfg.cloud_shadow_steps, tex=tex)
    gsc, gtr, gdist = ta.clouds_scattering(
        cfg, _tv(pos), _tv(d), sun_dir, sun_col, 1.0,
        torch.from_numpy(dither.astype(np.float32)), prng.key(0), ambient,
        tex=tex)
    assert np.abs(_pk(gsc) - osc).max() < 0.01 * max(np.abs(osc).max(), 1e-6)
    assert np.abs(gtr.numpy() - otr).max() < 0.01
    assert np.abs(gdist.numpy() - odist).max() < 0.01 * np.abs(odist).max()
    # end to end: prepare_sky's maps against the oracle composite, with the
    # quantile bars of test_prepare_sky_composite_matches_oracle
    sky = ta.prepare_sky(cfg, sun_dir.astype(np.float32),
                         sun_col.astype(np.float32), 1.0, quiet=True,
                         cache_dir=str(tmp_path), cloud_tex=tex,
                         device="cpu")
    n = cfg.skybox_res ** 2
    dirs = _pk(ta._texel_dirs(cfg, 0, n, "cpu")).astype(F)
    pos = np.broadcast_to(osky.CAM_POS, dirs.shape).copy()
    amb = osky.o_atmospheric_scattering(
        (osky.CAM_POS + np.array([0.0, osky.CLOUD_HEIGHT, 0.0]))[None],
        np.array([[0.0, 1.0, 0.0]], F), sun_dir, sun_col, cfg.sky_steps,
        cfg.sky_ms_samples, cfg.sky_ms_steps)[0][0]
    kc = prng.fold_in(prng.key(1234), 1000)
    acc_s, acc_t, acc_d = np.zeros((n, 3), F), np.zeros(n, F), np.zeros(n, F)
    passes = cfg.cloud_accum_passes
    for p in range(passes):
        kp = prng.fold_in(prng.fold_in(kc, 1), p)
        dith = prng.uniform(prng.fold_in(kp, 1), (n,), "cpu").numpy().astype(F)
        s, t, dist = osky.o_clouds_scattering(
            pos, dirs, sun_dir, sun_col, dith, amb, steps=cfg.cloud_steps,
            shadow_steps=cfg.cloud_shadow_steps, tex=tex)
        acc_s += s * 1.2 / passes
        acc_t += np.clip(t, 0.0, 1.0) / passes
        acc_d += dist / passes
    sky_s, sky_t = osky.o_atmospheric_scattering(
        pos, dirs, sun_dir, sun_col, cfg.sky_steps, cfg.sky_ms_samples,
        cfg.sky_ms_steps)
    fc_s, fc_t = osky.o_atmospheric_scattering(
        pos + dirs * np.maximum(acc_d, 0.0)[..., None], dirs, sun_dir,
        sun_col, cfg.sky_steps, cfg.sky_ms_samples, cfg.sky_ms_steps)
    t2c = sky_t / np.maximum(fc_t, 1e-20)
    in_scatt = sky_s - fc_s * np.clip(
        t2c * np.maximum(1.0 - acc_t, 0.0)[..., None], 0.0, 1.0)
    in_scatt = in_scatt + acc_s * np.clip(t2c, 0.0, 1.0)
    out_trans = sky_t * acc_t[..., None]
    err_s = np.abs(sky.skybox_scattering.reshape(n, 3) - in_scatt) / np.abs(
        in_scatt).max()
    err_t = np.abs(sky.skybox_transmittance.reshape(n, 3) - out_trans)
    assert np.quantile(err_s, 0.98) < 0.015 and err_s.max() < 0.05
    assert np.quantile(err_t, 0.98) < 0.015 and err_t.max() < 0.05


# --- prepare_sky as a whole, and the shared cache ---------------------------------


def _texel_share(tsky, jsky):
    ok = np.isclose(tsky.skybox_scattering, np.asarray(jsky.skybox_scattering),
                    rtol=RTOL, atol=ATOL).all(-1)
    ok &= np.isclose(tsky.skybox_transmittance,
                     np.asarray(jsky.skybox_transmittance), rtol=RTOL,
                     atol=ATOL).all(-1)
    return float(ok.mean())


def _rel_rmse(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2)) / np.abs(b).mean())


PROD_SKY = {f: getattr(testing.production_test_config(), f) for f in TINY_SKY}


@pytest.mark.parametrize("knobs,with_tex", [
    (PROD_SKY, False), (PROD_SKY, True), (TINY_SKY, False), (TINY_SKY, True),
], ids=["production_test", "production_test_tex", "tiny", "tiny_tex"])
def test_prepare_sky_matches_jax(knobs, with_tex, tmp_path, monkeypatch):
    # three chunks per tensor op: the batched form with a ragged last group
    monkeypatch.setattr(ta, "_chunks_per_batch", lambda *a: 3)
    jc, tc = _cfgs(**knobs)
    tex = None
    if with_tex:
        # a smooth texture, as a painted or photographed one is
        g = np.arange(256, dtype=np.float32) * np.float32(2 * np.pi / 256)
        wave = 0.5 + 0.5 * np.sin(3 * g)[:, None] * np.cos(2 * g)[None, :]
        tex = np.stack([wave, wave.T, np.sqrt(wave)], -1).astype(np.float32)
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jsky = ja.prepare_sky(jc, SUN, COL, COS_MAX, quiet=True, cache_dir=jdir,
                          cloud_tex=tex)
    stats = {}
    tsky = ta.prepare_sky(tc, SUN, COL, COS_MAX, quiet=True, cache_dir=tdir,
                          cloud_tex=tex, stats=stats, device="cpu")
    assert stats["chunks_per_batch"] == 3
    assert not stats["cache_hit"] and stats["sky_s"] > 0
    res = tc.skybox_res
    assert tsky.skybox_scattering.shape == (res, res, 3)
    assert np.isfinite(tsky.skybox_scattering).all()
    assert np.isfinite(tsky.skybox_transmittance).all()
    _close(tsky.cloud_ambient, jsky.cloud_ambient, atol=1e-6)
    _close(tsky.trans_lut, jsky.trans_lut, atol=2e-6)
    share = _texel_share(tsky, jsky)
    rs = _rel_rmse(tsky.skybox_scattering, jsky.skybox_scattering)
    rt = _rel_rmse(tsky.skybox_transmittance, jsky.skybox_transmittance)
    print(f"prepare_sky {knobs['skybox_res']}^2 tex={with_tex}: {share:.4f} of "
          f"texels within rtol {RTOL} / atol {ATOL}; relative RMSE "
          f"scattering {rs:.2e}, transmittance {rt:.2e}")
    assert share >= 0.95, share
    assert rs < 6e-2 and rt < 1.5e-2, (rs, rt)
    # both packages key the file alike, and each loads the other's
    assert os.listdir(jdir) == os.listdir(tdir)
    stats = {}
    from_j = ta.prepare_sky(tc, SUN, COL, COS_MAX, quiet=True, cache_dir=jdir,
                            cloud_tex=tex, stats=stats, device="cpu")
    assert stats["cache_hit"]
    np.testing.assert_array_equal(from_j.skybox_scattering,
                                  np.asarray(jsky.skybox_scattering))
    from_t = ja.prepare_sky(jc, SUN, COL, COS_MAX, quiet=True, cache_dir=tdir,
                            cloud_tex=tex)
    np.testing.assert_array_equal(np.asarray(from_t.skybox_transmittance),
                                  tsky.skybox_transmittance)
    from voxelrt.ops.texfetch import pack_rgb_bf16 as jpack

    np.testing.assert_array_equal(
        jpack(tsky.skybox_scattering).view(np.int32),
        tsky.packed_scatt.numpy())


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host with "
                    "no CUDA card")
def test_sky_entry_points_default_to_the_card(tmp_path):
    """With no device named the precompute runs on the CUDA card, and raises
    where there is none: no quiet run on the CPU."""
    _, tc = _cfgs(**TINY_SKY)
    with pytest.raises(RuntimeError, match="CUDA"):
        ta.prepare_sky(tc, SUN, COL, COS_MAX, quiet=True,
                       cache_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        ta.generate_transmittance_lut()
    with pytest.raises(RuntimeError, match="CUDA"):
        ta.cloud_table()
    assert not os.listdir(tmp_path)


def test_prepare_sky_clear_sky_part_matches_jax(tmp_path):
    """With ``use_clouds=False`` the scattering map has no cloud term: it
    is held at 99% of texels, the rest lying on the horizon. (The
    transmittance map still carries the cloud transmittance, as in the
    reference.)"""
    jc, tc = _cfgs(**TINY_SKY)
    jc = dataclasses.replace(jc, use_clouds=False)
    tc = dataclasses.replace(tc, use_clouds=False)
    jsky = ja.prepare_sky(jc, SUN, COL, COS_MAX, quiet=True,
                          cache_dir=str(tmp_path / "j"))
    tsky = ta.prepare_sky(tc, SUN, COL, COS_MAX, quiet=True,
                          cache_dir=str(tmp_path / "t"), device="cpu")
    ok = np.isclose(tsky.skybox_scattering, np.asarray(jsky.skybox_scattering),
                    rtol=RTOL, atol=ATOL).all(-1)
    print(f"clear-sky scattering: {ok.mean():.4f} of texels within tolerance")
    assert ok.mean() >= 0.99, ok.mean()
    assert ta._cache_key(tc, SUN, COL, COS_MAX) == ja._cache_key(
        jc, SUN, COL, COS_MAX)
    tex = np.zeros((256, 256, 3), np.float32)
    assert len({ta._cache_key(tc, SUN, COL, COS_MAX, tex),
                ta._cache_key(tc, SUN, COL, COS_MAX, tex + 1),
                ta._cache_key(tc, SUN, COL, COS_MAX)}) == 3


# --- tests/test_sky.py's and the oracle's remaining checks, on the port ------------


def test_sky_unit_checks_on_port():
    """test_sky.py's rsi, density, phase-normalisation and
    quadrature-against-LUT checks with the port's functions, at its bars."""
    near, far = ta.rsi(_tv([[0.0, 5.0, 0.0], [0.0, 20.0, 0.0]]),
                       _tv([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0]]), 10.0)
    assert far[0].item() == pytest.approx(5.0)
    assert near[0].item() == pytest.approx(-15.0)
    assert near[1].item() == -1.0 and far[1].item() == -1.0
    d = torch.stack(ta.get_density(torch.tensor(
        [0.0, 8500.0, 25000.0, 100000.0])), -1).numpy()
    assert d[0, 0] == pytest.approx(1.0)
    assert d[1, 0] == pytest.approx(np.exp(-1.0), rel=1e-5)
    assert d[2, 2] > d[0, 2] and d[2, 2] > d[3, 2]
    mu = torch.from_numpy(np.random.default_rng(1).uniform(
        -1, 1, 200_000).astype(np.float32))
    for f in (ta.rayleigh_phase, lambda m: ta.mie_phase(m, 0.75)):
        assert f(mu).mean().item() * 4 * np.pi == pytest.approx(1.0, rel=0.02)
    lut = ta.generate_transmittance_lut("cpu")
    ct, h = (x.ravel() for x in torch.meshgrid(
        torch.tensor([0.02, 0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9,
                      0.95, 1.0]),
        torch.tensor([0.0, 500.0, 1000.0, 5000.0, 15000.0, 30000.0, 70000.0]),
        indexing="xy"))
    zero = torch.zeros_like(h)
    qa = _pk(ta.sun_transmittance(
        V3(zero, ta.PLANET_R + h, zero),
        V3(torch.sin(torch.acos(ct)), ct, zero)))
    err = np.abs(qa - ta.read_trans_lut(lut, ct, h).numpy())
    assert err.max() < 0.08 and err.mean() < 0.02, (err.max(), err.mean())


@pytest.mark.parametrize("fetch", ["stochastic", "bilinear"])
def test_sky_fetch_unbiased_on_port(fetch):
    """The oracle's unbiasedness check: the stochastic fetch (one corner
    through B2's twin, probability = bilinear weight) averages to the exact
    4-corner bilinear value; bar 0.03 at 4000 draws as in
    tests/test_oracle_sky.py, plus 0.4% for the bf16-packed words. The
    jittered bilinear fetch (B3's twin) is held the same way: its direction
    jitter of 0.0015 spans a small fraction of an 8x8 sky's texel."""
    res = 8
    rng = np.random.default_rng(5)
    scatt = rng.random((res, res, 3)).astype(np.float32)
    sky = ta.make_sky(scatt, rng.random((res, res, 3)).astype(np.float32),
                      np.zeros(3), np.zeros((256, 128, 3)), "cpu")
    cfg = TCfg(use_physical_sky=True, skybox_res=res, sky_fetch=fetch)
    d = osky._test_dirs(16, seed=9).astype(np.float32)
    u, v = ta.project_sky_soa(_tv(d), res)
    fx, fy = (u * res - 0.5).numpy(), (v * res - 0.5).numpy()
    ix, iy = np.floor(fx).astype(int), np.floor(fy).astype(int)
    gx, gy = (fx - ix)[:, None], (fy - iy)[:, None]

    def at(ax, ay):
        return scatt[np.mod(ax, res), np.mod(ay, res)].astype(np.float64)

    exact = ((at(ix, iy) * (1 - gx) + at(ix + 1, iy) * gx) * (1 - gy)
             + (at(ix, iy + 1) * (1 - gx) + at(ix + 1, iy + 1) * gx) * gy)
    m = 4000
    dd = np.tile(d, (m, 1))
    u3 = rng.random((m * 16, 3)).astype(np.float32)
    s, t = ta.sample_skybox(cfg, sky, _tv(dd), _tv(u3), want_trans=False)
    assert t is None
    mean = _pk(s).astype(np.float64).reshape(m, 16, 3).mean(0)
    assert np.abs(mean - exact).max() < 0.03 + 0.004
