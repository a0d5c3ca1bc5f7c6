"""PyTorch port, elementwise layer: counter-based RNG (draw for draw),
sampling/packing/transform/tonemap helpers, the Disney BSDF, the sky
projection and the B2/B3 texel-fetch twins, each against the JAX package on
the same numpy-seeded inputs.

Tolerances: integer and bit-level results (RNG, packing, texel words) must
be exact. Float results allow a few float32 ulps (rtol 1e-5, atol 1e-6),
because XLA's CPU sin/cos/acos/atan2/exp/pow and its fusion differ from
torch's in the last bit; where such a last-bit difference can flip a
discrete choice (a BSDF lobe) the test bounds the fraction of lanes that
disagree instead."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelrt.ops import bsdf as jbsdf
from voxelrt.ops import packing as jpack
from voxelrt.ops import sampling as jsamp
from voxelrt.ops import texfetch as jtf
from voxelrt.ops import tonemap as jtone
from voxelrt.ops import transforms as jtr
from voxelrt.ops.v3 import V3 as JV3
from voxelrt.render import pathtracer as jpt
from voxelrt.sky import atmos as jatmos

from voxelrt_torch.config import RenderConfig as TCfg
from voxelrt_torch.ops import bsdf as tbsdf
from voxelrt_torch.ops import packing as tpack
from voxelrt_torch.ops import prng
from voxelrt_torch.ops import sampling as tsamp
from voxelrt_torch.ops import texfetch as ttf
from voxelrt_torch.ops import tonemap as ttone
from voxelrt_torch.ops import transforms as ttr
from voxelrt_torch.ops.v3 import V3 as TV3
from voxelrt_torch.render import pathtracer as tpt
from voxelrt_torch.sky import atmos as tatmos

from test_torch_b3_dirs import _dirs as _b3_dirs

# One thread per test process: the suite runs several processes side by
# side, and the tensors here are small.
torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6


def _both(a):
    a = np.ascontiguousarray(a)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _v3(a):
    """(N, 3) numpy -> (JAX V3, torch V3)."""
    cols = [_both(a[:, i].astype(np.float32)) for i in range(3)]
    return JV3(*(c[0] for c in cols)), TV3(*(c[1] for c in cols))


def _unit(rng, n):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def _close(j, t, rtol=RTOL, atol=ATOL):
    if isinstance(t, TV3):
        for a, b in zip(j, t):
            _close(a, b, rtol, atol)
        return
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol,
                               atol=atol)


# --- RNG ---------------------------------------------------------------------


def test_prng_key_and_fold_in_match():
    rng = np.random.default_rng(0)
    for seed in (0, 1, 42, 2**31 - 1, 2**32 - 1):
        assert prng.key(seed) == tuple(int(x) for x in
                                       np.asarray(jax.random.PRNGKey(seed)))
    keys = rng.integers(0, 2**32, (8, 2), dtype=np.uint64).astype(np.uint32)
    for k in keys:
        kk = (int(k[0]), int(k[1]))
        for data in (0, 1, 417, 7003, int(rng.integers(0, 2**31))):
            want = np.asarray(jax.random.fold_in(jnp.asarray(k), data))
            assert prng.fold_in(kk, data) == tuple(int(x) for x in want)
    pid = rng.integers(0, 1280 * 720, 4096).astype(np.int32)
    want = np.asarray(jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        jnp.asarray(keys[0]), jnp.asarray(pid)))
    got = prng.fold_in((int(keys[0][0]), int(keys[0][1])),
                       torch.from_numpy(pid))
    np.testing.assert_array_equal(got[0].numpy(), want[:, 0])
    np.testing.assert_array_equal(got[1].numpy(), want[:, 1])


@pytest.mark.parametrize("n", [1, 2, 3, 1000])
def test_prng_uniform_matches(n):
    for seed in range(6):
        k = jax.random.fold_in(jax.random.PRNGKey(seed), 417)
        want = np.asarray(jax.random.uniform(k, (n,)))
        got = prng.uniform(tuple(int(x) for x in np.asarray(k)), n, "cpu")
        np.testing.assert_array_equal(got, want)


def test_pcg3d_draw_slots_match():
    rng = np.random.default_rng(1)
    k0 = rng.integers(0, 2**32, 2048, dtype=np.uint64).astype(np.uint32)
    k1 = rng.integers(0, 2**32, 2048, dtype=np.uint64).astype(np.uint32)
    jd = jpt._Pcg3dDraws(jnp.asarray(k0), jnp.asarray(k1))
    td = tpt.Pcg3dDraws(torch.from_numpy(k0.astype(np.int64)),
                        torch.from_numpy(k1.astype(np.int64)))
    for slot in range(33):
        np.testing.assert_array_equal(td[slot].numpy(), np.asarray(jd[slot]))
    a, b, c = jsamp.pcg3d(jnp.asarray(k0), jnp.asarray(k1), jnp.asarray(k0))
    ta, tb, tc = tsamp.pcg3d(*(torch.from_numpy(x.astype(np.int64))
                               for x in (k0, k1, k0)))
    for j, t in ((a, ta), (b, tb), (c, tc)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


# --- elementwise helpers ------------------------------------------------------


def test_sampling_helpers_match():
    rng = np.random.default_rng(2)
    n = 4096
    jn, tn = _v3(_unit(rng, n))
    jv, tv = _v3(_unit(rng, n))
    u0, u1 = (_both(rng.random(n).astype(np.float32)) for _ in range(2))
    cos_max = np.float32(np.cos(0.02))
    _close(jsamp.make_orthonormal_basis(jn)[0],
           tsamp.make_orthonormal_basis(tn)[0])
    _close(jsamp.make_orthonormal_basis(jn)[1],
           tsamp.make_orthonormal_basis(tn)[1])
    _close(jsamp.sample_cosine_weighted_hemisphere(jn, (u0[0], u1[0])),
           tsamp.sample_cosine_weighted_hemisphere(tn, (u0[1], u1[1])))
    _close(jsamp.sample_cone_oriented(jnp.float32(cos_max), jn, (u0[0], u1[0])),
           tsamp.sample_cone_oriented(torch.tensor(cos_max), tn,
                                      (u0[1], u1[1])))
    _close(jsamp.reflect(jv, jn), tsamp.reflect(tv, tn))
    _close(jsamp.luminance(jv), tsamp.luminance(tv))
    _close(jsamp.power_heuristic(u0[0], u1[0]),
           tsamp.power_heuristic(u0[1], u1[1]))
    cth = rng.uniform(0.99, 1.0, n).astype(np.float32)
    _close(jsamp.cone_sample_pdf(jnp.float32(cos_max), jnp.asarray(cth)),
           tsamp.cone_sample_pdf(torch.tensor(cos_max), torch.from_numpy(cth)))
    bits = rng.integers(0, 2**32, n, dtype=np.uint64)
    np.testing.assert_array_equal(
        tsamp.u32_to_uniform(torch.from_numpy(bits.astype(np.int64))).numpy(),
        np.asarray(jsamp.u32_to_uniform(jnp.asarray(bits.astype(np.uint32)))))


def test_packing_transforms_tonemap_match():
    rng = np.random.default_rng(3)
    n = 4096
    jn, tn = _v3(_unit(rng, n))
    jx, tx = jpack.encode_unit_vector_3x16_soa(jn)
    ux, uy = tpack.encode_unit_vector_3x16_soa(tn)
    np.testing.assert_array_equal(ux.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(uy.numpy(), np.asarray(tx))
    enc = np.stack([np.asarray(jx), np.asarray(tx)], -1)
    _close(jpack.decode_unit_vector_3x16(jnp.asarray(enc)),
           tpack.decode_unit_vector_3x16(torch.from_numpy(enc)))
    mat = rng.integers(0, 256, n).astype(np.int32)
    alb = rng.random((n, 3)).astype(np.float32)
    ja, ta = _v3(alb)
    word = np.asarray(jpack.encode_material_soa(jnp.asarray(mat), ja))
    tword = tpack.encode_material_soa(torch.from_numpy(mat), ta)
    np.testing.assert_array_equal(tword.numpy(), word.astype(np.int64))
    jm, jalb = jpack.decode_material_word_soa(jnp.asarray(word))
    tm, talb = tpack.decode_material_word_soa(tword)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    _close(jalb, talb, 0, 0)

    proj = np.linalg.inv(np.random.default_rng(4).normal(
        size=(4, 4)).astype(np.float32)).astype(np.float32)
    jp, tp = _both(proj)
    su, sv = (_both(rng.random(n).astype(np.float32)) for _ in range(2))
    _close(jtr.screen_to_view_soa(su[0], sv[0], 1.0, jp),
           ttr.screen_to_view_soa(su[1], sv[1], 1.0, tp), 1e-4, 1e-5)
    _close(jtr.view_to_world_soa(jn, jp, 0.0),
           ttr.view_to_world_soa(tn, tp, 0.0))
    _close(jtr.view_to_screen_z_soa(jn, jp), ttr.view_to_screen_z_soa(tn, tp),
           1e-4, 1e-5)
    depth = rng.random((8, 4)).astype(np.float32)
    _close(jtr.linearize_depth(jnp.asarray(depth), jp),
           ttr.linearize_depth(torch.from_numpy(depth), tp))

    hdr = (rng.random((32, 16, 3)) * 4.0).astype(np.float32)
    _close(jtone.uchimura(jnp.asarray(hdr)), ttone.uchimura(
        torch.from_numpy(hdr)))
    cfg = TCfg(image_res=(32, 16))
    _close(jtone.render_to_image(jnp.asarray(hdr), cfg, jnp.float32(2.0), 1.0),
           ttone.render_to_image(torch.from_numpy(hdr), cfg, 2.0, 1.0))


# --- BSDF --------------------------------------------------------------------


def _materials(rng, n):
    """Random Disney materials, as (JAX Material, torch Material)."""
    from voxelrt.materials import Material as JM

    from voxelrt_torch.materials import Material as TM

    jb, tb = _v3(rng.random((n, 3)))
    fields = {f: rng.random(n).astype(np.float32) for f in JM._fields[1:]}
    fields["roughness"] = rng.uniform(0.05, 1.0, n).astype(np.float32)
    return (JM(jb, **{k: jnp.asarray(v) for k, v in fields.items()}),
            TM(tb, **{k: torch.from_numpy(v) for k, v in fields.items()}))


@pytest.mark.parametrize("feat", [(True,) * 5, (False, True, False, False,
                                                False)])
def test_bsdf_matches(feat):
    rng = np.random.default_rng(5)
    n = 8192
    jm, tm = _materials(rng, n)
    nrm = _unit(rng, n)
    v = _unit(rng, n)
    v = np.where(((v * nrm).sum(1) < 0)[:, None], -v, v)
    jn, tn = _v3(nrm)
    jv, tv = _v3(v)
    jl, tl = _v3(_unit(rng, n))
    jt, jbt = jsamp.make_orthonormal_basis(jn)
    tt, tbt = tsamp.make_orthonormal_basis(tn)
    jf, tf = jbsdf.MatFeatures(*feat), tbsdf.MatFeatures(*feat)

    jd, js, jp = jbsdf.disney_eval_split_pdf(jm, jv, jn, jl, jt, jbt, jf)
    td, ts, tp = tbsdf.disney_eval_split_pdf(tm, tv, tn, tl, tt, tbt, tf)
    _close(jd, td, 1e-4, 1e-6)
    _close(js, ts, 1e-4, 1e-6)
    _close(jp, tp, 1e-4, 1e-6)

    us = [rng.random(n).astype(np.float32) for _ in range(3)]
    j3 = tuple(jnp.asarray(u) for u in us)
    t3 = tuple(torch.from_numpy(u) for u in us)
    jdir, jbrdf, jpdf, jlobe = jbsdf.sample_disney(jm, jv, jn, jt, jbt, j3, jf)
    tdir, tbrdf, tpdf, tlobe = tbsdf.sample_disney(tm, tv, tn, tt, tbt, t3, tf)
    same_lobe = tlobe.numpy() == np.asarray(jlobe)
    assert same_lobe.mean() > 0.999
    ok = same_lobe.copy()
    for j, t, tol in ((jdir, tdir, 1e-3), (jbrdf, tbrdf, 1e-3)):
        for a, b in zip(j, t):
            a, b = np.asarray(a), b.numpy()
            ok &= np.abs(a - b) <= tol * (1.0 + np.abs(a))
    pa, pb = np.asarray(jpdf), tpdf.numpy()
    ok &= np.abs(pa - pb) <= 1e-3 * (1.0 + np.abs(pa))
    # single lanes near a grazing or degenerate configuration can amplify
    # a last-bit difference; hold the bulk exact to 1e-3
    assert ok.mean() > 0.995, ok.mean()


# --- sky projection + texel fetches (B2/B3 twins) ----------------------------


def _packed_map(rng, res):
    img = rng.random((res, res, 3)).astype(np.float32)
    words = jtf.pack_rgb_bf16(img)
    np.testing.assert_array_equal(ttf.pack_rgb_bf16(img), words)
    return img, words


def test_b2_point_fetch_twin_matches_pallas():
    rng = np.random.default_rng(6)
    res = 64
    _, words = _packed_map(rng, res)
    wid = (rng.integers(0, res * res, 3000) * 2).astype(np.int32)
    jw0, jw1 = jtf.point_fetch_words(jnp.asarray(words), jnp.asarray(wid),
                                     interpret=True)
    tw = torch.from_numpy(words.view(np.int32).copy())
    tw0, tw1 = ttf.point_fetch_words(tw, torch.from_numpy(wid))
    np.testing.assert_array_equal(tw0.numpy(), np.asarray(jw0))
    np.testing.assert_array_equal(tw1.numpy(), np.asarray(jw1))
    r, g, b = ttf.unpack_words_rgb_soa(tw0, tw1)
    for a, c in zip((r, g, b), jtf.unpack_words_rgb_soa(jw0, jw1)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))


@pytest.mark.parametrize("n", [1, 3000])
def test_b3_bilinear_twin_matches_pallas_and_reference(n):
    """B3's twin against the Pallas kernel (interpret mode) and against the
    reference formulation atmos._bilinear_wrap on the bf16-decoded map."""
    rng = np.random.default_rng(7 + n)
    res = 64
    img, words = _packed_map(rng, res)
    fx = rng.uniform(-3, res + 3, n).astype(np.float32)
    fy = rng.uniform(-3, res + 3, n).astype(np.float32)
    if n > 1:
        fx[:4] = [np.nan, np.inf, -np.inf, 1e9]
    want = np.asarray(jtf.bilinear_fetch_packed(
        jnp.asarray(words), jnp.asarray(fx), jnp.asarray(fy), res,
        interpret=True))
    got = ttf.bilinear_fetch_packed(torch.from_numpy(words.view(np.int32)
                                                     .copy()),
                                    torch.from_numpy(fx), torch.from_numpy(fy),
                                    res).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    dec = np.stack(jtf.unpack_words_rgb_soa(
        jnp.asarray(words[0::2].view(np.int32)),
        jnp.asarray(words[1::2].view(np.int32))), -1)
    dec = np.asarray(dec)[: res * res].reshape(res, res, 3)
    fin = np.isfinite(fx) & (np.abs(fx) < 1e6)
    ref = np.asarray(jatmos._bilinear_wrap(jnp.asarray(dec),
                                           jnp.asarray(fx[fin]),
                                           jnp.asarray(fy[fin]), res))
    np.testing.assert_allclose(got[fin], ref, rtol=1e-5, atol=1e-6)
    tref = tatmos._bilinear_wrap(torch.from_numpy(dec), torch.from_numpy(
        fx[fin]), torch.from_numpy(fy[fin]), res).numpy()
    np.testing.assert_allclose(tref, ref, rtol=1e-6, atol=1e-7)


def test_sky_projection_and_stochastic_fetch_match():
    from voxelrt.config import RenderConfig as JCfg

    rng = np.random.default_rng(8)
    res = 64
    n = 4096
    scatt, ws = _packed_map(rng, res)
    trans, wt = _packed_map(rng, res)
    jd, td = _v3(_unit(rng, n))
    ju, tu = _v3(rng.random((n, 3)))
    ju_, jv_ = jatmos.project_sky_soa(jd, res)
    tu_, tv_ = tatmos.project_sky_soa(td, res)
    _close(ju_, tu_, 1e-5, 1e-6)
    _close(jv_, tv_, 1e-5, 1e-6)
    dirs = _unit(rng, n).astype(np.float32)
    _close(jatmos.project_sky(jnp.asarray(dirs), res),
           tatmos.project_sky(torch.from_numpy(dirs), res), 1e-5, 1e-6)
    jsky =jatmos.SkyData(jnp.asarray(scatt), jnp.asarray(trans),
                          jnp.zeros(3), jnp.zeros((1, 1, 3)),
                          jnp.asarray(ws), jnp.asarray(wt))
    tsky = tatmos.make_sky(scatt, trans, np.zeros(3), np.zeros((1, 1, 3)),
                           "cpu")
    jcfg = JCfg(skybox_res=res, use_physical_sky=True, use_pallas_dda=True,
                pallas_interpret=True)
    tcfg = TCfg(skybox_res=res, use_physical_sky=True)
    js, jt = jatmos.sample_skybox(jcfg, jsky, jd, ju, scattered=True)
    ts, tt = tatmos.sample_skybox(tcfg, tsky, td, tu)
    # identical texels except where a last-ulp projection difference moves
    # a stochastic corner pick
    same = np.ones(n, bool)
    for a, b in zip((*js, *jt), (*ts, *tt)):
        same &= np.asarray(a) == b.numpy()
    assert same.mean() > 0.998, same.mean()
    # bilinear lookups: a last-ulp projection difference (acos/atan2, whose
    # derivatives blow up toward the poles) times a random map's texel-to-
    # texel gradient; all lanes within 1e-3, 99% within 1e-5
    jtr_ = jatmos.sample_skybox_transmittance(jcfg, jsky, jd)
    ttr_ = tatmos.sample_skybox_transmittance(tcfg, tsky, td)
    _close(jtr_, ttr_, 1e-3, 1e-6)
    tight = np.ones(n, bool)
    for a, b in zip(jtr_, ttr_):
        tight &= np.isclose(b.numpy(), np.asarray(a), rtol=1e-5, atol=1e-6)
    assert tight.mean() > 0.99, tight.mean()


# --- the kernels themselves (need the card) ----------------------------------


@pytest.mark.cuda
def test_b2_b3_kernels_match_twins_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: B2/B3 are CUDA kernels")
    rng = np.random.default_rng(9)
    res = 1024
    _, words = _packed_map(rng, res)
    dev = torch.device("cuda")
    tw = torch.from_numpy(words.view(np.int32).copy()).to(dev)
    wid = torch.from_numpy((rng.integers(0, res * res, 100_000) * 2).astype(
        np.int32)).to(dev)
    for a, b in zip(ttf.point_fetch_words(tw, wid),
                    ttf.point_fetch_words_plain(tw, wid)):
        assert torch.equal(a, b)
    fx = torch.from_numpy(rng.uniform(-3, res + 3, 100_000).astype(
        np.float32)).to(dev)
    fy = torch.from_numpy(rng.uniform(-3, res + 3, 100_000).astype(
        np.float32)).to(dev)
    a = ttf.bilinear_fetch_packed(tw, fx, fy, res)
    b = ttf.bilinear_fetch_packed_plain(tw, fx, fy, res)
    assert torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))
    # B3's direction entries, each kernel bit for bit against its twin, on
    # strided column views with the edge-case directions first (the jitter's
    # NaN and infinite uniforms among them), and on a one-lane view of a
    # (1, 3) tensor
    _, words_t = _packed_map(rng, res)
    tt = torch.from_numpy(words_t.view(np.int32).copy()).to(dev)
    d_np, u_np = _b3_dirs(rng, 100_000)
    d = torch.from_numpy(d_np).to(dev)
    u = torch.from_numpy(u_np).to(dev)
    dv = TV3(d[:, 0], d[:, 1], d[:, 2])
    uv = TV3(u[:, 0], u[:, 1], u[:, 2])
    one = torch.tensor([[0.3, 0.8, -0.2]], device=dev)
    d1 = TV3(one[..., 0], one[..., 1], one[..., 2])
    pairs = [(ttf.bilinear_fetch_dirs(w, dv, res, u3),
              ttf.bilinear_fetch_dirs_plain(w, dv, res, u3))
             for w in (tw, tt) for u3 in (None, uv)]
    pairs.append((ttf.bilinear_fetch_dirs(tt, d1, res),
                  ttf.bilinear_fetch_dirs_plain(tt, d1, res)))
    pairs += list(zip(
        ttf.bilinear_fetch_dirs2(tw, tt, ttf.interleave_words(tw, tt), dv,
                                 res, uv),
        ttf.bilinear_fetch_dirs2_plain(tw, tt, dv, res, uv)))
    for a, b in pairs:
        assert torch.equal(a.contiguous().view(torch.int32),
                           b.contiguous().view(torch.int32))
