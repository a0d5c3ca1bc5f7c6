"""PyTorch port, ReSTIR-PT against the JAX package: the BSDF evaluations and
pdfs the shift map uses, the integer hash and u32 packing of the storage
reservoir, ``trace_sample``'s input reservoirs, and the spatial GRIS pass
fed the JAX package's own reservoir images and G-buffer through
``voxelrt_torch.interop``, under ``app/testing.production_test_config``
(Pallas kernels in interpret mode, physical sky + clouds, a sun).

Bars. The BSDF values: 99.9% of lanes within 1e-4 relative, the BSDF bar
of tests/test_torch_ops.py, and every lane within 1e-3 (XLA's CPU pow, exp
and log against torch's: on 8,192 random lanes one value of
``disney_evaluate_split`` lies 2e-4 apart); the hash, the u32 packs and the integer reservoir fields
exact. ``trace_sample``: at least 99% of lanes within 1e-4
relative on every image output and every reservoir field, the bar of the
port's other ``trace_sample`` tests. GRIS: at least 99% of pixels within
1e-4 relative. Its weighted reservoir selections (``u * w_sum <= w``) flip
where a last-bit difference moves a product across the uniform, so the bars
are shares of lanes, not maximum errors. The bias test of
tests/test_render.py::test_restir_matches_plain_mean keeps its own bar: the
port's ReSTIR mean within 5% of the port's plain mean (the JAX package's
measured residual is about 1%).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelrt.app import testing
from voxelrt.ops import bsdf as jbsdf
from voxelrt.ops import packing as jpack
from voxelrt.ops import sampling as jsamp
from voxelrt.render import pathtracer as jpt
from voxelrt.render import pipeline as jpl
from voxelrt.render import restir as jrs

from voxelrt_torch import interop
from voxelrt_torch.config import RenderConfig as TCfg
from voxelrt_torch.ops import bsdf as tbsdf
from voxelrt_torch.ops import packing as tpack
from voxelrt_torch.ops import prng
from voxelrt_torch.ops import sampling as tsamp
from voxelrt_torch.render import pathtracer as tpt
from voxelrt_torch.render import pipeline as tpl
from voxelrt_torch.render import restir as trs

from test_torch_ops import _materials, _unit, _v3
from test_torch_render import _np, _pack, build_both

# One thread per test process: the suite runs several processes side by
# side, and the tensors here are small.
torch.set_num_threads(1)

BSDF_FNS = ("disney_evaluate_split", "disney_evaluate",
            "disney_evaluate_lobewise_split", "disney_evaluate_lobewise",
            "pdf_diffuse", "pdf_clearcoat", "pdf_specular",
            "pdf_disney_lobewise", "pdf_disney")


@pytest.mark.parametrize("name", BSDF_FNS)
def test_bsdf_evaluations_match(name):
    rng = np.random.default_rng(11)
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
    lobes = rng.choice(np.array([0, 1, 2, 9], np.int32), n)
    args = {"pdf_diffuse": ((jm, jn, jl), (tm, tn, tl)),
            "pdf_clearcoat": ((jm, jv, jn, jl), (tm, tv, tn, tl))}.get(
        name, ((jm, jv, jn, jl, jt, jbt), (tm, tv, tn, tl, tt, tbt)))
    ja, ta = args
    if "lobewise" in name:
        ja = ja + (jnp.asarray(lobes),)
        ta = ta + (torch.from_numpy(lobes),)
    a = np.stack(_cols(getattr(jbsdf, name)(*ja)), -1)
    b = np.stack(_cols(getattr(tbsdf, name)(*ta)), -1)
    share = _share_close(a, b)
    worst = float((np.abs(a - b) / np.maximum(np.abs(a), 1e-2)).max())
    print(f"{name}: {share:.5f} of {n} lanes within 1e-4; worst relative "
          f"gap {worst:.2e}")
    assert share >= 0.999, share
    np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-6)


def _cols(x):
    """The (N,) components of a result: an array, a V3 or a tuple of them."""
    if isinstance(x, tuple):
        return [c for part in x for c in _cols(part)]
    return [np.asarray(x)]


def test_hash_and_packing_match():
    rng = np.random.default_rng(2)
    x, y, z = (rng.integers(0, 2 ** 32, 4096, dtype=np.uint64)
               for _ in range(3))
    j = np.asarray(jsamp.hash3(*(jnp.asarray(a.astype(np.uint32))
                                 for a in (x, y, z))))
    t = tsamp.hash3(*(torch.from_numpy(a.astype(np.int64))
                      for a in (x, y, z)))
    np.testing.assert_array_equal(t.numpy(), j.astype(np.int64))
    # the GRIS seed: small coordinates and a frame counter as a number
    t2 = tsamp.hash3(torch.arange(64), torch.arange(64) * 3, 9)
    j2 = jsamp.hash3(jnp.arange(64, dtype=jnp.uint32),
                     jnp.arange(64, dtype=jnp.uint32) * 3, jnp.uint32(9))
    np.testing.assert_array_equal(t2.numpy(),
                                  np.asarray(j2).astype(np.int64))

    data = rng.random((4096, 4)).astype(np.float32)
    data[:8] = [[0, 0, 0, 0], [1, 1, 1, 1], [0.5, 0.25, 1, 0]] + \
        [[0.998, 0.002, 0.5, 0.999]] * 5
    for sizes in ((8, 8, 8, 8), (10, 10, 10, 2)):
        je = np.asarray(jpack.encode_u32_arb(jnp.asarray(data), sizes))
        te = tpack.encode_u32_arb(torch.from_numpy(data), sizes)
        np.testing.assert_array_equal(te.numpy(), je.astype(np.int64))
        np.testing.assert_array_equal(
            tpack.decode_u32_arb(te, sizes).numpy(),
            np.asarray(jpack.decode_u32_arb(jnp.asarray(je), sizes)))


def _reservoir(rng, n):
    """A random reservoir dict (numpy), zero vectors among its directions
    (the escape/terminated/shadowed flags)."""
    res = {k: _unit(rng, n) * rng.uniform(0.5, 2.0, (n, 1)).astype(np.float32)
           for k in trs.FIELDS3}
    for k in ("rc_normal", "rc_incident_dir", "rc_NEE_dir"):
        res[k] = _unit(rng, n)
        res[k][rng.random(n) < 0.2] = 0.0
    res["rc_mat_info"] = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(
        np.uint32)
    res["cached_jacobian_term"] = rng.uniform(0, 1e5, n).astype(np.float32)
    res["lobes"] = rng.choice(np.array([0, 1, 2, 10, 12, 21, 99], np.int32),
                              n)
    res["M"] = rng.uniform(0, 40, n).astype(np.float32)
    res["weight"] = rng.uniform(0, 1e3, n).astype(np.float32)
    return res


def test_storage_quantization_matches():
    res = _reservoir(np.random.default_rng(4), 4096)
    j = jrs.encode_reservoir({k: jnp.asarray(a) for k, a in res.items()})
    t = trs.encode_reservoir(interop.reservoir_from_jax(res, "cpu"))
    for k in res:
        a, b = np.asarray(j[k]), t[k].numpy()
        if k in ("rc_mat_info", "lobes"):
            np.testing.assert_array_equal(b, a.astype(b.dtype), k)
        else:
            # the octahedral decode normalizes with XLA's rsqrt and torch's
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-7,
                                       err_msg=k)
    zero = np.all(res["rc_NEE_dir"] == 0, axis=1)
    assert zero.any() and (t["rc_NEE_dir"].numpy()[zero] == 0).all()


def _share_close(a, b, rtol=1e-4, atol=1e-6):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    ok = np.isclose(b, a, rtol=rtol, atol=atol)
    return ok.reshape(ok.shape[0], -1).all(-1).mean()


@pytest.fixture(scope="module")
def restir_both():
    cfg, sd, p, tcfg, tsd, tp = build_both()
    over = dict(use_restir_pt=True, restir_taps=8, restir_radius=6.0)
    return (dataclasses.replace(cfg, **over), sd, p,
            dataclasses.replace(tcfg, **over), tsd, tp)


@pytest.fixture(scope="module")
def traced(restir_both):
    """trace_sample with ReSTIR in both packages on the same pixels and
    key: (JAX outputs, port outputs)."""
    cfg, sd, p, tcfg, tsd, tp = restir_both
    u, v = jpl._pixel_grid(*cfg.image_res)
    jo = jax.jit(jpt.trace_sample, static_argnums=(0, 6, 7))(
        cfg, sd, p, jax.random.PRNGKey(3), u, v, False, 1.0)
    tu, tv, _ = tpl.wavefront_constants(tcfg, 1.0, "cpu")
    skeys, jit = tpl.sample_keys_of(prng.key(3), 1)
    to = tpt.trace_sample(tcfg, tsd, tp, tu, tv, skeys[0],
                          (jit[0][0], jit[0][1]))
    return jo, to


def test_trace_sample_reservoir_matches_jax(traced):
    jo, to = traced
    for name in ("diffuse", "specular"):
        a, b = _pack(jo[name]), torch.stack(list(to[name]), -1).numpy()
        share = _share_close(a, b)
        assert share >= 0.99, (name, share)
        assert np.abs(a).max() > (0.1 if name == "diffuse" else 1e-3)
    jr, tr = jo["reservoir"], to["reservoir"]
    assert set(tr) == set(jr)
    n = tr["M"].shape[0]
    for k in jr:
        a, b = np.asarray(jr[k]), tr[k].numpy()
        assert b.shape == a.shape, k
        if k in ("rc_mat_info", "lobes"):
            share = (b == a.astype(b.dtype)).mean()
        else:
            share = _share_close(a, b)
        print(f"reservoir {k}: {share:.5f} of {n} lanes within the bar")
        assert share >= 0.99, (k, share)
    # the sample paths are really there: escapes, rc vertices, NEE picks
    assert (tr["lobes"] == 99).any() and (tr["M"] == 2.0).any()
    assert (tr["rc_normal"].abs().sum(-1) > 0).sum() >= 10
    assert (tr["weight"] > 0).sum() >= 10


def _images(cfg, jo):
    """The render pass's image-space inputs of the GRIS pass, as the JAX
    package's accumulate forms them (numpy): reservoir images, colours,
    G-buffer."""
    w, h = cfg.image_res

    def img(x):
        if isinstance(x, tuple):
            x = _pack(x)
        return np.asarray(jpl._untile(w, h, jnp.asarray(x)))

    res = {k: img(x) for k, x in jo["reservoir"].items()}
    gbuf = dict(normals=img(jo["gbuff_normals"]),
                depth=img(jo["gbuff_depth"]), mat_id=img(jo["gbuff_mat_id"]))
    return res, img(jo["diffuse"]), img(jo["specular"]), gbuf


@pytest.mark.parametrize("moving", [False, True])
def test_spatial_gris_matches_jax(restir_both, traced, moving):
    """The GRIS pass alone: both packages get the JAX package's reservoir
    images, colours and G-buffer, frame 5, the same key."""
    cfg, sd, p, tcfg, tsd, tp = restir_both
    res, col, spec, gbuf = _images(cfg, traced[0])
    key = jax.random.fold_in(jax.random.PRNGKey(3), 7777)
    jc, js, (jin, jout) = jax.jit(jrs.spatial_gris,
                                  static_argnums=(0, 9, 10))(
        cfg, sd, p, {k: jnp.asarray(a) for k, a in res.items()},
        jnp.asarray(col), jnp.asarray(spec),
        {k: jnp.asarray(a) for k, a in gbuf.items()}, jnp.int32(5), key,
        moving, 1.0)
    tg = dict(normals=torch.tensor(gbuf["normals"]),
              depth=torch.tensor(gbuf["depth"]),
              mat_id=torch.from_numpy(gbuf["mat_id"].astype(np.int64)))
    tc, ts, (tin, tout) = trs.spatial_gris(
        tcfg, tsd, tp, interop.reservoir_from_jax(res, "cpu"),
        torch.tensor(col), torch.tensor(spec), tg, 5,
        prng.fold_in(prng.key(3), 7777), moving, 1.0)
    w, h = cfg.image_res
    for name, a, b in (("color", jc, tc), ("color_spec", js, ts)):
        a, b = np.asarray(a).reshape(w * h, 3), b.numpy().reshape(w * h, 3)
        share = _share_close(a, b)
        print(f"GRIS {name}: {share:.5f} of {w * h} pixels within the bar")
        assert share >= 0.99, (name, share)
        assert np.isfinite(b).all()
    for slot, (ja, ta) in (("input", (jin, tin)), ("output", (jout, tout))):
        for k in ja:
            a = np.asarray(ja[k]).reshape(w * h, -1)
            b = ta[k].numpy().reshape(w * h, -1)
            if k in ("rc_mat_info", "lobes"):
                share = (b == a.astype(b.dtype)).all(-1).mean()
            else:
                share = _share_close(a, b)
            assert share >= 0.99, (slot, k, share)
    # the weighted selections that went another way: the chosen sample's
    # reconnection vertex differs
    a = np.asarray(jout["rc_pos"]).reshape(-1, 3)
    b = tout["rc_pos"].numpy().reshape(-1, 3)
    flips = 1.0 - _share_close(a, b)
    print(f"GRIS WRS selections that differ: {flips:.5f} of {w * h} pixels")
    assert flips <= 0.01
    # the taps merged something: reservoirs gained samples
    assert (tout["M"].numpy() > res["M"].reshape(w, h)).mean() > 0.5


def test_restir_matches_plain_mean():
    """tests/test_render.py::test_restir_matches_plain_mean on the port:
    its scene (testing.tiny_config at 32x16), 96 samples, 4 taps of radius
    3; the port's ReSTIR mean within 5% of the port's plain mean."""
    jcfg = testing.tiny_config(image_res=(32, 16), use_pallas_dda=True)
    sd = testing.make_scene_data(jcfg)
    tsd, tp = interop.from_jax_arrays(
        dict(occ_words=np.asarray(sd.occ_words),
             voxels=np.asarray(sd.voxels),
             mat_params=np.asarray(sd.mat_params), tables=_np(sd.tables),
             sky=None), _np(testing.make_params(jcfg)), "cpu")
    cfg0 = TCfg(**{f.name: getattr(jcfg, f.name)
                   for f in dataclasses.fields(jcfg)})
    cfg1 = dataclasses.replace(cfg0, use_restir_pt=True, restir_taps=4,
                               restir_radius=3.0)
    means = []
    for cfg in (cfg0, cfg1):
        st = tpl.accumulate_n(cfg, tsd, tp, tpl.init_state(cfg, "cpu"),
                              prng.key(4), False, 1.0, 96)
        means.append(float(st.color.mean()))
    print(f"plain mean {means[0]:.6f}, ReSTIR mean {means[1]:.6f}, "
          f"relative gap {abs(means[1] / means[0] - 1.0):.4f}")
    assert means[1] == pytest.approx(means[0], rel=0.05), means
