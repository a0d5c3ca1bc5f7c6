"""PyTorch port, the slice as a whole: ``trace_sample`` per pixel and
``accumulate_n`` + ``fetch_image`` against the JAX package under
``app/testing.production_test_config`` (Pallas kernels in interpret mode,
queued wavefront + in-kernel NEE, physical sky + clouds at test knobs). Both
packages get the same scene through ``voxelrt_torch.interop``.

Tolerances: the per-pixel radiance may differ by float32 ulps (XLA's CPU
transcendentals and fusion vs torch's) and, rarely, by a flipped discrete
choice (a lobe, a hit, a texel); 99% of pixels must agree to 1e-4 relative.
Images are held to an RMSE of 1e-4, 150x tighter than the 0.015 golden-image
bar of tests/test_examples_golden.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelrt.app import testing
from voxelrt.render import pathtracer as jpt
from voxelrt.render import pipeline as jpl

from voxelrt_torch import interop
from voxelrt_torch.config import RenderConfig as TCfg
from voxelrt_torch.ops import prng
from voxelrt_torch.render import pathtracer as tpt
from voxelrt_torch.render import pipeline as tpl

# One thread per test process: the suite runs several processes side by
# side, and the tensors here are small.
torch.set_num_threads(1)


def _np(nt):
    return {k: (v if isinstance(v, int) else np.asarray(v))
            for k, v in nt._asdict().items()}


@pytest.fixture(scope="module")
def both():
    return build_both()


def build_both():
    """The production test scene in both packages: (JAX cfg, scene data,
    params, port cfg, scene data, params)."""
    cfg = testing.production_test_config()
    sd = testing.make_scene_data(cfg)
    p = testing.make_params(cfg)
    tsd, tp = interop.from_jax_arrays(
        dict(occ_words=np.asarray(sd.occ_words), voxels=np.asarray(sd.voxels),
             mat_params=np.asarray(sd.mat_params), tables=_np(sd.tables),
             sky=_np(sd.sky)), _np(p), "cpu")
    tcfg = TCfg(**{f.name: getattr(cfg, f.name)
                   for f in dataclasses.fields(cfg)})
    return cfg, sd, p, tcfg, tsd, tp


def _pack(v):
    return np.stack([np.asarray(c) for c in v], -1)


def test_trace_sample_per_pixel(both):
    cfg, sd, p, tcfg, tsd, tp = both
    key = jax.random.PRNGKey(3)
    u, v = jpl._pixel_grid(*cfg.image_res)
    jo = jax.jit(jpt.trace_sample, static_argnums=(0, 6, 7))(
        cfg, sd, p, key, u, v, False, 1.0)
    tc1 = dataclasses.replace(tcfg, samples_per_launch=1)
    tu, tv, _ = tpl.wavefront_constants(tc1, 1.0, "cpu")
    np.testing.assert_array_equal(tu.numpy(), np.asarray(u))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(v))
    skeys, jit = tpl.sample_keys_of(prng.key(3), 1)
    to = tpt.trace_sample(tcfg, tsd, tp, tu, tv, skeys[0],
                          (jit[0][0], jit[0][1]))
    n = tu.shape[0]
    for name in ("diffuse", "specular"):
        a, b = _pack(jo[name]), torch.stack(list(to[name]), -1).numpy()
        ok = np.isclose(b, a, rtol=1e-4, atol=1e-6).all(-1)
        assert ok.mean() >= 0.99, (name, ok.mean())
        assert np.sqrt(np.mean((a - b) ** 2)) < 1e-4 * max(1.0, np.abs(a).max())
    assert (np.asarray(jo["inside"]) == to["inside"].numpy()).all()
    np.testing.assert_array_equal(
        to["gbuff_mat_id"].numpy(),
        np.asarray(jo["gbuff_mat_id"]).astype(np.int64))
    for a, b in zip(jo["gbuff_normals"], to["gbuff_normals"]):
        assert (np.asarray(a) == b.numpy()).mean() >= 0.99
    np.testing.assert_allclose(to["gbuff_depth"].numpy(),
                               np.asarray(jo["gbuff_depth"]), rtol=1e-5,
                               atol=1e-6)
    # the reflection depth is a linearized depth of a point up to 1e4 away:
    # relative error 1e-2 near the far plane
    np.testing.assert_allclose(to["gbuff_depth_reflection"].numpy(),
                               np.asarray(jo["gbuff_depth_reflection"]),
                               rtol=2e-2, atol=1e-4)
    assert n == cfg.image_res[0] * cfg.image_res[1]


@pytest.mark.parametrize("spl,launches", [(1, 2), (4, 2)])
def test_accumulate_n_image(both, spl, launches):
    cfg, sd, p, tcfg, tsd, tp = both
    jc = dataclasses.replace(cfg, samples_per_launch=spl)
    tc = dataclasses.replace(tcfg, samples_per_launch=spl)
    st = jpl.accumulate_n(jc, sd, p, jpl.init_state(jc), jax.random.PRNGKey(5),
                          False, 1.0, spl * launches)
    jimg = np.asarray(jpl.fetch_image(jc, st, jnp.float32(2.0), 1.0))
    ts = tpl.accumulate_n(tc, tsd, tp, tpl.init_state(tc, "cpu"),
                          prng.key(5), False, 1.0, spl * launches)
    timg = tpl.fetch_image(tc, ts, 2.0).numpy()
    assert ts.spp == spl * launches and ts.frame == launches
    assert timg.shape == jimg.shape and np.isfinite(timg).all()
    assert timg.std() > 0.05
    rmse = float(np.sqrt(np.mean((timg - jimg) ** 2)))
    assert rmse < 1e-4, rmse
    np.testing.assert_allclose(ts.history.numpy()[..., 3],
                               np.asarray(st.history)[..., 3])
