"""PyTorch port, ReSTIR-PT through the pipeline: ``accumulate_n`` with the
spatial GRIS pass against the JAX package, still and on moving frames,
under ``app/testing.production_test_config`` (Pallas kernels in interpret
mode, physical sky + clouds, a sun).

Bars. The tonemapped images to an RMSE of 1e-4, the bar of the port's
other ``accumulate_n`` tests (tests/test_torch_render.py); the stored
output reservoirs on at least 99% of pixels within 1e-4 relative (a weighted
selection flips where a last-bit difference moves a product across its
uniform).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelrt.render import pipeline as jpl

from voxelrt_torch.ops import prng
from voxelrt_torch.render import pipeline as tpl

from test_torch_render import build_both
from test_torch_temporal import _moved, _port_params

# One thread per test process: the suite runs several processes side by
# side, and the tensors here are small.
torch.set_num_threads(1)

RESTIR = dict(use_restir_pt=True, restir_taps=8, restir_radius=6.0)


@pytest.fixture(scope="module")
def both():
    cfg, sd, p, tcfg, tsd, tp = build_both()
    return (dataclasses.replace(cfg, **RESTIR), sd, p,
            dataclasses.replace(tcfg, **RESTIR), tsd, tp)


def _rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


def _reservoirs_close(js, ts):
    w, h = ts.color.shape[:2]
    for jslot, tslot in zip(js.reservoirs, ts.reservoirs):
        for k, a in jslot.items():
            a = np.asarray(a, np.float64).reshape(w * h, -1)
            b = tslot[k].numpy().astype(np.float64).reshape(w * h, -1)
            share = np.isclose(b, a, rtol=1e-4, atol=1e-6).all(-1).mean()
            assert share >= 0.99, (k, share)


def test_restir_accumulate_n_still(both):
    cfg, sd, p, tcfg, tsd, tp = both
    js = jpl.accumulate_n(cfg, sd, p, jpl.init_state(cfg),
                          jax.random.PRNGKey(5), False, 1.0, 2)
    jimg = np.asarray(jpl.fetch_image(cfg, js, jnp.float32(2.0), 1.0))
    ts = tpl.accumulate_n(tcfg, tsd, tp, tpl.init_state(tcfg, "cpu"),
                          prng.key(5), False, 1.0, 2)
    timg = tpl.fetch_image(tcfg, ts, 2.0).numpy()
    assert ts.spp == 2 and ts.frame == 2 and len(ts.reservoirs) == 2
    assert np.isfinite(timg).all() and timg.std() > 0.05
    rmse = _rmse(timg, jimg)
    print(f"ReSTIR still image RMSE against JAX: {rmse:.3e}")
    assert rmse < 1e-4, rmse
    _reservoirs_close(js, ts)
    # GRIS changed the image: the plain path's differs
    plain = tpl.accumulate_n(dataclasses.replace(tcfg, use_restir_pt=False),
                             tsd, tp, tpl.init_state(tcfg, "cpu"),
                             prng.key(5), False, 1.0, 2)
    assert _rmse(tpl.fetch_image(tcfg, plain, 2.0).numpy(), timg) > 1e-3


def test_restir_accumulate_n_moving(both):
    """Two moving frames at render scale 0.5: the second reprojects the
    first's history; GRIS demodulates the diffuse by the albedo."""
    cfg, sd, p0, tcfg, tsd, tp0 = both
    p1 = _moved(cfg, p0, (0.43, 0.52, 1.96), (0.01, 0.0, 0.0))
    p2 = _moved(cfg, p1, (0.46, 0.54, 1.92), (0.02, 0.0, 0.0))
    js = jpl.init_state(cfg)
    ts = tpl.init_state(tcfg, "cpu")
    for i, pp in enumerate((p1, p2)):
        js = jpl.accumulate_n(cfg, sd, pp, js, jax.random.PRNGKey(6 + i),
                              True, 0.5, 1)
        ts = tpl.accumulate_n(tcfg, tsd, _port_params(pp, tp0), ts,
                              prng.key(6 + i), True, 0.5, 1)
    jimg = np.asarray(jpl.fetch_image(cfg, js, jnp.float32(2.0), 0.5))
    timg = tpl.fetch_image(tcfg, ts, 2.0, 0.5).numpy()
    assert np.isfinite(timg).all() and timg.std() > 0.05
    rmse = _rmse(timg, jimg)
    print(f"ReSTIR moving image RMSE against JAX: {rmse:.3e}")
    assert rmse < 1e-4, rmse
    _reservoirs_close(js, ts)
